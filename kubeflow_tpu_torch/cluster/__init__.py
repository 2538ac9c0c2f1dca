"""The port's in-process apiserver: the store, its API errors, Events and
the StatefulSet/kubelet simulator."""

from .errors import (AlreadyExistsError, ApiError, ConflictError,
                     InvalidError, NotFoundError)
from .store import ClusterStore, WatchEvent

__all__ = [
    "ApiError", "ConflictError", "NotFoundError", "AlreadyExistsError",
    "InvalidError", "ClusterStore", "WatchEvent",
]
