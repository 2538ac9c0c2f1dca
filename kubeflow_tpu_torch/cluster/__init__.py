"""The port's in-process apiserver: the sharded store, its API errors,
Events and the StatefulSet/kubelet simulator; and the HTTP apiserver
over the store (``apiserver.py``, with its codec, REST mapper, priority
and fairness and fault plans)."""

from .errors import (AlreadyExistsError, ApiError, ConflictError,
                     InvalidError, NotFoundError)
from .store import ClusterStore, WatchEvent

__all__ = [
    "ApiError", "ConflictError", "NotFoundError", "AlreadyExistsError",
    "InvalidError", "ClusterStore", "WatchEvent",
]
