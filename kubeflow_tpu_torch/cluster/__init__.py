"""The port's in-process apiserver: the sharded store, its API errors,
Events and the StatefulSet/kubelet simulator; and the HTTP apiserver
over the store (``apiserver.py``, with its codec, REST mapper, priority
and fairness and fault plans); the HTTP(S) client the controllers reach
an apiserver with (``http_client.py``), and the store's remote admission
through webhook configurations (``remote_admission.py``)."""

from .errors import (AlreadyExistsError, ApiError, ConflictError,
                     InvalidError, NotFoundError)
from .http_client import HttpApiClient, RetryPolicy
from .remote_admission import AdmissionWebhookError
from .store import ClusterStore, WatchEvent

__all__ = [
    "ApiError", "ConflictError", "NotFoundError", "AlreadyExistsError",
    "InvalidError", "ClusterStore", "WatchEvent", "HttpApiClient",
    "RetryPolicy", "AdmissionWebhookError",
]
