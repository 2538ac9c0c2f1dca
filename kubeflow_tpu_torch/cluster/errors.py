"""API error taxonomy mirroring k8s.io/apimachinery/pkg/api/errors.

A copy of ``kubeflow_tpu/cluster/errors.py`` (the port imports nothing of
the JAX package): the store raises these, and the reconcilers branch on
them as the reference's branch on apierrs.IsNotFound / IsConflict /
IsAlreadyExists (e.g. notebook_controller.go:151-204)."""

from __future__ import annotations


class ApiError(Exception):
    code = 500
    reason = "InternalError"
    #: server-suggested retry delay in seconds (a 429/503 ``Retry-After``
    #: header); None when the server sent none
    retry_after: float | None = None
    #: set by the transport when this error surfaced on a RETRY after an
    #: ambiguous failure (connection reset mid-request): the earlier
    #: attempt may have been applied, so e.g. AlreadyExists on a retried
    #: create is probably our own first write landing
    ambiguous_retry: bool = False

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """Optimistic-concurrency failure (stale resourceVersion) — what
    retry.RetryOnConflict retries on in the reference."""
    code = 409
    reason = "Conflict"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class GoneError(ApiError):
    """410 Gone with reason ``Expired`` — the apiserver's answer when a
    watch asks to resume from a resourceVersion the watch cache has
    already evicted (apimachinery NewResourceExpired). The client's only
    correct move is the full LIST+diff resync; resuming anywhere else
    could silently skip evicted events."""
    code = 410
    reason = "Expired"


class ForbiddenError(ApiError):
    code = 403
    reason = "Forbidden"


class TooManyRequestsError(ApiError):
    """Apiserver priority-and-fairness rejection (429). Always safe to
    retry — the server refused the request *before* processing it — and
    carries the server's ``Retry-After`` pacing when sent."""
    code = 429
    reason = "TooManyRequests"


class ServiceUnavailableError(ApiError):
    """503 from the apiserver or an LB in front of it (overload, rolling
    restart). Retried for idempotent verbs only: unlike a 429 it gives no
    guarantee about whether processing started."""
    code = 503
    reason = "ServiceUnavailable"


def update_with_conflict_retry(client, read, mutate, attempts: int = 3):
    """retry.RetryOnConflict analog for the read→mutate→update shape, the
    conflict-retry loop concurrent reconcile workers need in several
    places (finalizer strips, copy-fields drift repair).

    ``read()`` returns the current object or None (nothing to do — give
    up quietly); pass a LIVE read (cache.live_reader) when retrying a
    conflict, because the foreign write that caused the 409 may not have
    reached the watch-fed cache yet and a cached re-read would resend the
    same stale resourceVersion. ``mutate(obj)`` edits in place and
    returns whether an update is needed. ConflictError retries up to
    ``attempts`` times; a final conflict or a vanished object returns
    None (callers relying on error-backoff should re-raise instead —
    this helper is for benign races the next watch event re-converges)."""
    for _attempt in range(attempts):
        obj = read()
        if obj is None or not mutate(obj):
            return None
        try:
            return client.update(obj)
        except ConflictError:
            continue
        except NotFoundError:
            return None
    return None

