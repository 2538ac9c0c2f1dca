"""Kubernetes Event recording + the Notebook re-emission helpers.

The port's copy of ``kubeflow_tpu/cluster/events.py``. The reference
controllers surface workload failures on the CR by re-emitting
StatefulSet/Pod events as Notebook events (notebook_controller.go:99-126)
and by recording first-party events. ``EventRecorder`` writes ``Event``
objects to the store with the aggregation semantics the k8s event
machinery gives Eventf: repeated identical events bump
``count``/``lastTimestamp`` instead of piling up new objects. Event names
are ``<involved>.<hash of (uid, type, reason, message)>``, the
reference's rule, so the same events carry the same names in both
packages. A plain ``threading.Lock`` stands in for the reference's
tracked lock.
"""

from __future__ import annotations

import calendar
import hashlib
import threading
import time
from typing import Callable

from ..utils import k8s
from .errors import AlreadyExistsError, ConflictError, NotFoundError

EVENT_KIND = "Event"

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

# the real apiserver expires Events after --event-ttl (1h default); the
# in-process store has no leases, so the recorder prunes on write instead
EVENT_TTL_SECONDS = 3600.0
_PRUNE_INTERVAL_SECONDS = 60.0


def _aggregation_suffix(uid: str, type_: str, reason: str,
                        message: str) -> str:
    """Deterministic name suffix keyed on the aggregation identity — repeated
    identical events hash to the same Event name, so the aggregation lookup is
    a single get instead of a namespace list scan (the k8s event machinery
    similarly keys its aggregator on a hashed tuple)."""
    h = hashlib.sha256(
        "\x00".join((uid, type_, reason, message)).encode()).hexdigest()
    return h[:16]


def _parse_iso(ts: str) -> float | None:
    """RFC3339 seconds ("...:00Z") or MicroTime ("...:00.000000Z", the
    events.k8s.io eventTime shape) → epoch seconds; None if unparseable."""
    if isinstance(ts, str) and "." in ts:
        ts = ts.split(".")[0] + "Z"
    try:
        return calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
    except (ValueError, TypeError):
        return None


class EventRecorder:
    """record.EventRecorder analog: writes ``Event`` objects to the store.

    Event names follow the kubelet convention ``<involved>.<suffix>``; the
    suffix is the aggregation hash (upstream uses the nanosecond clock plus a
    separate aggregator — fusing them keeps lookups O(1) and tests
    deterministic). Expired events are pruned opportunistically on write,
    standing in for the apiserver's --event-ttl lease expiry.
    """

    def __init__(self, client, component: str = "notebook-controller",
                 ttl_seconds: float = EVENT_TTL_SECONDS,
                 clock: Callable[[], float] = time.time):
        self.client = client
        self.component = component
        self.ttl_seconds = ttl_seconds
        # injected wall clock: TTL pruning compares Event timestamps, so
        # tests can age events without sleeping
        self.clock = clock
        self._lock = threading.Lock()
        self._last_prune: dict[str, float] = {}  # namespace → monotonic time

    def eventf(self, involved: dict, type_: str, reason: str,
               message: str) -> dict:
        """Record an event on ``involved``; aggregates with an existing event
        carrying the same (involvedObject.uid, type, reason, message)."""
        namespace = k8s.namespace(involved) or "default"
        ref = {
            "kind": k8s.kind(involved),
            "namespace": namespace,
            "name": k8s.name(involved),
            "uid": k8s.uid(involved),
            "apiVersion": k8s.get_in(involved, "apiVersion", default=""),
        }
        now = k8s.now_iso()
        suffix = _aggregation_suffix(ref["uid"], type_, reason, message)
        event_name = f"{ref['name']}.{suffix}"
        self._maybe_prune(namespace)
        # CREATE-first: a fresh event (the fan-out common case — every bind
        # or repair transition emits one) costs ONE wire round trip; only
        # an aggregation (AlreadyExists) pays the read-modify-update. The
        # write races under concurrent reconcile workers keep the same
        # convergence: a lost create falls into the update branch and a
        # conflicting update re-reads — bounded retries, never an
        # exception for an aggregation race.
        existing = None
        first_attempt = True
        for _attempt in range(3):
            existing = None if first_attempt else \
                self.client.get_or_none(EVENT_KIND, namespace, event_name)
            first_attempt = False
            if existing is not None:
                existing = k8s.deepcopy(existing)
                existing["count"] = int(existing.get("count", 1)) + 1
                existing["lastTimestamp"] = now
                try:
                    return self.client.update(existing)
                except (ConflictError, NotFoundError):
                    continue  # concurrent bump or prune; re-read
            event = {
                "apiVersion": "v1",
                "kind": EVENT_KIND,
                "metadata": {
                    "name": event_name,
                    "namespace": namespace,
                },
                "involvedObject": ref,
                "type": type_,
                "reason": reason,
                "message": message,
                "count": 1,
                "firstTimestamp": now,
                "lastTimestamp": now,
                "source": {"component": self.component},
            }
            try:
                return self.client.create(event)
            except AlreadyExistsError:
                continue  # lost the create race; aggregate onto the winner
        # kept racing; events are best-effort telemetry — surface the last
        # observed aggregate rather than raising into the reconcile loop
        return existing or {}

    def _maybe_prune(self, namespace: str) -> None:
        """Delete events whose lastTimestamp is past the TTL. Amortized: at
        most one namespace scan per _PRUNE_INTERVAL_SECONDS, so steady-state
        eventf stays O(1)."""
        now_mono = time.monotonic()
        with self._lock:
            last = self._last_prune.get(namespace, 0.0)
            if now_mono - last < _PRUNE_INTERVAL_SECONDS:
                return
            self._last_prune[namespace] = now_mono
        cutoff = self.clock() - self.ttl_seconds
        for ev in self.client.list(EVENT_KIND, namespace):
            # externally-created Events may carry only eventTime (events.k8s.io
            # shape) or none of the timestamps; never prune what we can't date
            stamp = (_parse_iso(ev.get("lastTimestamp", ""))
                     or _parse_iso(ev.get("firstTimestamp", ""))
                     or _parse_iso(ev.get("eventTime", "")))
            if stamp is not None and stamp < cutoff:
                try:
                    self.client.delete(EVENT_KIND, namespace, k8s.name(ev))
                except Exception:  # noqa: BLE001 — racing deletes are fine
                    pass


def is_sts_or_pod_event(event: dict) -> bool:
    """Reference isStsOrPodEvent (notebook_controller.go:700-702)."""
    kind = k8s.get_in(event, "involvedObject", "kind")
    return kind in ("Pod", "StatefulSet")


def nb_name_from_involved_object(client, event: dict,
                                 notebook_name_label: str) -> str | None:
    """Reference nbNameFromInvolvedObject (notebook_controller.go:704-731),
    hardened two ways:

    - STS events resolve through the STS's notebook-name label (the reference
      returns the STS name directly, which loses events for notebooks whose
      STS fell back to GenerateName "nb-" and misattributes events from
      foreign STSs that happen to share a notebook's name). The raw STS name
      is used only when the STS itself is already gone.
    - Pod events fall back to the pod's owning STS (pods are named
      ``<sts>-<ordinal>``) when the pod is already deleted — terminal events
      (OOMKilled, Evicted, Killing) usually outlive their pod.
    """
    involved = event.get("involvedObject", {})
    kind = involved.get("kind")
    name = involved.get("name")
    namespace = involved.get("namespace") or k8s.namespace(event)
    if kind == "StatefulSet":
        sts = client.get_or_none("StatefulSet", namespace, name)
        if sts is None:
            return name  # deleted STS: assume reference naming (STS = CR name)
        return k8s.get_label(sts, notebook_name_label)
    if kind == "Pod":
        pod = client.get_or_none("Pod", namespace, name)
        if pod is not None:
            return k8s.get_label(pod, notebook_name_label)
        sts_name, dash, ordinal = (name or "").rpartition("-")
        if dash and ordinal.isdigit():
            sts = client.get_or_none("StatefulSet", namespace, sts_name)
            if sts is not None:
                return k8s.get_label(sts, notebook_name_label)
        return None
    return None
