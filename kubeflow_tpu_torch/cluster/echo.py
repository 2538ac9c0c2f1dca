"""Self-write echo suppression for reconciler watch streams.

The port's copy of ``kubeflow_tpu/cluster/echo.py``. Every write a
reconciler makes comes back to it as a watch event. For a level-triggered
controller that event carries no information (the reconcile that made the
write already acted on the freshest state) but costs a full re-reconcile;
with several workers the queue stays shallow and every echo becomes its
own reconcile.

``EchoTrackingClient`` wraps a reconciler's client, records the
resourceVersion of every object its writes produce, and exposes an
``is_echo(event)`` predicate for the manager watches: an event whose
object carries exactly a recorded (kind, ns, name) → rv is the author's
own write coming back and is dropped. The same-rv match makes this safe:

- a foreign write bumps rv past the recorded value → never suppressed;
- our write racing a foreign one: whichever landed later has a different
  rv → the foreign state is always delivered;
- DELETED events are never suppressed;
- a missed recording (the in-process store delivers watch callbacks
  inline, before the write call returns) fails open: the echo is
  delivered and merely costs the re-reconcile.

A reconciler must therefore not rely on its own write's echo to trigger
itself again: it returns ``Result(requeue_after=0)`` for an immediate
requeue.

Every verb is also attributed to the reconcile phase collector
(``utils.metrics.phase_record``): this wrapper is the one layer every
reconciler's client chain passes through exactly once, so the manager's
``reconcile_read_seconds`` / ``reconcile_write_seconds`` are measured
here. A plain ``threading.Lock`` stands in for the reference's tracked
lock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..utils import k8s
from ..utils.metrics import phase_record
from .cache import owned_objects


class EchoTrackingClient:
    """Transparent client wrapper: writes record their resulting
    resourceVersion; everything else passes through. Thread-safe."""

    #: rvs remembered per object (one reconcile can write the same object
    #: more than once, and each echo arrives separately)
    RVS_PER_KEY = 4
    #: objects tracked before the oldest recording is evicted
    CAPACITY = 8192
    #: kinds no ``not_echo`` predicate consults: recording the recorder's
    #: Event writes would only evict live Notebook/STS/Service records
    NEVER_TRACK = frozenset(("Event",))

    def __init__(self, client):
        self._client = client
        self._lock = threading.Lock()
        # (kind, namespace, name) → recent rv strings (newest last)
        self._written: OrderedDict[tuple[str, str, str], list[str]] = \
            OrderedDict()

    # ------------------------------------------------------------ recording
    def _record(self, obj):
        if isinstance(obj, dict) and obj.get("kind") not in self.NEVER_TRACK:
            rv = k8s.get_in(obj, "metadata", "resourceVersion")
            if rv is not None:
                key = (k8s.kind(obj), k8s.namespace(obj), k8s.name(obj))
                with self._lock:
                    rvs = self._written.setdefault(key, [])
                    rvs.append(str(rv))
                    del rvs[:-self.RVS_PER_KEY]
                    self._written.move_to_end(key)
                    while len(self._written) > self.CAPACITY:
                        self._written.popitem(last=False)
        return obj

    def is_echo(self, event) -> bool:
        """True iff ``event`` is the delivery of one of our writes."""
        if event.type == "DELETED":
            return False
        obj = event.obj
        rv = k8s.get_in(obj, "metadata", "resourceVersion")
        if rv is None:
            return False
        key = (k8s.kind(obj), k8s.namespace(obj), k8s.name(obj))
        with self._lock:
            return str(rv) in self._written.get(key, ())

    def not_echo(self, event) -> bool:
        """Watch-predicate form: pass everything that is not our echo."""
        return not self.is_echo(event)

    # --------------------------------------------------------------- writes
    def create(self, obj):
        t0 = time.monotonic()
        try:
            return self._record(self._client.create(obj))
        finally:
            phase_record("write", time.monotonic() - t0)

    def update(self, obj):
        t0 = time.monotonic()
        try:
            return self._record(self._client.update(obj))
        finally:
            phase_record("write", time.monotonic() - t0)

    def update_status(self, obj):
        t0 = time.monotonic()
        try:
            return self._record(self._client.update_status(obj))
        finally:
            phase_record("write", time.monotonic() - t0)

    def patch(self, kind, namespace, name, patch):
        t0 = time.monotonic()
        try:
            return self._record(self._client.patch(kind, namespace, name,
                                                   patch))
        finally:
            phase_record("write", time.monotonic() - t0)

    def delete(self, kind, namespace, name):
        t0 = time.monotonic()
        try:
            return self._client.delete(kind, namespace, name)
        finally:
            phase_record("write", time.monotonic() - t0)

    # ---------------------------------------------------------------- reads
    def get(self, kind, namespace, name):
        t0 = time.monotonic()
        try:
            return self._client.get(kind, namespace, name)
        finally:
            phase_record("read", time.monotonic() - t0)

    def get_or_none(self, kind, namespace, name):
        t0 = time.monotonic()
        try:
            return self._client.get_or_none(kind, namespace, name)
        finally:
            phase_record("read", time.monotonic() - t0)

    def list(self, kind, namespace=None, label_selector=None):
        t0 = time.monotonic()
        try:
            return self._client.list(kind, namespace, label_selector)
        finally:
            phase_record("read", time.monotonic() - t0)

    def get_owned(self, kind, owner):
        t0 = time.monotonic()
        try:
            return owned_objects(self._client, kind, owner)
        finally:
            phase_record("read", time.monotonic() - t0)

    # -------------------------------------------------------- passthrough
    def __getattr__(self, name):
        return getattr(self._client, name)
