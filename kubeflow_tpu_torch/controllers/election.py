"""Leader election over a coordination Lease.

The port's copy of ``kubeflow_tpu/controllers/election.py``. The
reference's managers enable controller-runtime leader election by flag
(notebook-controller/main.go:87-94, ``--leader-elect``) so only one
replica of each controller binary reconciles at a time: a Lease object
in the controller namespace, renewed on a timer; a candidate acquires the
lease when it is unheld or its holder's renew time is stale.

The same protocol against the store's optimistic-concurrency Lease
objects, through whatever client the manager was given (the in-process
store or the port's ``HttpApiClient``): acquire → renew every
``renew_period`` → another candidate takes over only after
``lease_duration`` without renewal. A conflict on update means someone
else won the race: back off and retry. The Manager consults
``is_leader()`` before it dispatches; ``stop()`` releases the lease, so a
standby adopts at its next round instead of waiting out the duration.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Callable

from ..cluster.errors import (AlreadyExistsError, ConflictError,
                              NotFoundError)

log = logging.getLogger("kubeflow_tpu_torch.election")

LEASE_KIND = "Lease"


class LeaderElector:
    def __init__(self, client, namespace: str, lease_name: str,
                 identity: str | None = None,
                 lease_duration: float = 15.0,
                 renew_period: float = 2.0,
                 on_started_leading: Callable[[], None] | None = None,
                 on_stopped_leading: Callable[[], None] | None = None) -> None:
        self.client = client
        self.namespace = namespace
        self.lease_name = lease_name
        self.identity = identity or f"mgr-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- protocol
    def is_leader(self) -> bool:
        with self._lock:
            return self._leading

    def _lease_obj(self) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": LEASE_KIND,
            "metadata": {"name": self.lease_name,
                         "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": self.lease_duration,
                "renewTime": time.time(),
            },
        }

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether we hold the lease after it."""
        try:
            lease = self.client.get_or_none(LEASE_KIND, self.namespace,
                                            self.lease_name)
            if lease is None:
                self.client.create(self._lease_obj())
                return True
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity")
            renew = float(spec.get("renewTime", 0.0))
            duration = float(spec.get("leaseDurationSeconds",
                                      self.lease_duration))
            if holder != self.identity and time.time() - renew < duration:
                return False  # held by a live peer
            spec.update(holderIdentity=self.identity,
                        renewTime=time.time(),
                        leaseDurationSeconds=self.lease_duration)
            lease["spec"] = spec
            self.client.update(lease)
            return True
        except (ConflictError, AlreadyExistsError):
            return False  # lost the race this round
        except NotFoundError:
            return False

    def _set_leading(self, leading: bool) -> None:
        with self._lock:
            was = self._leading
            self._leading = leading
        if leading and not was:
            log.info("became leader for %s/%s as %s", self.namespace,
                     self.lease_name, self.identity)
            if self.on_started_leading:
                self.on_started_leading()
        elif was and not leading:
            log.warning("lost leadership for %s/%s", self.namespace,
                        self.lease_name)
            if self.on_stopped_leading:
                self.on_stopped_leading()

    # -------------------------------------------------------------- driving
    def run_once(self) -> bool:
        leading = self.try_acquire_or_renew()
        self._set_leading(leading)
        return leading

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="leader-elector")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — a round that dies
                # must demote: leading with no renew thread is split-brain
                # once a standby takes the lease
                log.warning("election round failed: %s; demoting", exc)
                self._set_leading(False)
            self._stop.wait(self.renew_period)

    def release(self) -> None:
        """Drop the lease (controller-runtime's
        LeaderElectionReleaseOnCancel) so a standby takes over at once
        instead of waiting out ``lease_duration``."""
        if not self.is_leader():
            return
        try:
            lease = self.client.get_or_none(LEASE_KIND, self.namespace,
                                            self.lease_name)
            if lease and lease.get("spec", {}).get("holderIdentity") == \
                    self.identity:
                lease["spec"]["renewTime"] = 0.0
                lease["spec"]["holderIdentity"] = ""
                self.client.update(lease)
        except (ConflictError, NotFoundError):
            pass
        self._set_leading(False)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.release()
