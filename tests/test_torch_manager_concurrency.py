"""The port's Manager dispatch held against the reference's, case for
case.

Eight cases of tests/test_manager_concurrency.py run on each side's
Manager, Request, Result and MetricsRegistry with the same reconcilers:
per-key serialisation with one dirty re-run, no same-key overlap under
load, AddAfter coalescing under four workers, the per-controller cap,
``run_until_idle`` waiting for in-flight workers, the workqueue metric
family, unfinished work of in-flight items and a pool of one. Each side
makes the case's own assertions, and what the case observes that the
threads' timing does not decide (the calls of each key, the counters,
the series exposed) must be equal. The two lease cases run the
reference's own bodies on each side's Manager
(``torch_wire.binaries_case``): the in-flight item finishes while the
queue parks, and an item popped after the lease moved goes back
untouched. Not here: the ``slow`` stress case, which is outside tier-1.

Every ``start()`` stops in a ``finally``.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

import test_manager_concurrency as ref_concurrency
from kubeflow_tpu.controllers import manager as ref_manager
from kubeflow_tpu.utils.metrics import MetricsRegistry as RefMetrics
from kubeflow_tpu_torch.controllers import manager
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from torch_wire import SIDES as WIRE_SIDES
from torch_wire import binaries_case

SIDES = {
    "ref": SimpleNamespace(Manager=ref_manager.Manager,
                           Request=ref_manager.Request,
                           Result=ref_manager.Result, Metrics=RefMetrics),
    "port": SimpleNamespace(Manager=manager.Manager,
                            Request=manager.Request,
                            Result=manager.Result, Metrics=MetricsRegistry),
}


class NullClient:
    def watch(self, *a, **k):
        pass


class TrackingReconciler:
    """Records per-key start stamps and flags same-key overlap."""
    name = "tracking"

    def __init__(self, work_s=0.0, result=None):
        self.work_s = work_s
        self.result = result
        self.lock = threading.Lock()
        self.inflight: set = set()
        self.overlaps: list = []
        self.starts: dict = {}
        self.max_parallel = 0

    def reconcile(self, req):
        with self.lock:
            if req in self.inflight:
                self.overlaps.append(req)
            self.inflight.add(req)
            self.starts.setdefault(req, []).append(time.monotonic())
            self.max_parallel = max(self.max_parallel, len(self.inflight))
        if self.work_s:
            time.sleep(self.work_s)
        with self.lock:
            self.inflight.discard(req)
        return self.result

    def count(self, req):
        with self.lock:
            return len(self.starts.get(req, []))


class GateReconciler:
    """Blocks inside reconcile until released; counts entries."""
    name = "gated"

    def __init__(self):
        self.entered = threading.Semaphore(0)
        self.release = threading.Event()
        self.lock = threading.Lock()
        self.calls: list = []

    def reconcile(self, req):
        with self.lock:
            self.calls.append(req)
        self.entered.release()
        assert self.release.wait(10), "gate never released"
        return None


def per_key_serialization_and_single_dirty_rerun(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=4)
    rec = GateReconciler()
    mgr.register(rec)
    mgr.start()
    try:
        a, b = m.Request("ns", "a"), m.Request("ns", "b")
        mgr.enqueue("gated", a)
        assert rec.entered.acquire(timeout=5)   # a is in flight
        for _ in range(3):                      # dirty: ONE re-run
            mgr.enqueue("gated", a)
        mgr.enqueue("gated", b)                 # b runs beside a
        assert rec.entered.acquire(timeout=5)
        with rec.lock:
            assert rec.calls == [a, b]
        rec.release.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with rec.lock:
                if rec.calls.count(a) == 2:
                    break
            time.sleep(0.005)
        mgr.run_until_idle(timeout=5)
        with rec.lock:
            assert rec.calls.count(a) == 2, rec.calls
            assert rec.calls.count(b) == 1, rec.calls
            return [r.name for r in rec.calls]
    finally:
        rec.release.set()
        mgr.stop()


def no_same_key_overlap_under_load(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=4)
    rec = TrackingReconciler(work_s=0.005)
    mgr.register(rec)
    mgr.start()
    try:
        reqs = [m.Request("ns", f"k{i}") for i in range(8)]
        for _ in range(5):
            for r in reqs:
                mgr.enqueue("tracking", r)
            time.sleep(0.003)
        mgr.run_until_idle(timeout=10)
        assert rec.overlaps == []
        assert rec.max_parallel >= 2
        return sorted(r.name for r in rec.starts)
    finally:
        mgr.stop()


def addafter_coalesces_with_workers(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=4)
    rec = TrackingReconciler(result=m.Result(requeue_after=0.01))
    mgr.register(rec)
    mgr.start()
    try:
        req = m.Request("ns", "x")
        for _ in range(5):
            mgr.enqueue("tracking", req)
            time.sleep(0.005)
        time.sleep(0.1)
    finally:
        mgr.stop()
    assert rec.count(req) <= 25, rec.count(req)
    assert rec.overlaps == []
    return rec.overlaps


def per_controller_cap_limits_parallelism(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=4)
    rec = TrackingReconciler(work_s=0.02)
    mgr.register(rec, max_concurrent_reconciles=1)
    mgr.start()
    try:
        for i in range(6):
            mgr.enqueue("tracking", m.Request("ns", f"k{i}"))
        mgr.run_until_idle(timeout=10)
        assert rec.max_parallel == 1
        return rec.max_parallel
    finally:
        mgr.stop()


def run_until_idle_waits_for_inflight_workers(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=2)
    rec = TrackingReconciler(work_s=0.15)
    mgr.register(rec)
    mgr.start()
    try:
        mgr.enqueue("tracking", m.Request("ns", "a"))
        deadline = time.monotonic() + 2
        while not rec.starts and time.monotonic() < deadline:
            time.sleep(0.002)
        assert rec.starts
        mgr.run_until_idle(timeout=5)
        with rec.lock:
            assert not rec.inflight
        assert rec.count(m.Request("ns", "a")) == 1
        return rec.count(m.Request("ns", "a"))
    finally:
        mgr.stop()


def workqueue_metric_family_exposed(m):
    registry = m.Metrics()
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=2)
    mgr.attach_metrics(registry)

    class Flaky:
        name = "flaky"
        calls = 0

        def reconcile(self, req):
            Flaky.calls += 1
            if Flaky.calls == 1:
                raise RuntimeError("boom")
            return None

    mgr.register(Flaky())
    mgr.enqueue("flaky", m.Request("ns", "a"))
    mgr.run_until_idle(timeout=5, include_delayed_under=5.0)
    exposition = registry.expose()
    series = ("workqueue_adds_total", "workqueue_depth",
              "workqueue_queue_duration_seconds",
              "workqueue_work_duration_seconds", "workqueue_retries_total",
              "workqueue_unfinished_work_seconds",
              "workqueue_longest_running_processor_seconds")
    for name in series:
        assert name in exposition, name
    got = {
        "adds": registry.counter("workqueue_adds_total", "").get(
            {"name": "flaky"}),
        "retries": registry.counter("workqueue_retries_total", "").get(
            {"name": "flaky"}),
        "work": registry.histogram("workqueue_work_duration_seconds",
                                   "").count({"name": "flaky"}),
        "queued": registry.histogram("workqueue_queue_duration_seconds",
                                     "").count({"name": "flaky"}),
        "depth": registry.gauge("workqueue_depth", "").get(
            {"name": "flaky"}),
        "unfinished": registry.gauge("workqueue_unfinished_work_seconds",
                                     "").get({"name": "flaky"}),
        "exposed": sorted({line.split()[2] for line in
                           exposition.splitlines()
                           if line.startswith("# TYPE workqueue_")}),
    }
    assert got["adds"] >= 2          # the first add + the backoff requeue
    assert got["retries"] == 1
    assert got["work"] == 2          # the error run + the success run
    assert got["queued"] == 2
    assert got["depth"] == 0
    assert got["unfinished"] == 0
    return got


def unfinished_work_counts_inflight_items(m):
    registry = m.Metrics()
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=2)
    mgr.attach_metrics(registry)
    rec = GateReconciler()
    mgr.register(rec)
    mgr.start()
    try:
        mgr.enqueue("gated", m.Request("ns", "a"))
        assert rec.entered.acquire(timeout=5)
        time.sleep(0.02)
        registry.expose()
        unfinished = registry.gauge("workqueue_unfinished_work_seconds", "")
        longest = registry.gauge(
            "workqueue_longest_running_processor_seconds", "")
        assert unfinished.get({"name": "gated"}) > 0
        assert longest.get({"name": "gated"}) > 0
        # the in-flight item is not depth
        depth = registry.gauge("workqueue_depth", "").get({"name": "gated"})
        assert depth == 0
        return depth
    finally:
        rec.release.set()
        mgr.stop()


def workers_one_is_serial(m):
    mgr = m.Manager(NullClient(), max_concurrent_reconciles=1)
    rec = TrackingReconciler(work_s=0.01)
    mgr.register(rec)
    mgr.start()
    try:
        for i in range(6):
            mgr.enqueue("tracking", m.Request("ns", f"k{i}"))
        mgr.run_until_idle(timeout=10)
        assert rec.max_parallel == 1
        assert len(mgr._threads) == 1
        return [r.name for r in sorted(rec.starts,
                                       key=lambda r: rec.starts[r][0])]
    finally:
        mgr.stop()


CASES = {fn.__name__: fn for fn in (
    per_key_serialization_and_single_dirty_rerun,
    no_same_key_overlap_under_load, addafter_coalesces_with_workers,
    per_controller_cap_limits_parallelism,
    run_until_idle_waits_for_inflight_workers,
    workqueue_metric_family_exposed, unfinished_work_counts_inflight_items,
    workers_one_is_serial)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_manager_case_on_both_sides(case):
    assert CASES[case](SIDES["port"]) == CASES[case](SIDES["ref"])


# ------------------------------- the lease cases, the reference's bodies
LEASE_CASES = ("test_leader_handoff_quiesces_inflight_work",
               "test_lost_lease_after_pop_returns_item_untouched")


@pytest.mark.parametrize("name", LEASE_CASES)
def test_lease_case_on_both_sides(name):
    """The reference's own body on each side's Manager and Request (its
    FakeElector on ``Manager.leader_elector``); every manager it built
    must end with the same queue: no key queued, timed or in flight."""
    got = {}
    for side, s in WIRE_SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_concurrency, name, s, mp,
                                 keep=("Manager",))
        got[side] = [(sorted(m._queued), sorted(m._timed_pending),
                      sorted(m._processing), sorted(m._dirty))
                     for m in made["Manager"]]
        assert got[side] and all(isinstance(m, s.manager.Manager)
                                 for m in made["Manager"])
    assert got["port"] == got["ref"]
