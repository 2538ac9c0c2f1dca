"""The port's controller manager held against the reference's: every case
of tests/test_manager.py runs on both managers with a recording
reconciler, each with the case's own assertions, and both must reconcile
the same keys in the same order, coalesce and dedup the same way and
retry as often. The timed cases keep their deadlines far apart (tens of
milliseconds and up) so a loaded host cannot reorder them; the one case
that calls ``start()`` stops in a ``finally`` and waits at most 2 s.
"""

from __future__ import annotations

import time

import pytest

from kubeflow_tpu.cluster.store import ClusterStore as RefStore
from kubeflow_tpu.controllers.manager import Manager as RefManager
from kubeflow_tpu.controllers.manager import Request as RefRequest
from kubeflow_tpu.controllers.manager import Result as RefResult
from kubeflow_tpu.utils.metrics import MetricsRegistry as RefMetrics
from kubeflow_tpu_torch.cluster.store import ClusterStore
from kubeflow_tpu_torch.controllers import Manager, Request, Result
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry


# families the port leaves out: none (the exposition is compared family
# for family)
LEFT_OUT: tuple[str, ...] = ()


class RecordingReconciler:
    """Records every key it reconciles; fails its first ``fail_times``
    calls and returns ``result``."""

    def __init__(self, name="counter", result=None, fail_times=0):
        self.name = name
        self.keys: list[tuple[str, str]] = []
        self.result = result
        self.fail_times = fail_times

    @property
    def count(self) -> int:
        return len(self.keys)

    def reconcile(self, req):
        self.keys.append((req.namespace, req.name))
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("boom")
        return self.result


class NullClient:
    def watch(self, *a, **k):
        pass


class Side:
    def __init__(self, side: str, client=None):
        ref = side == "ref"
        self.Request = RefRequest if ref else Request
        self.Result = RefResult if ref else Result
        self.Metrics = RefMetrics if ref else MetricsRegistry
        if client == "store":
            client = RefStore() if ref else ClusterStore()
        self.manager = (RefManager if ref else Manager)(client or NullClient())
        self.runs: list[int] = []

    def run(self, **kw) -> int:
        n = self.manager.run_until_idle(**kw)
        self.runs.append(n)
        return n


def both(client=None):
    return Side("ref", client), Side("port", client)


def test_immediate_enqueues_coalesce():
    sides = both()
    recs = []
    for s in sides:
        rec = RecordingReconciler()
        s.manager.register(rec)
        req = s.Request("ns", "x")
        for _ in range(10):
            s.manager.enqueue("counter", req)
        s.run()
        assert rec.count == 1
        recs.append(rec)
    assert recs[1].keys == recs[0].keys
    assert sides[1].runs == sides[0].runs


def test_timed_requeues_dedup_per_key():
    """A reconciler that always self-requeues does not multiply its
    periodic chain when extra watch events arrive (AddAfter dedup): five
    events then three periods give 5 + 3 reconciles on both sides."""
    period = 0.2
    sides = both()
    recs = [RecordingReconciler(result=s.Result(requeue_after=period))
            for s in sides]
    for s, rec in zip(sides, recs):
        s.manager.register(rec)
        req = s.Request("ns", "x")
        for _ in range(5):
            s.manager.enqueue("counter", req)
            s.run()
    for _ in range(3):
        time.sleep(period * 1.25)
        for s in sides:
            s.run(include_delayed_under=0.0)
    for rec in recs:
        assert rec.count == 8 and rec.count <= 20
    assert recs[1].keys == recs[0].keys
    assert sides[1].runs == sides[0].runs == [1] * 8


def test_earlier_timed_requeue_supersedes_later():
    sides = both()
    recs = [RecordingReconciler() for _ in sides]
    for s, rec in zip(sides, recs):
        s.manager.register(rec)
        req = s.Request("ns", "x")
        s.manager.enqueue("counter", req, after=0.05)
        s.manager.enqueue("counter", req, after=0.01)  # earlier wins
        s.manager.enqueue("counter", req, after=0.03)  # later than pending
    time.sleep(0.06)
    for s, rec in zip(sides, recs):
        s.run()
        assert rec.count == 1
    assert sides[1].runs == sides[0].runs


def test_error_backoff_retries():
    sides = both()
    recs = [RecordingReconciler(fail_times=3) for _ in sides]
    registries = []
    for s, rec in zip(sides, recs):
        registry = s.Metrics()
        s.manager.attach_metrics(registry)
        registries.append(registry)
        s.manager.register(rec)
        s.manager.enqueue("counter", s.Request("ns", "x"))
        deadline = time.monotonic() + 2.0
        while rec.count < 4 and time.monotonic() < deadline:
            s.run(include_delayed_under=0.2)
            time.sleep(0.005)
        assert rec.count == 4   # 3 failures + 1 success
    assert recs[1].keys == recs[0].keys
    retries = [r.counter("workqueue_retries_total", "").get(
        {"name": "counter"}) for r in registries]
    results = [{res: r.counter("controller_runtime_reconcile_total", "").get(
        {"controller": "counter", "result": res})
        for res in ("error", "success")} for r in registries]
    assert retries[1] == retries[0] == 3
    assert results[1] == results[0] == {"error": 3, "success": 1}


def test_background_thread_mode():
    sides = both()
    recs = [RecordingReconciler() for _ in sides]
    for s, rec in zip(sides, recs):
        s.manager.register(rec)
        s.manager.start()
        try:
            s.manager.enqueue("counter", s.Request("ns", "a"))
            s.manager.enqueue("counter", s.Request("ns", "b"))
            deadline = time.monotonic() + 2.0
            while rec.count < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert rec.count == 2
            assert s.manager.is_alive()
        finally:
            s.manager.stop()
        assert not s.manager.is_alive()
    # two workers may take the keys in either order
    assert sorted(recs[1].keys) == sorted(recs[0].keys)


def test_reconcile_and_workqueue_metrics():
    exposed = []
    for s in both("store"):
        registry = s.Metrics()
        s.manager.attach_metrics(registry)

        class Flaky:
            name = "flaky"
            calls = 0

            def reconcile(self, req):
                Flaky.calls += 1
                if Flaky.calls == 1:
                    raise RuntimeError("boom")
                return None

        s.manager.register(Flaky())
        s.manager.enqueue("flaky", s.Request("ns", "a"))
        s.run(include_delayed_under=5.0)
        metric = registry.counter("controller_runtime_reconcile_total", "")
        assert metric.get({"controller": "flaky", "result": "error"}) == 1
        assert metric.get({"controller": "flaky", "result": "success"}) == 1
        exposition = registry.expose()
        assert "controller_runtime_reconcile_total" in exposition
        assert "workqueue_depth" in exposition
        exposed.append({line for line in exposition.splitlines()
                        if line.startswith(("controller_runtime_",
                                            "workqueue_adds", "workqueue_retries",
                                            "workqueue_depth", "# TYPE",
                                            "reconcile_read_seconds_count",
                                            "reconcile_write_seconds_count",
                                            "notebook_culling_total"))
                        and not any(f in line for f in LEFT_OUT)})
    assert exposed[1] == exposed[0]


def test_workqueue_depth_ignores_superseded_ghosts():
    depths = []
    for s in both("store"):
        registry = s.Metrics()
        s.manager.attach_metrics(registry)

        class Idle:
            name = "idle"

            def reconcile(self, req):
                return None

        s.manager.register(Idle())
        req = s.Request("ns", "a")
        s.manager.enqueue("idle", req, after=300.0)   # far-future requeue
        s.manager.enqueue("idle", req, after=100.0)   # supersedes it
        registry.expose()
        depth = registry.gauge("workqueue_depth", "")
        assert depth.get({"name": "idle"}) == 1
        depths.append(depth.get({"name": "idle"}))
    assert depths[1] == depths[0]


@pytest.mark.parametrize("cap", [1, 2])
def test_per_controller_cap_and_dirty_requeue(cap):
    """Beyond the cases: a key enqueued while its reconcile runs is
    re-run exactly once after it (dirty), and keys of two controllers
    interleave in enqueue order under a per-controller cap."""
    orders = []
    for s in both():
        order = []

        class Echo:
            def __init__(self, name, mgr, req):
                self.name, self.mgr, self.req = name, mgr, req
                self.runs = 0

            def reconcile(self, req):
                order.append((self.name, req.name))
                self.runs += 1
                if self.runs == 1:
                    # an event for this very key lands mid-reconcile
                    self.mgr.enqueue(self.name, req)
                return None

        a = Echo("a", s.manager, s.Request("ns", "k"))
        b = Echo("b", s.manager, s.Request("ns", "k"))
        s.manager.register(a, max_concurrent_reconciles=cap)
        s.manager.register(b, max_concurrent_reconciles=cap)
        for name in ("a", "b", "a"):
            s.manager.enqueue(name, s.Request("ns", "k"))
        for name in ("b", "a"):
            s.manager.enqueue(name, s.Request("ns", "j"))
        s.run()
        assert a.runs == 3 and b.runs == 3
        orders.append(order)
    assert orders[1] == orders[0]
