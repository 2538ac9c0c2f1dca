"""The port's idle culler held against the reference's, case for case.

Every case of tests/test_culling.py runs through both stacks
(``torch_parity.Stack``: store, Manager, NotebookReconciler,
CullingReconciler, the StatefulSet simulator and, for the pool-bound
case, the SlicePool reconciler), each side with the
case's own assertions, the same fake clock and the same fake Jupyter and
serving probers; then every object of both stores is compared after
``normalise`` (the culler's annotation stamps included) and so is
``notebook_culling_total``. The ENABLE_CULLING gate of ``build_manager``
is tests/test_torch_notebook_controller.py's, beside its other
entry-point tests.

Then the 18 cases of tests/test_culling_functions.py (the pure
functions, the staged-clock worlds and the serving prober's port
hygiene) on both modules, and the 6 of tests/test_culling_http.py: the
production ``http_prober`` of each side against a real
``ThreadingHTTPServer`` on port 0 playing the dev-mode kubectl proxy.
Last, the slice as a whole: the reference's manager with a shared read
cache, reconciler, culler and simulator beside the port's
``build_manager``, both probing real proxies over HTTP, the same
notebooks culled to the same objects.

Guards: no test sleeps out a check period (clocks are advanced), every
server is shut down in a ``finally``, every ``start()`` stops in one.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubeflow_tpu.api import slicepool as ref_pool_api
from kubeflow_tpu.api import tpuquota as ref_quota_api
from kubeflow_tpu.api import types as ref_api
from kubeflow_tpu.cluster.cache import CachingClient as RefCachingClient
from kubeflow_tpu.cluster.kubelet import StatefulSetSimulator as RefSimulator
from kubeflow_tpu.cluster.store import ClusterStore as RefStore
from kubeflow_tpu.controllers import culling as ref_culling
from kubeflow_tpu.controllers.manager import Manager as RefManager
from kubeflow_tpu.controllers.manager import Request as RefRequest
from kubeflow_tpu.controllers.scheduler import (
    SchedulerReconciler as RefSchedulerReconciler)
from kubeflow_tpu.controllers.slicepool import (
    SlicePoolReconciler as RefSlicePoolReconciler)
from kubeflow_tpu.controllers.notebook import (
    NotebookReconciler as RefReconciler)
from kubeflow_tpu.controllers.slicerepair import (
    SliceRepairReconciler as RefSliceRepairReconciler)
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu.utils import names as ref_names
from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
from kubeflow_tpu.utils.metrics import MetricsRegistry as RefMetrics
from kubeflow_tpu_torch.api import types as api
from kubeflow_tpu_torch.cluster.store import ClusterStore
from kubeflow_tpu_torch.controllers import Manager, Request, culling
from kubeflow_tpu_torch.main import build_manager
from kubeflow_tpu_torch.utils import k8s, names
from kubeflow_tpu_torch.utils.config import ControllerConfig
from torch_parity import Stack, assert_parity, normalise

# one wall-clock instant for both sides: the culler writes 1-second
# stamps, so a clock read on each side would round apart
NOW = 1_760_000_000.0


class FakeClock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class FakeJupyter:
    """Switchable prober; ``activity`` is a side's JupyterActivity or a
    function of the notebook returning one."""

    def __init__(self, s):
        self.activity = s.culling.JupyterActivity(
            kernels=[{"execution_state": "busy"}])
        self.probes = 0

    def __call__(self, notebook):
        self.probes += 1
        return self.activity(notebook) if callable(self.activity) \
            else self.activity


class FakeServing:
    """Switchable serving-endpoint counter (None = unreachable)."""

    def __init__(self):
        self.total = None
        self.probes = 0
        self.port = None

    def __call__(self, notebook, port):
        self.probes += 1
        self.port = port
        return self.total


def culling_world(s, serving: bool = False) -> None:
    """The reference's ``culling_world`` / ``serving_world`` fixtures on
    stack ``s``: reconciler, culler (fake clock and probers) and the
    simulator, in that order."""
    s.clock = FakeClock()
    s.jupyter = FakeJupyter(s)
    s.config = s.Config(enable_culling=True, cull_idle_time_min=60,
                        idleness_check_period_min=1)
    s.reconciler()
    kw = {"prober": s.jupyter, "clock": s.clock}
    if serving:
        s.jupyter.activity = s.culling.JupyterActivity(kernels=[])
        s.serving = FakeServing()
        kw["serving_prober"] = s.serving
    s.culler(**kw)
    s.simulator()


def tick(s, minutes):
    """Advance the fake clock and re-drive the periodic requeues without
    waiting wall-clock time."""
    s.clock.advance(minutes * 60)
    for nb in s.store.list(s.api.KIND):
        s.manager.enqueue("culling-controller",
                          s.Request(s.k8s.namespace(nb), s.k8s.name(nb)))
    s.drain(include_delayed_under=0.1)


def nb_of(s, name="nb", ns="ns"):
    return s.store.get(s.api.KIND, ns, name)


# ------------------------------------------------ tests/test_culling.py
def initializes_annotations(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    nb = nb_of(s)
    assert s.k8s.get_annotation(nb, s.names.LAST_ACTIVITY_ANNOTATION)
    assert s.k8s.get_annotation(
        nb, s.names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION)


def busy_kernel_prevents_cull(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    for _ in range(5):
        tick(s, 30)  # 150 min busy, threshold 60
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) is None
    assert s.jupyter.probes > 0


def idle_notebook_culled_slice_atomic(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    pods = {s.names.NOTEBOOK_NAME_LABEL: "nb"}
    assert len(s.store.list("Pod", "ns", pods)) == 4
    # the user goes idle at a known time, then 61 minutes pass
    s.jupyter.activity = s.culling.JupyterActivity(kernels=[{
        "execution_state": "idle",
        "last_activity": s.culling.format_time(s.clock())}])
    tick(s, 2)
    tick(s, 61)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None
    # all four workers reaped, never a partial count
    assert s.store.list("Pod", "ns", pods) == []
    assert s.store.get("StatefulSet", "ns", "nb")["spec"]["replicas"] == 0
    assert s.metrics.notebook_culling_total.get(
        {"namespace": "ns", "name": "nb"}) == 1
    # activity annotations stripped once stopped
    tick(s, 2)
    assert s.k8s.get_annotation(nb_of(s),
                                s.names.LAST_ACTIVITY_ANNOTATION) is None


def one_dead_endpoint_does_not_mask_busy_kernel(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    s.jupyter.activity = s.culling.JupyterActivity(
        kernels=[{"execution_state": "busy"}], terminals=None)
    for _ in range(4):
        tick(s, 45)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) is None


def unreachable_jupyter_does_not_advance_activity(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    s.jupyter.activity = s.culling.JupyterActivity(kernels=None,
                                                   terminals=None)
    tick(s, 2)
    tick(s, 61)  # unreachable the whole time → idle → cull
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None


def terminal_activity_counts(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)

    def active_terminal(nb):
        # kernels idle and stale, but a terminal stays active
        return s.culling.JupyterActivity(
            kernels=[{"execution_state": "idle",
                      "last_activity": "2000-01-01T00:00:00Z"}],
            terminals=[{"last_activity": s.culling.format_time(s.clock())}])
    s.jupyter.activity = active_terminal
    for _ in range(4):
        tick(s, 45)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) is None


def no_pod_strips_annotations(s):
    culling_world(s)
    # created stopped → no pods ever
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.STOP_ANNOTATION: "t"}))
    s.drain(include_delayed_under=0.1)
    assert s.k8s.get_annotation(nb_of(s),
                                s.names.LAST_ACTIVITY_ANNOTATION) is None


def unreachable_probe_pauses_idle_clock_during_repair(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    s.jupyter.activity = s.culling.JupyterActivity(kernels=[{
        "execution_state": "idle",
        "last_activity": s.culling.format_time(s.clock())}])
    tick(s, 2)
    # repair starts; Jupyter goes dark for 2+ hours
    s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {"annotations": {
        s.names.SLICE_HEALTH_ANNOTATION: "Repairing"}}})
    s.jupyter.activity = s.culling.JupyterActivity(kernels=None,
                                                   terminals=None)
    tick(s, 61)
    tick(s, 61)  # far past the 60-min cull threshold
    nb = nb_of(s)
    assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None
    assert s.k8s.get_annotation(nb, s.names.LAST_ACTIVITY_ANNOTATION) \
        is not None
    # repair over, probe still unreachable → idleness resumes from the
    # frozen point and the normal cull path applies again
    s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {"annotations": {
        s.names.SLICE_HEALTH_ANNOTATION: None}}})
    tick(s, 61)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None


def missing_worker0_during_repair_does_not_strip_activity(s):
    culling_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    s.drain(include_delayed_under=0.1)
    tick(s, 2)
    assert s.k8s.get_annotation(nb_of(s), s.names.LAST_ACTIVITY_ANNOTATION) \
        is not None
    # the repair controller's scale-down hold: the core reconciler scales
    # the slice to 0 and the simulator reaps every pod
    s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {"annotations": {
        s.names.SLICE_HEALTH_ANNOTATION: "Repairing",
        s.names.REPAIR_SCALE_DOWN_ANNOTATION: "true"}}})
    s.drain(include_delayed_under=0.1)
    assert s.store.list("Pod", "ns",
                        {s.names.NOTEBOOK_NAME_LABEL: "nb"}) == []
    tick(s, 61)
    nb = nb_of(s)
    assert s.k8s.get_annotation(nb, s.names.LAST_ACTIVITY_ANNOTATION) \
        is not None
    assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None


def serving_traffic_prevents_cull(s):
    culling_world(s, serving=True)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "8890"}))
    s.drain(include_delayed_under=0.1)
    s.serving.total = 10
    tick(s, 2)                       # arms the observed counter
    for _ in range(4):
        s.serving.total += 25        # traffic every window
        tick(s, 45)                  # 180 idle-min without the signal
    nb = nb_of(s)
    assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None
    assert s.serving.port == "8890"
    assert s.k8s.get_annotation(
        nb, s.names.SERVING_REQUESTS_OBSERVED_ANNOTATION) == \
        str(s.serving.total)


def idle_serving_endpoint_still_culls(s):
    culling_world(s, serving=True)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "8890"}))
    s.drain(include_delayed_under=0.1)
    s.serving.total = 500
    tick(s, 2)
    tick(s, 45)
    tick(s, 45)                      # 90+ min, counter never moved
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None


def serving_counter_reset_rearms_without_activity_credit(s):
    culling_world(s, serving=True)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "8890"}))
    s.drain(include_delayed_under=0.1)
    s.serving.total = 400
    tick(s, 2)                       # arm at 400
    s.serving.total = 3              # restart: counter reset
    tick(s, 45)
    assert s.k8s.get_annotation(
        nb_of(s), s.names.SERVING_REQUESTS_OBSERVED_ANNOTATION) == "3"
    tick(s, 45)                      # still no new traffic → cull
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None


def unreachable_serving_endpoint_is_not_activity(s):
    culling_world(s, serving=True)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "8890"}))
    s.drain(include_delayed_under=0.1)
    s.serving.total = None           # probe always fails
    tick(s, 2)
    tick(s, 61)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None
    assert s.serving.probes > 0


def culling_pool_bound_notebook_releases_not_deletes(s):
    """Culling a pool-BOUND notebook hands the backing StatefulSet back
    to the pool (released + scrubbed + re-warmed), never deletes or
    zeroes it, and the scrub strips tenant residue (user annotations, a
    leaked idle clock) so the NEXT notebook binding this slice starts
    with a fresh idle clock."""
    s.clock = FakeClock()
    s.jupyter = FakeJupyter(s)
    s.config = s.Config(enable_culling=True, cull_idle_time_min=60,
                        idleness_check_period_min=1, pool_poll_s=0.02,
                        pool_bind_grace_s=5.0)
    s.reconciler()
    s.culler(prober=s.jupyter, clock=s.clock)
    s.pool()
    s.simulator()

    s.store.create(s.slice_pool("cull-pool", "v5e-16", 1))
    s.drain(include_delayed_under=0.1)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    bound = s.pool_api.bound_slice_ref(nb_of(s))
    assert bound is not None, "notebook never bound the warm slice"
    # culler probes worker-0 IN THE POOL NAMESPACE and initializes the clock
    tick(s, 2)
    assert s.k8s.get_annotation(nb_of(s), s.names.LAST_ACTIVITY_ANNOTATION) \
        is not None
    # simulate tenant residue leaking onto the slice (the scrub contract)
    s.store.patch("StatefulSet", bound[0], bound[1], {"metadata": {
        "annotations": {
            s.names.LAST_ACTIVITY_ANNOTATION: "2000-01-01T00:00:00Z",
            "user.example.com/note": "sticky"}}})

    # idle past the threshold → culled
    s.jupyter.activity = s.culling.JupyterActivity(kernels=[{
        "execution_state": "idle",
        "last_activity": s.culling.format_time(s.clock())}])
    tick(s, 2)
    tick(s, 61)
    assert s.k8s.get_annotation(nb_of(s), s.names.STOP_ANNOTATION) \
        is not None
    s.drain(include_delayed_under=0.1)

    # released, NOT deleted — and not scaled to 0 (the cull released the
    # bind; the slice re-warms at full replicas for the next tenant)
    sts = s.store.get_or_none("StatefulSet", *bound)
    assert sts is not None, "culling deleted the pool-backed StatefulSet"
    assert sts["spec"]["replicas"] == 4
    assert s.pool_api.bound_slice_ref(nb_of(s)) is None
    # scrub: tenant residue gone, pool bookkeeping intact
    anns = s.k8s.annotations(sts) or {}
    assert s.names.LAST_ACTIVITY_ANNOTATION not in anns
    assert "user.example.com/note" not in anns
    assert s.names.POOL_BOUND_TO_ANNOTATION not in anns
    assert s.k8s.get_label(sts, s.names.POOL_LABEL) == "cull-pool"

    # a NEW notebook re-binds the released slice with a fresh idle clock
    s.drain(include_delayed_under=0.1)  # let the scrubbed slice re-warm
    s.jupyter.activity = s.culling.JupyterActivity(
        kernels=[{"execution_state": "busy"}])
    s.store.create(s.api.new_notebook("nb2", "ns2", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    assert s.pool_api.bound_slice_ref(nb_of(s, "nb2", "ns2")) == bound, \
        "slice never re-bound"


CASES = {fn.__name__: fn for fn in (
    initializes_annotations, busy_kernel_prevents_cull,
    idle_notebook_culled_slice_atomic,
    one_dead_endpoint_does_not_mask_busy_kernel,
    unreachable_jupyter_does_not_advance_activity, terminal_activity_counts,
    no_pod_strips_annotations,
    unreachable_probe_pauses_idle_clock_during_repair,
    missing_worker0_during_repair_does_not_strip_activity,
    serving_traffic_prevents_cull, idle_serving_endpoint_still_culls,
    serving_counter_reset_rearms_without_activity_credit,
    unreachable_serving_endpoint_is_not_activity,
    culling_pool_bound_notebook_releases_not_deletes)}


def culled(s) -> dict:
    """``notebook_culling_total`` of every notebook in the store."""
    return {(s.k8s.namespace(nb), s.k8s.name(nb)):
            s.metrics.notebook_culling_total.get(
                {"namespace": s.k8s.namespace(nb), "name": s.k8s.name(nb)})
            for nb in s.store.list(s.api.KIND)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_culling_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    CASES[case](ref)
    CASES[case](port)
    assert_parity(ref, port)
    assert culled(port) == culled(ref)
    assert port.jupyter.probes == ref.jupyter.probes


# --------------------------------------- tests/test_culling_functions.py
SIDES = {"ref": ref_culling, "port": culling}


def both(fn):
    """``fn(module)`` on the reference's culling module and the port's;
    the two results, which must be equal."""
    got = {side: fn(mod) for side, mod in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


class TestTimestampFormat:
    def test_round_trip(self):
        now = float(int(NOW))
        assert both(lambda m: m.parse_time(m.format_time(now))) == now

    def test_format_is_rfc3339_zulu(self):
        assert both(lambda m: m.format_time(1735689600.0)) == \
            "2025-01-01T00:00:00Z"

    def test_parse_rejects_garbage(self):
        for mod in SIDES.values():
            with pytest.raises(ValueError):
                mod.parse_time("yesterday-ish")


class TestAllKernelsIdle:
    def test_empty_kernel_list_is_idle(self):
        assert not both(lambda m: m.JupyterActivity(
            kernels=[], terminals=[]).any_busy())

    def test_all_idle_kernels(self):
        assert not both(lambda m: m.JupyterActivity(kernels=[
            {"execution_state": "idle"},
            {"execution_state": "idle"}]).any_busy())

    def test_one_busy_kernel_flips(self):
        assert both(lambda m: m.JupyterActivity(kernels=[
            {"execution_state": "idle"},
            {"execution_state": "busy"}]).any_busy())

    def test_starting_state_is_not_busy(self):
        assert not both(lambda m: m.JupyterActivity(
            kernels=[{"execution_state": "starting"}]).any_busy())

    def test_unreachable_kernels_not_busy(self):
        assert both(lambda m: (
            m.JupyterActivity(kernels=None, terminals=[]).any_busy(),
            m.JupyterActivity(kernels=None, terminals=[]).reachable)) == \
            (False, True)

    def test_both_endpoints_down_unreachable(self):
        assert not both(lambda m: m.JupyterActivity(
            kernels=None, terminals=None).reachable)


class TestLatestActivity:
    def test_latest_across_kernels_and_terminals(self):
        assert both(lambda m: m.JupyterActivity(
            kernels=[{"last_activity": "2025-01-01T00:00:00Z"}],
            terminals=[{"last_activity": "2025-01-01T02:00:00Z"}],
        ).latest_activity()) == culling.parse_time("2025-01-01T02:00:00Z")

    def test_fractional_seconds_tolerated(self):
        assert both(lambda m: m.JupyterActivity(
            kernels=[{"last_activity": "2025-01-01T00:00:00.123456Z"}],
        ).latest_activity()) == culling.parse_time("2025-01-01T00:00:00Z")

    def test_unparseable_stamps_skipped(self):
        assert both(lambda m: m.JupyterActivity(
            kernels=[{"last_activity": "not-a-time"},
                     {"last_activity": "2025-01-01T00:00:00Z"}],
        ).latest_activity()) == culling.parse_time("2025-01-01T00:00:00Z")

    def test_no_stamps_is_none(self):
        assert both(lambda m: m.JupyterActivity(
            kernels=[{}], terminals=[]).latest_activity()) is None


class TestStopAnnotationAndIdleness:
    """The reference's staged-clock worlds: a culler with an offset clock
    on ``NOW`` (the same instant for both sides) and a prober reporting
    an idle kernel last active at ``NOW``. Their check period of 0 makes
    the culler requeue itself at once for ever (in the reference too), so
    a drain never idles and runs until its timeout: the drains are cut
    at ``DRAIN_S`` and the writes, which count the loop's turns, are not
    compared; the objects are (``run``)."""

    DRAIN_S = 0.3

    @classmethod
    def drain(cls, s):
        s.drain(timeout=cls.DRAIN_S)

    @classmethod
    def make_world(cls, s, idle_minutes_ago: float,
                   cull_after_min: int = 60):
        s.config = s.Config(enable_culling=True,
                            cull_idle_time_min=cull_after_min,
                            idleness_check_period_min=0)
        rec = s.NotebookReconciler(s.store, s.config)
        rec.setup(s.manager)
        last = s.culling.format_time(NOW)
        state = {"off": 0.0}
        s.culler(clock=lambda: NOW + state["off"],
                 prober=lambda nb: s.culling.JupyterActivity(
                     kernels=[{"execution_state": "idle",
                               "last_activity": last}], terminals=[]))
        s.store.create(s.api.new_notebook("nb", "ns"))
        cls.drain(s)
        # stage worker-0 as the culler's probe target
        s.store.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "nb-0", "namespace": "ns",
                                     "labels": {
                                         s.names.NOTEBOOK_NAME_LABEL: "nb"}},
                        "spec": {"containers": [{"name": "nb"}]}})
        cls.drain(s)  # annotation init pass at offset 0
        state["off"] = idle_minutes_ago * 60  # time passes…
        s.store.patch(s.api.KIND, "ns", "nb",
                      {"metadata": {"labels": {"touch": "1"}}})
        cls.drain(s)

    def run(self, case):
        """``case`` on both stacks; every object equal after
        ``normalise`` but for ``metadata.generation``: a drain cut
        mid-loop leaves its queue to the next, so whether the label
        patch and the stop reach the StatefulSet in one write or two
        depends on where the cut fell (on either side)."""
        ref, port = Stack("ref"), Stack("port")
        snaps = []
        for s in (ref, port):
            case(s)
            snap = s.snapshot()
            for obj in snap.values():
                obj["metadata"].pop("generation", None)
            snaps.append(snap)
        assert snaps[1] == snaps[0]
        assert culled(port) == culled(ref)

    def test_idle_beyond_threshold_sets_stop_annotation(self):
        def case(s):
            self.make_world(s, idle_minutes_ago=120, cull_after_min=60)
            stop = (nb_of(s)["metadata"].get("annotations") or {}).get(
                s.names.STOP_ANNOTATION)
            assert stop, "idle notebook was not culled"
            s.culling.parse_time(stop)  # the value is a timestamp
        self.run(case)

    def test_recent_activity_does_not_cull(self):
        def case(s):
            self.make_world(s, idle_minutes_ago=10, cull_after_min=60)
            anns = nb_of(s)["metadata"].get("annotations") or {}
            assert s.names.STOP_ANNOTATION not in anns
            assert s.names.LAST_ACTIVITY_ANNOTATION in anns
        self.run(case)

    def test_already_stopped_notebook_not_reprocessed(self):
        def case(s):
            self.make_world(s, idle_minutes_ago=120, cull_after_min=60)
            stop = nb_of(s)["metadata"]["annotations"][
                s.names.STOP_ANNOTATION]
            s.store.patch(s.api.KIND, "ns", "nb",
                          {"metadata": {"labels": {"touch": "2"}}})
            self.drain(s)
            assert nb_of(s)["metadata"]["annotations"][
                s.names.STOP_ANNOTATION] == stop
        self.run(case)


class TestServingProberPortValidation:
    NB = {"metadata": {"name": "nb", "namespace": "ns"}}

    @pytest.mark.parametrize("port", [
        "", "http", "-1", "0", "65536", "999999",
        "80/../../api/v1/secrets", "80?x=1", "80#frag", "8080:9090",
        None,
    ])
    def test_invalid_port_returns_none_without_probing(self, port):
        for mod, config in ((ref_culling, RefConfig()),
                            (culling, ControllerConfig())):
            probe = mod.serving_requests_prober(config)
            t0 = time.monotonic()
            assert probe(self.NB, port) is None
            assert time.monotonic() - t0 < 0.5

    def test_valid_port_reaches_the_connection_attempt(self):
        kw = dict(dev_mode=True, dev_proxy_url="http://127.0.0.1:9",
                  jupyter_probe_timeout_s=0.2)
        for mod, config in ((ref_culling, RefConfig(**kw)),
                            (culling, ControllerConfig(**kw))):
            assert mod.serving_requests_prober(config)(self.NB, "8080") \
                is None


# ------------------------------------------- tests/test_culling_http.py
class FakeJupyterProxy(ThreadingHTTPServer):
    """The kubectl-proxy URL shape the dev-mode prober uses. ``responses``
    per endpoint: a list or dict (JSON 200), an int (that status), or
    "hang" (answers 500 after 5 s, or nothing once ``released`` is set
    at close); a serving port's ``/healthz`` answers
    ``{"requests_total": healthz_total}``."""

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.daemon_threads = True
        self.responses = {"kernels": [], "terminals": []}
        self.healthz_total = 0
        self.requests_seen: list = []
        self.released = threading.Event()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server_address[1]}"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        self.server.requests_seen.append(self.path)
        endpoint = self.path.rsplit("/", 1)[-1]
        if endpoint == "healthz":
            behavior = {"requests_total": self.server.healthz_total}
        else:
            behavior = self.server.responses.get(endpoint)
        if behavior == "hang":
            if self.server.released.wait(5):
                return
            behavior = 500
        if isinstance(behavior, int):
            self.send_response(behavior)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = json.dumps(behavior or []).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Proxies:
    """One fake proxy per side, served from threads; ``close`` shuts both
    down."""

    def __init__(self):
        self.servers = {}
        self.threads = []
        for side in SIDES:
            server = FakeJupyterProxy()
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            self.servers[side] = server
            self.threads.append(thread)

    def close(self):
        for server in self.servers.values():
            server.released.set()
            server.shutdown()
            server.server_close()
        for thread in self.threads:
            thread.join(timeout=5)


@pytest.fixture()
def proxies():
    p = _Proxies()
    try:
        yield p.servers
    finally:
        p.close()


class HttpWorld:
    """A side's store and culler wired with its real ``http_prober``
    pointed at its proxy; a notebook with a worker-0 pod. The clock is
    ``NOW`` plus an offset."""

    def __init__(self, side: str, proxy):
        ref = side == "ref"
        mod = SIDES[side]
        Config = RefConfig if ref else ControllerConfig
        self.store = RefStore() if ref else ClusterStore()
        self.Request = RefRequest if ref else Request
        self.api = ref_api if ref else api
        self.k8s = ref_k8s if ref else k8s
        self.names = names_ = ref_names if ref else names
        self.side, self.mod, self.jupyter = side, mod, proxy
        self.offset = [0.0]
        config = Config(enable_culling=True, dev_mode=True,
                        dev_proxy_url=proxy.url, cull_idle_time_min=1,
                        idleness_check_period_min=1,
                        jupyter_probe_timeout_s=1.0)
        self.rec = mod.CullingReconciler(
            self.store, config, prober=mod.http_prober(config),
            clock=lambda: NOW + self.offset[0])
        self.rec.setup((RefManager if ref else Manager)(self.store))
        self.store.create(self.api.new_notebook("nb", "ns"))
        self.store.create({
            "kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": "nb-0", "namespace": "ns",
                         "labels": {names_.NOTEBOOK_NAME_LABEL: "nb",
                                    "apps.kubernetes.io/pod-index": "0"}},
            "status": {"phase": "Running"}})

    def tick(self, minutes):
        self.offset[0] += minutes * 60
        self.rec.reconcile(self.Request("ns", "nb"))

    def nb(self):
        return self.store.get(self.api.KIND, "ns", "nb")

    def ann(self, key):
        return self.k8s.get_annotation(self.nb(), key)

    def init_annotations(self):
        self.rec.reconcile(self.Request("ns", "nb"))
        assert self.ann(names.LAST_ACTIVITY_ANNOTATION)


def run_http(proxies, case):
    """``case(world)`` on both sides, each against its own proxy; then
    the Notebooks compared after ``normalise`` and the paths each proxy
    saw."""
    worlds = {side: HttpWorld(side, proxies[side]) for side in SIDES}
    for w in worlds.values():
        case(w)
    got = {side: normalise(w.nb(), side) for side, w in worlds.items()}
    assert got["port"] == got["ref"]
    assert proxies["port"].requests_seen == proxies["ref"].requests_seen
    return worlds


def test_url_shape_is_the_reference_dev_proxy_path(proxies):
    def case(w):
        w.init_annotations()
        w.tick(1.1)
        base = "/api/v1/namespaces/ns/services/nb/proxy/notebook/ns/nb/api"
        assert f"{base}/kernels" in w.jupyter.requests_seen
        assert f"{base}/terminals" in w.jupyter.requests_seen
    run_http(proxies, case)


def test_busy_kernel_over_real_http_prevents_cull(proxies):
    for p in proxies.values():
        p.responses["kernels"] = [{"execution_state": "busy",
                                   "last_activity": "2020-01-01T00:00:00Z"}]

    def case(w):
        w.init_annotations()
        w.tick(2)   # idle threshold passed, but the kernel is busy
        assert w.ann(names.STOP_ANNOTATION) is None
    run_http(proxies, case)


def test_stale_terminal_advances_then_culls(proxies):
    future = culling.format_time(NOW + 30)

    def case(w):
        w.init_annotations()
        # terminal activity a bit ahead of the init stamp keeps it once...
        w.jupyter.responses["terminals"] = [{"last_activity": future}]
        w.tick(1.1)
        assert w.ann(names.LAST_ACTIVITY_ANNOTATION) == future
        assert w.ann(names.STOP_ANNOTATION) is None
        # ...then nothing new: idle time accrues and the cull lands
        w.tick(2)
        assert w.ann(names.STOP_ANNOTATION) is not None
    run_http(proxies, case)


def test_500_on_kernels_still_honors_busy_terminals(proxies):
    future = culling.format_time(NOW + 30)

    def case(w):
        w.init_annotations()
        w.jupyter.responses["kernels"] = 500
        w.jupyter.responses["terminals"] = [{"last_activity": future}]
        w.tick(1.1)
        assert w.ann(names.LAST_ACTIVITY_ANNOTATION) == future
    run_http(proxies, case)


def test_timeout_counts_as_unreachable_not_activity(proxies):
    def case(w):
        w.init_annotations()
        before = w.ann(names.LAST_ACTIVITY_ANNOTATION)
        w.jupyter.responses["kernels"] = "hang"
        w.jupyter.responses["terminals"] = "hang"
        start = time.monotonic()
        w.tick(1.1)
        assert time.monotonic() - start < 4  # both probes time-boxed at 1s
        assert w.ann(names.LAST_ACTIVITY_ANNOTATION) == before
        w.tick(2)
        assert w.ann(names.STOP_ANNOTATION)
    run_http(proxies, case)


def test_non_json_body_is_unreachable(proxies):
    def case(w):
        w.init_annotations()
        before = w.ann(names.LAST_ACTIVITY_ANNOTATION)
        w.jupyter.responses["kernels"] = {"not": "a-list-but-parses"}
        w.jupyter.responses["terminals"] = 404
        w.tick(1.1)
        # kernels parsed (a dict: no list), terminals down: no advance
        assert w.ann(names.LAST_ACTIVITY_ANNOTATION) == before
    run_http(proxies, case)


# ------------------------------------------------- the slice as a whole
def _ref_core(store, config, offset):
    """The reference composed as the port's ``build_manager``: the
    SlicePool and TPUQuota CRDs, one watch-fed read cache the reconcilers
    read through, the Notebook reconciler, the culler on an offset clock,
    the slice repair and SlicePool reconcilers, the fleet scheduler and
    the simulator on the cache (reference main.py / setup_controllers'
    core path)."""
    ref_pool_api.install_slicepool_crd(store)
    ref_quota_api.install_tpuquota_crd(store)
    cache = RefCachingClient(store, auto_informer=False,
                             disable_for=("Secret", "ConfigMap", "Event"))
    metrics = RefMetrics()
    cache.attach_metrics(metrics)
    mgr = RefManager(cache, read_cache=cache)
    mgr.attach_metrics(metrics)
    mgr.metrics = metrics
    RefReconciler(cache, config, metrics).setup(mgr)
    ref_culling.CullingReconciler(
        cache, config, metrics, clock=lambda: NOW + offset[0]).setup(mgr)
    if config.enable_slice_repair:
        RefSliceRepairReconciler(cache, config, metrics).setup(mgr)
    if config.enable_slice_pool:
        RefSlicePoolReconciler(cache, config, metrics).setup(mgr)
    if config.enable_scheduler:
        RefSchedulerReconciler(cache, config, metrics).setup(mgr)
    RefSimulator(mgr.read_cache, boot_delay_s=0.0).setup(mgr)
    return mgr


def test_slice_culled_whole_through_both_control_planes(proxies):
    """An h100-32 (v5e-16) notebook hosting a model endpoint and an
    idle h100-4 (v5e-4) one, each side's culler probing its own proxy
    over HTTP: served traffic keeps the first up past the cull time, and
    with none both are culled at one check, each StatefulSet straight to
    0 with all its workers. The objects, the proxies' paths and the
    culling counters of both sides are equal."""
    runs = {}
    for side, proxy in proxies.items():
        ref = side == "ref"
        s = Stack(side)
        Config = RefConfig if ref else ControllerConfig
        config = Config(dev_mode=True, dev_proxy_url=proxy.url,
                        cull_idle_time_min=60, idleness_check_period_min=1,
                        jupyter_probe_timeout_s=2.0)
        offset = [0.0]
        if ref:
            mgr = _ref_core(s.store, config, offset)
        else:
            mgr = build_manager(s.store, config, simulate_kubelet=True)
            culling.CullingReconciler(
                mgr.client, config, mgr.metrics,
                clock=lambda: NOW + offset[0]).setup(mgr)
        s.manager, s.metrics = mgr, mgr.metrics
        s.timed = True   # the simulator's pod readiness rides a timed requeue
        assert mgr.read_cache is not None
        replicas = {"served": [], "idle": []}

        def on_sts(event, replicas=replicas, s=s):
            name = s.k8s.name(event.obj)
            seq = replicas.get(name)
            if seq is not None and (not seq or seq[-1] !=
                                    event.obj["spec"]["replicas"]):
                seq.append(event.obj["spec"]["replicas"])
        s.store.watch("StatefulSet", on_sts)
        s.store.create(s.api.new_notebook("served", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
            s.names.SERVING_PORT_ANNOTATION: "8890"}))
        s.store.create(s.api.new_notebook("idle", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4")}))

        def check(minutes, *nbs, s=s, offset=offset):
            offset[0] += minutes * 60
            for name in nbs:
                s.manager.enqueue("culling-controller", s.Request("ns", name))
            s.drain(include_delayed_under=0.1)

        s.drain(include_delayed_under=0.1)
        proxy.healthz_total = 8
        check(1, "served")                 # arms at 8
        proxy.healthz_total = 16
        check(61, "served")                # credits: kept past the cull time
        anns = s.store.get(s.api.KIND, "ns", "served")["metadata"][
            "annotations"]
        assert anns[s.names.SERVING_REQUESTS_OBSERVED_ANNOTATION] == "16"
        assert s.names.STOP_ANNOTATION not in anns
        check(61, "served", "idle")        # no traffic: both culled
        for name in ("served", "idle"):
            assert s.k8s.get_annotation(
                s.store.get(s.api.KIND, "ns", name),
                s.names.STOP_ANNOTATION) is not None
            assert s.store.list("Pod", "ns",
                                {s.names.NOTEBOOK_NAME_LABEL: name}) == []
        assert replicas == {"served": [4, 0], "idle": [1, 0]}
        runs[side] = s
    assert_parity(runs["ref"], runs["port"])
    assert culled(runs["port"]) == culled(runs["ref"])
    assert proxies["port"].requests_seen == proxies["ref"].requests_seen
