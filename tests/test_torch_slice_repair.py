"""The port's slice repair and quarantine held against the reference's,
case for case.

Every case of tests/test_slice_repair.py runs through both stacks
(``torch_parity.Stack``: store, Manager, NotebookReconciler,
SliceRepairReconciler and the StatefulSet simulator with its node
lifecycle), each side with the case's own assertions. The v5e-16 request
maps to h100-32 (four workers on both sides). Both sides run on one fake
clock, set back to the same start before each side's run, and each
side's reconciler gets ``random.Random(SEED)``. Where the reference sleeps or polls wall time,
the case advances the clock and enqueues the repair reconciler
(``tick``); every other step is a bounded ``run_until_idle``. The
reconciler's own polls (``slice_repair_poll_s``) are set far beyond any
drain's window, so only ``tick`` runs them. A wedged slice (a ready hook
that says no) keeps the simulator polling its pods for ever, so the
wedged worlds boot pods with a delay whose polls fall outside the
window while the hook says no; every drain ends idle.

At the points each case marks, every object of both stores is compared
after ``normalise``; so are the four repair metric families and the two
of the elastic and migration paths, exposition line for line, and the
values each case returns (the 50 backoff delays among them, exactly).
The quarantine annotation's leading wall-clock stamp (``now_iso``, not
the injected clock, on both sides) is the one value masked.

The elastic cases drive each package's own ``SimulatedElasticAgent`` with
``poll_once`` between drains. The migration branch needs a pool-bound
notebook and is held with the SlicePool reconciler (ROADMAP.md queue A
item 3). No case sleeps and no manager is started.
"""

from __future__ import annotations

import random
import re

import pytest

from kubeflow_tpu.runtime import elastic as ref_elastic
from kubeflow_tpu_torch.runtime import elastic
from torch_parity import Stack, normalise

NS = "repair-ns"
SEED = 16
T0 = 1_000_000.0
POLL = 3600.0          # the reconciler's poll, in real seconds: never due
GRACE = 0.005          # the simulator's NotReady -> eviction window
WINDOW = 0.02          # timed requeues a drain runs (the simulator's)
# a wedged world's boot delay: its readiness polls (a quarter of it)
# fall outside WINDOW, and a drain waits it out only while the hook
# admits pods
WEDGED_BOOT = 0.2
FAMILIES = ("slice_repairs_total", "slice_repair_duration_seconds",
            "slice_quarantines_total", "slice_degraded",
            "notebook_migrations_total", "elastic_resizes_total")
ELASTIC = {"ref": ref_elastic, "port": elastic}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def fast_config(s, **overrides):
    """tests/test_slice_repair.py's ``fast_config`` on the fake clock:
    backoff, timeout and window in its seconds, the poll out of reach."""
    defaults = dict(slice_repair_backoff_base_s=1.0,
                    slice_repair_backoff_max_s=5.0,
                    slice_repair_poll_s=POLL,
                    slice_repair_timeout_s=30.0,
                    slice_repair_max_failures=3,
                    slice_repair_window_s=600.0)
    defaults.update(overrides)
    return s.Config(**defaults)


def repair_world(s, config=None, ready_hook=None,
                 boot_delay_s=0.0) -> None:
    """The reference's ``RepairWorld`` on stack ``s``: reconciler,
    repairer (the case's fake clock, seeded rng) and the simulator, in
    that order, and a watch that records every replicas value."""
    s.config = config or fast_config(s)
    s.reconciler()
    s.repairer(clock=s.clock, rng=random.Random(SEED))
    s.simulator(node_grace_s=GRACE, ready_hook=ready_hook,
                boot_delay_s=boot_delay_s)
    s.window = WINDOW if not boot_delay_s else boot_delay_s + 0.1
    s.replicas_observed = set()

    def observe(ev):
        if ev.type != "DELETED":
            s.replicas_observed.add(s.k8s.get_in(ev.obj, "spec", "replicas"))
    s.store.watch("StatefulSet", observe)


def wedged_world(s, **overrides) -> None:
    """Pods pass the readiness gate only while ``s.allow["ok"]``: the
    crashlooping-image shape, where every repair times out."""
    s.allow = {"ok": True}
    repair_world(s, config=fast_config(s, **overrides),
                 ready_hook=lambda pod: s.allow["ok"],
                 boot_delay_s=WEDGED_BOOT)


def settle(s) -> int:
    """Drain the queue and the simulator's timed requeues, but not the
    readiness polls of a wedged slice's pods."""
    wedged = getattr(s, "allow", {"ok": True})["ok"] is False
    return s.drain(include_delayed_under=WINDOW if wedged else s.window)


def tick(s, seconds: float) -> None:
    """Advance the fake clock and run the repair reconciler's poll of
    every notebook, as its timed requeue would after ``seconds``."""
    s.clock.advance(seconds)
    for nb in s.store.list(s.api.KIND):
        s.manager.enqueue("slice-repair-controller",
                          s.Request(s.k8s.namespace(nb), s.k8s.name(nb)))
    settle(s)


def create(s, name="nb", **annotations) -> None:
    s.store.create(s.api.new_notebook(name, NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        **annotations}))
    settle(s)


def notebook(s, name="nb"):
    return s.store.get(s.api.KIND, NS, name)


def slice_ready(s, name="nb") -> bool:
    nb = s.store.get_or_none(s.api.KIND, NS, name)
    cond = s.api.get_condition(nb, s.api.CONDITION_SLICE_READY) \
        if nb else None
    return bool(cond and cond.get("status") == "True")


def health(s, name="nb"):
    return s.slicerepair.slice_health(notebook(s, name))


def ann(s, key, name="nb"):
    return s.k8s.get_annotation(notebook(s, name), key)


def pods(s, name="nb"):
    return sorted(s.store.list("Pod", NS, {s.names.NOTEBOOK_NAME_LABEL: name}),
                  key=s.k8s.name)


def counter(s, family: str, labels=None) -> float:
    c = s.metrics.counter(family, "")
    return c.get(labels) if labels is not None else c.total()


def reasons(s) -> set:
    return {e["reason"] for e in s.store.list("Event", NS)}


def families(s) -> list[str]:
    """The exposition lines of the repair, migration and elastic metric
    families (a scrape: ``slice_degraded`` is computed in it)."""
    out = []
    for line in s.metrics.expose().splitlines():
        name = line.split()[2] if line.startswith("#") else \
            re.split(r"[{ ]", line)[0]
        if any(name == f or name.startswith(f + "_") for f in FAMILIES):
            out.append(line)
    return out


_STAMPED = re.compile(r"^\S+ ")


def snapshot(s) -> dict:
    """Every object of the store after ``normalise``, the quarantine
    annotation's leading wall-clock stamp masked."""
    out = {}
    for o in s.store.all_objects():
        obj = normalise(o, s.side)
        anns = (obj.get("metadata") or {}).get("annotations") or {}
        q = anns.get(s.names.QUARANTINE_ANNOTATION)
        if q is not None:
            anns[s.names.QUARANTINE_ANNOTATION] = _STAMPED.sub("<time> ", q)
        out[(o["kind"], s.k8s.namespace(o), s.k8s.name(o))] = obj
    return out


def mark(s, label: str) -> None:
    """A comparison point: the objects and the metric families now."""
    s.marks.append((label, snapshot(s), families(s)))


# -------------------------------------------------- repair happy path
def node_death_triggers_slice_atomic_repair(s):
    repair_world(s)
    create(s)
    assert slice_ready(s)
    mark(s, "ready")
    names_before = [s.k8s.name(p) for p in pods(s)]
    hostnames_before = [p["spec"]["hostname"] for p in pods(s)]
    victim = pods(s)[1]["spec"]["nodeName"]
    s.kubelet.kill_node(s.store, victim)
    settle(s)
    mark(s, "repaired")
    assert counter(s, "slice_repairs_total") >= 1, "repair never started"
    assert slice_ready(s) and health(s) is None
    assert [s.k8s.name(p) for p in pods(s)] == names_before
    assert [p["spec"]["hostname"] for p in pods(s)] == hostnames_before
    assert all(p["spec"]["nodeName"] != victim for p in pods(s))
    assert s.replicas_observed <= {0, 4}
    assert {"SliceDegraded", "SliceRepairStarted", "SliceRepaired"} <= \
        reasons(s)
    assert f'slice_repair_duration_seconds_count{{namespace="{NS}"}} 1' \
        in families(s)
    return {"replicas": sorted(s.replicas_observed)}


def preemption_notice_taint_triggers_repair(s):
    repair_world(s)
    create(s)
    victim = pods(s)[0]["spec"]["nodeName"]
    s.kubelet.preempt_node(s.store, victim)
    settle(s)
    assert counter(s, "slice_repairs_total",
                   {"namespace": NS, "reason": "NodePreempted"}) >= 1
    assert slice_ready(s) and health(s) is None
    assert all(p["spec"]["nodeName"] != victim for p in pods(s))
    assert s.replicas_observed <= {0, 4}
    # one preemption is normal fleet weather: no quarantine
    assert ann(s, s.names.QUARANTINE_ANNOTATION) is None
    return {"replicas": sorted(s.replicas_observed)}


def silently_replaced_worker_triggers_slice_roll(s):
    repair_world(s)
    create(s)
    uid_before = {s.k8s.name(p): s.k8s.uid(p) for p in pods(s)}
    s.store.delete("Pod", NS, "nb-2")   # the simulator recreates it
    settle(s)
    assert counter(s, "slice_repairs_total",
                   {"namespace": NS, "reason": "WorkerReplaced"}) >= 1, \
        "replacement never detected"
    assert slice_ready(s) and health(s) is None
    uid_after = {s.k8s.name(p): s.k8s.uid(p) for p in pods(s)}
    assert set(uid_after) == set(uid_before)
    assert all(uid_after[n] != uid_before[n] for n in uid_before)
    assert s.replicas_observed <= {0, 4}
    return {"replicas": sorted(s.replicas_observed)}


def full_slice_replacement_is_a_consistent_new_mesh(s):
    repair_world(s)
    create(s)
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.RESTART_ANNOTATION: "true"}}})
    settle(s)
    assert len(pods(s)) == 4 and slice_ready(s)
    for _ in range(3):      # polls in which a spurious repair would start
        tick(s, 5.0)
    assert counter(s, "slice_repairs_total") == 0
    assert health(s) is None
    return {}


def status_conditions_mirror_health_state(s):
    repair_world(s)
    create(s)
    seen = set()

    def on_nb(ev):
        if ev.type == "DELETED":
            return
        for cond_type in (s.api.CONDITION_SLICE_DEGRADED,
                          s.api.CONDITION_SLICE_REPAIRING):
            cond = s.api.get_condition(ev.obj, cond_type)
            if cond and cond.get("status") == "True":
                seen.add(cond_type)
    s.store.watch(s.api.KIND, on_nb)
    s.kubelet.kill_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    assert s.api.CONDITION_SLICE_REPAIRING in seen, seen
    assert slice_ready(s) and health(s) is None
    s.store.unwatch(on_nb)
    return {"seen": sorted(seen)}


# ----------------------------------------------------------- quarantine
def k_failed_repairs_quarantine_and_manual_clear(s):
    wedged_world(s, slice_repair_timeout_s=30.0,
                 slice_repair_max_failures=2)
    create(s)
    assert slice_ready(s)
    s.allow["ok"] = False
    # a persistent signal: the notice taint stays until the repair rolls
    # the pods off the node
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    assert health(s) == s.slicerepair.REPAIRING
    mark(s, "first repair")
    tick(s, 31.0)            # the first repair times out
    assert health(s) == s.slicerepair.DEGRADED
    mark(s, "first failure")
    tick(s, 10.0)            # past the backoff: the second repair starts
    assert health(s) == s.slicerepair.REPAIRING
    tick(s, 31.0)            # K = 2 failed repairs: the poison pill
    mark(s, "quarantined")
    assert ann(s, s.names.QUARANTINE_ANNOTATION) is not None, \
        "never quarantined"
    assert health(s) == s.slicerepair.QUARANTINED
    cond = s.api.get_condition(notebook(s),
                               s.api.CONDITION_SLICE_QUARANTINED)
    assert cond and cond["status"] == "True"
    assert counter(s, "slice_quarantines_total", {"namespace": NS}) == 1

    # no repair while quarantined, however long
    repairs = counter(s, "slice_repairs_total")
    for _ in range(4):
        tick(s, 60.0)
    assert counter(s, "slice_repairs_total") == repairs
    assert health(s) == s.slicerepair.QUARANTINED

    # the operator fixes the image and clears the annotation
    s.allow["ok"] = True
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.QUARANTINE_ANNOTATION: None}}})
    settle(s)
    assert slice_ready(s) and health(s) is None, \
        "never recovered after quarantine clear"
    assert ann(s, s.names.REPAIR_FAILURES_ANNOTATION) is None
    assert {"SliceQuarantined", "SliceQuarantineCleared"} <= reasons(s)
    assert s.replicas_observed <= {0, 4}
    return {"repairs": repairs, "replicas": sorted(s.replicas_observed)}


def quarantine_survives_controller_restart(s):
    wedged_world(s, slice_repair_timeout_s=20.0,
                 slice_repair_max_failures=1)
    s.allow["ok"] = False
    create(s)
    assert len(pods(s)) == 4
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    tick(s, 21.0)
    assert ann(s, s.names.QUARANTINE_ANNOTATION) is not None
    mark(s, "quarantined")
    # a new controller process on the same cluster state: a fresh
    # manager, reconcilers, metrics and simulator; the slice boots
    s.manager = type(s.manager)(s.store)
    s.metrics = type(s.metrics)()
    s.allow = {"ok": True}
    repair_world(s, config=fast_config(s, slice_repair_timeout_s=20.0,
                                       slice_repair_max_failures=1))
    s.manager.enqueue("slice-repair-controller", s.Request(NS, "nb"))
    settle(s)
    for _ in range(3):
        tick(s, 30.0)
    assert counter(s, "slice_repairs_total") == 0
    assert health(s) == s.slicerepair.QUARANTINED
    return {}


# --------------------------------------------------------------- backoff
def repair_backoff_is_decorrelated_jitter_and_caps(s):
    rec = s.slicerepair.SliceRepairReconciler(
        s.store, s.Config(slice_repair_backoff_base_s=0.5,
                          slice_repair_backoff_max_s=4.0),
        rng=random.Random(7))
    key = (NS, "nb")
    delays = [rec._next_backoff_locked(key) for _ in range(50)]
    assert all(0.5 <= d <= 4.0 for d in delays), delays[:5]
    assert max(delays) <= 4.0
    assert len({round(d, 6) for d in delays}) > 10
    rec._reset_backoff(key)
    after_reset = rec._next_backoff_locked(key)
    assert after_reset <= 1.5
    return {"delays": delays, "after_reset": after_reset}


# ------------------------------------------------------- detection unit
def detect_crashloop_and_node_states(s):
    rec = s.slicerepair.SliceRepairReconciler(s.store, fast_config(s))
    nb = s.api.new_notebook("nb", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")})

    def pod(name, node=None, ready=None, waiting=None, restarts=0):
        p = {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": name, "namespace": NS,
                          "labels": {s.names.NOTEBOOK_NAME_LABEL: "nb"}},
             "spec": {}, "status": {"conditions": [],
                                    "containerStatuses": []}}
        if node:
            p["spec"]["nodeName"] = node
        if ready is not None:
            p["status"]["conditions"] = [
                {"type": "Ready", "status": "True" if ready else "False"}]
        if waiting or restarts:
            p["status"]["containerStatuses"] = [{
                "name": "c", "restartCount": restarts,
                "state": {"waiting": {"reason": waiting}} if waiting
                else {}}]
        return p

    def node(name):
        s.store.create({"apiVersion": "v1", "kind": "Node",
                        "metadata": {"name": name}, "spec": {},
                        "status": {"conditions": [
                            {"type": "Ready", "status": "True"}]}})

    got = [rec._detect(nb, [pod("nb-0")])]
    assert got[-1] == []                     # booting: not a problem
    got.append(rec._detect(nb, [pod("nb-0", ready=False)]))
    assert got[-1][0][0] == "WorkerNotReady"
    got.append(rec._detect(nb, [pod("nb-0", waiting="CrashLoopBackOff")]))
    assert got[-1][0][0] == "WorkerCrashLoop"
    got.append(rec._detect(nb, [pod("nb-0", restarts=5)]))
    assert got[-1][0][0] == "WorkerCrashLoop"
    node("n-ok")
    got.append(rec._detect(nb, [pod("nb-0", node="n-ok", ready=True)]))
    assert got[-1] == []
    s.kubelet.set_node_ready(s.store, "n-ok", False)
    got.append(rec._detect(nb, [pod("nb-0", node="n-ok", ready=True)]))
    assert got[-1][0][0] == "NodeNotReady"
    node("n-taint")
    s.kubelet.taint_node(s.store, "n-taint")
    got.append(rec._detect(nb, [pod("nb-0", node="n-taint", ready=True)]))
    assert got[-1][0][0] == "NodePreempted"
    got.append(rec._detect(nb, [pod("nb-0", node="n-gone", ready=True)]))
    assert got[-1][0][0] == "NodeGone"
    # the module's own node verdicts on the same nodes
    verdicts = [s.slicerepair.node_problem(s.store.get_or_none("Node", "", n))
                for n in ("n-ok", "n-taint", "n-gone")]
    return {"detect": got, "node_problem": verdicts,
            "crashloop_restarts": s.slicerepair.CRASHLOOP_RESTARTS}


# ------------------------------------------- the simulator's node lifecycle
def sim_node_death_flips_pod_not_ready_then_evicts(s):
    s.config = s.Config(enable_slice_repair=False)
    s.reconciler()
    s.simulator(node_grace_s=0.05)
    s.store.create(s.api.new_notebook("nb", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    assert slice_ready(s)
    victim = pods(s)[2]
    s.kubelet.kill_node(s.store, victim["spec"]["nodeName"])
    # the immediate queue only: the pod flips Ready=False within one tick
    s.drain()
    pod = s.store.get("Pod", NS, s.k8s.name(victim))
    ready = [c for c in pod["status"]["conditions"] if c["type"] == "Ready"]
    assert ready and ready[0]["status"] == "False"
    assert ready[0]["reason"] == "NodeNotReady"
    assert not slice_ready(s)
    mark(s, "not ready")
    # past the grace window the pod is evicted and recreated on a fresh
    # node under the same name and ordinal (the drain waits the window
    # out on the simulator's timed requeues)
    s.drain(include_delayed_under=0.1)
    pod = s.store.get("Pod", NS, s.k8s.name(victim))
    assert pod["spec"]["nodeName"] != victim["spec"]["nodeName"]
    assert s.k8s.get_label(pod, "apps.kubernetes.io/pod-index") == \
        s.k8s.get_label(victim, "apps.kubernetes.io/pod-index")
    assert slice_ready(s)
    return {}


def sim_preemption_notice_blocks_new_bindings_only(s):
    s.config = s.Config(enable_slice_repair=False)
    s.reconciler()
    s.simulator(node_grace_s=0.05)
    s.store.create(s.api.new_notebook("nb", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    pod = pods(s)[0]
    node = pod["spec"]["nodeName"]
    s.kubelet.preempt_node(s.store, node)
    s.drain(include_delayed_under=0.05)
    pod = s.store.get("Pod", NS, s.k8s.name(pod))
    assert pod["spec"]["nodeName"] == node
    assert any(c["type"] == "Ready" and c["status"] == "True"
               for c in pod["status"]["conditions"])
    s.store.delete("Pod", NS, s.k8s.name(pod))
    s.drain(include_delayed_under=0.1)
    pod = s.store.get("Pod", NS, s.k8s.name(pod))
    assert pod["spec"]["nodeName"] != node
    return {}


# ------------------------------------------------------ elastic resize
def create_elastic(s, slices=3):
    create(s, **{s.names.ELASTIC_ANNOTATION: "true",
                 s.names.ELASTIC_SLICES_ANNOTATION: str(slices),
                 s.names.ELASTIC_CURRENT_SLICES_ANNOTATION: str(slices)})


def elastic_shrink_then_grow_back(s):
    repair_world(s)
    create_elastic(s)
    assert slice_ready(s)
    agent = ELASTIC[s.side].SimulatedElasticAgent(s.store, NS, "nb",
                                                  current_slices=3)
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    currents = []
    for turn in range(40):
        settle(s)
        if agent.current == 3 and agent.resizes == 2 and slice_ready(s) \
                and health(s) is None and \
                ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) is None:
            break
        agent.poll_once()
        if not currents or currents[-1] != agent.current:
            currents.append(agent.current)
    assert currents[:3] == [3, 2, 3], "shrink then grow-back never completed"
    assert agent.violations == []
    assert agent.resizes == 2
    assert counter(s, "elastic_resizes_total",
                   {"namespace": NS, "outcome": "shrink"}) >= 1
    assert counter(s, "elastic_resizes_total",
                   {"namespace": NS, "outcome": "grow"}) >= 1
    assert {"ElasticResizeStarted", "ElasticResized", "SliceDegraded"} <= \
        reasons(s)
    return {"turns": turn, "currents": currents, "steps": agent.steps,
            "losses": agent.losses}


def elastic_controller_gates_on_agent_ack(s):
    repair_world(s)
    create_elastic(s)
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) == "Draining"
    assert ann(s, s.names.ELASTIC_TARGET_ANNOTATION) == "2"
    for _ in range(3):       # polls with no ack written
        tick(s, 5.0)
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) == "Draining"
    mark(s, "held at Draining")
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.ELASTIC_ACK_ANNOTATION: "Draining"}}})
    settle(s)
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) == "Resharding"
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.ELASTIC_ACK_ANNOTATION: "Resharding"}}})
    settle(s)
    assert counter(s, "elastic_resizes_total",
                   {"namespace": NS, "outcome": "shrink"}) >= 1
    assert ann(s, s.names.ELASTIC_CURRENT_SLICES_ANNOTATION) == "2"
    return {}


def elastic_abort_latches_when_agent_is_dead(s):
    repair_world(s, config=fast_config(s, elastic_resize_timeout_s=10.0))
    create_elastic(s)
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) == "Draining"
    tick(s, 11.0)            # no agent ever acks
    assert ann(s, s.names.ELASTIC_ACK_ANNOTATION) == "Aborted"
    assert counter(s, "elastic_resizes_total",
                   {"namespace": NS, "outcome": "abort"}) >= 1
    assert slice_ready(s) and health(s) is None, \
        "repair ladder never recovered the slice after the abort"
    for _ in range(2):       # the latch holds: no new cycle
        tick(s, 5.0)
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) is None
    assert ann(s, s.names.ELASTIC_ACK_ANNOTATION) == "Aborted"
    assert ann(s, s.names.ELASTIC_CURRENT_SLICES_ANNOTATION) == "3"
    assert "ElasticResizeAborted" in reasons(s)
    return {}


def non_elastic_notebook_skips_the_elastic_path(s):
    repair_world(s)
    create(s)
    s.kubelet.preempt_node(s.store, pods(s)[0]["spec"]["nodeName"])
    settle(s)
    assert slice_ready(s) and health(s) is None
    assert ann(s, s.names.ELASTIC_RESIZE_ANNOTATION) is None
    assert counter(s, "elastic_resizes_total") == 0
    return {}


CASES = {fn.__name__: fn for fn in (
    node_death_triggers_slice_atomic_repair,
    preemption_notice_taint_triggers_repair,
    silently_replaced_worker_triggers_slice_roll,
    full_slice_replacement_is_a_consistent_new_mesh,
    status_conditions_mirror_health_state,
    k_failed_repairs_quarantine_and_manual_clear,
    quarantine_survives_controller_restart,
    repair_backoff_is_decorrelated_jitter_and_caps,
    detect_crashloop_and_node_states,
    sim_node_death_flips_pod_not_ready_then_evicts,
    sim_preemption_notice_blocks_new_bindings_only,
    elastic_shrink_then_grow_back,
    elastic_controller_gates_on_agent_ack,
    elastic_abort_latches_when_agent_is_dead,
    non_elastic_notebook_skips_the_elastic_path)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_repair_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    clock = FakeClock()
    got = {}
    for s in (ref, port):
        clock.t = T0
        s.clock = clock
        s.marks = []
        got[s.side] = CASES[case](s)
        mark(s, "end")
    assert got["port"] == got["ref"]
    assert [m[0] for m in port.marks] == [m[0] for m in ref.marks]
    for (label, want, want_metrics), (_, have, have_metrics) in zip(
            ref.marks, port.marks):
        assert sorted(have) == sorted(want), label
        for key in sorted(want):
            assert have[key] == want[key], (label, key)
        assert have_metrics == want_metrics, label
