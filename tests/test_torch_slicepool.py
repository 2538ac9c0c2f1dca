"""The port's warm SlicePool reconciler held against the reference's,
case for case.

Every case of tests/test_slicepool.py runs through both stacks
(``torch_parity.Stack``: store, Manager, NotebookReconciler,
SliceRepairReconciler, SlicePoolReconciler and the StatefulSet simulator
with its node lifecycle), each side with the case's own assertions: the
two fair-share cases on each package's ``fair_share_admit``, and the 20
pool cases, among them the four migration cases that hold
``controllers/slicerepair.py``'s checkpoint-migration branch (Checkpointing
→ Binding → Resuming, and the fallback to a cold roll) against the
reference's. The v5e-16 request maps to h100-32 (four workers on both
sides), v5e-8 to h100-8, and the admission case's unparseable v9z-999 to
the unparseable h9z-999.

Both sides run on one fake clock, set back to the same start before each
side's run: the pool reconciler's ``clock`` and ``wall_clock``, the
repairer's ``clock`` and the notebook reconciler's ``wall_clock`` (the
bind-pending heartbeat's epoch seconds), and each side's repairer gets
``random.Random(SEED)``. The pool's and the repairer's polls
(``pool_poll_s``, ``slice_repair_poll_s``) are set far beyond any
drain's window, so only a watch event or ``tick`` (advance the clock,
enqueue both controllers' keys) runs them; where the reference waits on
wall time, the case drains with ``run_until_idle`` over a bounded window
of timed requeues. Two cases wait on real time as the reference's do,
bounded: the bind-grace timeout of a notebook whose pool controller is
down (0.2 s) and a slice that warms slower than the grace (a 1 s boot).

At the points each case marks, every object of both stores is compared
after ``normalise``, and so are the ``slicepool_*`` and
``notebook_migrations_total`` families, exposition line for line. No
case sleeps and no manager is started.

The one thing the normaliser maps beyond the request's shape is the
image the warm slices are rolled with: a test holds the port's to one
that can drive an H100 (the mutating webhook would keep it), where the
reference's is its JAX image.

Last, ``fair_share_admit`` and ``first_fit_pack`` of both packages on a
few hundred inputs drawn with numpy from a seed: equal outputs, exactly.
"""

from __future__ import annotations

import random
import re

import numpy as np
import pytest

from kubeflow_tpu.cluster.errors import InvalidError as RefInvalidError
from kubeflow_tpu.tpu import topology as ref_topology
from kubeflow_tpu.utils import fairness as ref_fairness
from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
from kubeflow_tpu_torch.cluster.errors import InvalidError
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.utils import fairness
from kubeflow_tpu_torch.utils.config import ControllerConfig
from kubeflow_tpu_torch.webhook.mutating import _cannot_drive_h100
from torch_parity import Stack, normalise

NS = "pool-user"
POOL_NS = "tpu-slice-pools"
SEED = 17
T0 = 1_000_000.0
POLL = 3600.0          # the pool's and the repairer's polls: never due
GRACE = 0.005          # the simulator's NotReady -> eviction window
WINDOW = 0.02          # timed requeues a drain runs (the simulator's)
FAMILIES = ("slicepool_size", "slicepool_bind_latency_seconds",
            "slicepool_bind_misses_total", "notebook_migrations_total")
TOPOLOGY = {"ref": ref_topology, "port": topology}
FAIRNESS = {"ref": ref_fairness, "port": fairness}
BAD_ACCELERATOR = {"ref": "v9z-999", "port": "h9z-999"}
INVALID = {"ref": RefInvalidError, "port": InvalidError}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def fast_config(s, **overrides):
    """tests/test_slicepool.py's ``fast_config`` with the pool's and the
    repairer's polls out of a drain's reach."""
    defaults = dict(pool_poll_s=POLL, pool_bind_grace_s=2.0,
                    pool_migration_timeout_s=10.0,
                    slice_repair_poll_s=POLL,
                    slice_repair_backoff_base_s=0.01,
                    slice_repair_backoff_max_s=0.05,
                    slice_repair_timeout_s=5.0)
    defaults.update(overrides)
    return s.Config(**defaults)


def pool_world(s, config=None, with_pool_controller=True,
               boot_delay_s=0.0, window=WINDOW) -> None:
    """The reference's ``PoolWorld`` on stack ``s``: the notebook
    reconciler, the repairer, the pool reconciler (on the case's fake
    clock) and the simulator (node lifecycle on), in that order, and a
    watch that records every replicas value. ``window`` is how far out
    the drains run timed requeues."""
    s.config = config or fast_config(s)
    s.reconciler(wall_clock=s.clock)
    s.repairer(clock=s.clock, rng=random.Random(SEED))
    if with_pool_controller:
        s.pool(clock=s.clock, wall_clock=s.clock)
    s.simulator(boot_delay_s=boot_delay_s, node_grace_s=GRACE)
    s.window = window
    s.replicas_observed = set()

    def observe(ev):
        if ev.type != "DELETED":
            s.replicas_observed.add(s.k8s.get_in(ev.obj, "spec", "replicas"))
    s.store.watch("StatefulSet", observe)


def settle(s) -> int:
    return s.drain(include_delayed_under=s.window)


def tick(s, seconds: float = 0.0) -> None:
    """Advance the fake clock and run the repairer's poll of every
    notebook and the pool reconciler's of every pool, as their timed
    requeues would after ``seconds``."""
    s.clock.advance(seconds)
    for nb in s.store.list(s.api.KIND):
        s.manager.enqueue("slice-repair-controller",
                          s.Request(s.k8s.namespace(nb), s.k8s.name(nb)))
    for pool in s.store.list(s.pool_api.KIND):
        s.manager.enqueue("slice-pool-controller",
                          s.Request("", s.k8s.name(pool)))
    settle(s)


def create_pool(s, name="pool-a", accelerator="v5e-16", warm=2,
                weights=None) -> None:
    s.store.create(s.slice_pool(name, accelerator, warm, weights=weights))


def create_notebook(s, name="nb", ns=NS, accelerator="v5e-16",
                    annotations=None) -> None:
    anns = {s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator(accelerator)}
    anns.update(annotations or {})
    s.store.create(s.api.new_notebook(name, ns, annotations=anns))


def notebook(s, name="nb", ns=NS):
    return s.store.get(s.api.KIND, ns, name)


def annotation(s, key, name="nb", ns=NS):
    return s.k8s.get_annotation(s.store.get_or_none(s.api.KIND, ns, name),
                                key)


def pool_slices(s, state=None) -> list:
    out = []
    for sts in s.store.list("StatefulSet", POOL_NS):
        if s.k8s.get_label(sts, s.names.POOL_LABEL) is None:
            continue
        if state is None or s.k8s.get_annotation(
                sts, s.names.POOL_STATE_ANNOTATION) == state:
            out.append(sts)
    return out


def slice_ready(s, name="nb", ns=NS) -> bool:
    nb = s.store.get_or_none(s.api.KIND, ns, name)
    cond = s.api.get_condition(nb, s.api.CONDITION_SLICE_READY) \
        if nb else None
    return bool(cond and cond.get("status") == "True")


def events(s, reason, ns=NS) -> list:
    return [e for e in s.store.list("Event", ns)
            if e.get("reason") == reason]


def bound_of(s, name="nb", ns=NS):
    return s.pool_api.bound_slice_ref(notebook(s, name, ns))


def pod0(s, bound) -> dict:
    return [p for p in s.pool_api.bound_slice_pods(s.store, bound)
            if s.k8s.get_label(p, "apps.kubernetes.io/pod-index") == "0"][0]


def families(s) -> list[str]:
    """The exposition lines of the pool and migration metric families (a
    scrape: ``slicepool_size`` is computed in it)."""
    out = []
    for line in s.metrics.expose().splitlines():
        name = line.split()[2] if line.startswith("#") else \
            re.split(r"[{ ]", line)[0]
        if any(name == f or name.startswith(f + "_") for f in FAMILIES):
            out.append(line)
    return out


def mark(s, label: str) -> None:
    """A comparison point: the objects and the metric families now."""
    s.marks.append((label, {
        (o["kind"], s.k8s.namespace(o), s.k8s.name(o)): normalise(o, s.side)
        for o in s.store.all_objects()}, families(s)))


def names_of(s, nbs) -> list:
    return [(s.k8s.namespace(n), s.k8s.name(n)) for n in nbs]


# -------------------------------------------------------------- fair share
def fair_share_weighted_max_min_and_fifo(s):
    def nb(ns, name):
        return s.api.new_notebook(name, ns)
    pending = [nb("a", "a1"), nb("a", "a2"), nb("a", "a3"), nb("a", "a4"),
               nb("b", "b1"), nb("b", "b2")]
    admitted, rejected = FAIRNESS[s.side].fair_share_admit(
        pending, {"a": 3, "b": 1}, 4)
    got = names_of(s, admitted)
    # weight 3:1 over 4 grants → a gets 3, b gets 1; FIFO inside each ns
    assert got == [("a", "a1"), ("a", "a2"), ("a", "a3"), ("b", "b1")]
    assert names_of(s, rejected) == [("a", "a4"), ("b", "b2")]
    return {"admitted": got, "rejected": names_of(s, rejected)}


def fair_share_equal_weights_round_robin(s):
    def nb(ns, name):
        return s.api.new_notebook(name, ns)
    pending = [nb("a", "a1"), nb("a", "a2"), nb("b", "b1"), nb("b", "b2")]
    admitted, _ = FAIRNESS[s.side].fair_share_admit(pending, {}, 2)
    assert names_of(s, admitted) == [("a", "a1"), ("b", "b1")]
    return {"admitted": names_of(s, admitted)}


# ----------------------------------------------------------------- warm-up
def pool_warms_to_target_with_slice_identity(s):
    pool_world(s)
    create_pool(s, warm=2)
    settle(s)
    assert len(pool_slices(s, "Warm")) == 2, "pool never warmed to target"
    mark(s, "warm")
    for sts in pool_slices(s, "Warm"):
        name = s.k8s.name(sts)
        assert s.k8s.get_in(sts, "spec", "selector", "matchLabels") == \
            {"statefulset": name}
        assert s.k8s.get_in(sts, "spec", "replicas") == 4
        env = {e["name"]: e.get("value") for e in s.k8s.get_in(
            sts, "spec", "template", "spec", "containers")[0]["env"]
            if "value" in e}
        assert env["TPU_WORKER_HOSTNAMES"].startswith(f"{name}-0.{name}.")
        assert env["TPU_ACCELERATOR_TYPE"] == s.accelerator("v5e-16")
        # the headless Service for worker DNS exists alongside
        assert s.store.get_or_none("Service", POOL_NS, name) is not None
    # pool status mirrors the inventory
    assert s.k8s.get_in(s.store.get(s.pool_api.KIND, "", "pool-a"),
                        "status", "warm") == 2
    return {}


# ------------------------------------------------------------------- bind
def bind_on_create_skips_cold_roll(s):
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    create_notebook(s)
    settle(s)
    assert slice_ready(s), "bind never went Ready"
    mark(s, "bound")
    nb = notebook(s)
    bound = s.pool_api.bound_slice_ref(nb)
    assert bound is not None and bound[0] == POOL_NS
    # NO owned StatefulSet: releasing must hand the slice back intact
    assert s.store.list("StatefulSet", NS) == []
    # identity stamped from the slice's own hostnames
    identity = s.k8s.get_annotation(nb, s.names.SLICE_IDENTITY_ANNOTATION)
    assert identity and identity.split(",")[0].startswith(f"{bound[1]}-0.")
    # PoolBound condition mirrored; Service repointed cross-namespace
    cond = s.api.get_condition(nb, s.api.CONDITION_POOL_BOUND)
    assert cond and cond["status"] == "True"
    svc = s.store.get("Service", NS, "nb")
    assert svc["spec"]["type"] == "ExternalName"
    assert svc["spec"]["externalName"].startswith(f"{bound[1]}.{POOL_NS}.")
    # SliceBound event + bind latency observed
    assert events(s, "SliceBound")
    assert s.metrics.histogram(
        "slicepool_bind_latency_seconds", "").total_count() >= 1
    # bound pods carry the watch-routing labels
    pods = s.pool_api.bound_slice_pods(s.store, bound)
    assert all(s.k8s.get_label(p, s.names.NOTEBOOK_NAME_LABEL) == "nb" and
               s.k8s.get_label(p, s.names.BOUND_NAMESPACE_LABEL) == NS
               for p in pods)
    assert len(pods) == 4
    return {"bound": bound, "identity": identity}


def no_matching_pool_cold_rolls_immediately(s):
    pool_world(s)
    create_pool(s, warm=1, accelerator="v5e-16")
    create_notebook(s, name="cpu-free", accelerator="v5e-8")
    settle(s)
    assert slice_ready(s, "cpu-free")
    # cold path: own StatefulSet, no bind, no miss (no pool ever matched)
    assert s.store.get_or_none("StatefulSet", NS, "cpu-free") is not None
    assert annotation(s, s.names.POOL_BIND_MISS_ANNOTATION,
                      "cpu-free") is None
    return {}


def slow_warming_pool_does_not_bind_timeout(s):
    """A slice warming SLOWER than the core's bind grace must not cost
    the notebook its warm bind: the pool controller's admission heartbeat
    suspends the grace timeout. The slice boots in 1 s of real time
    against a 0.3 s grace; the drain runs the simulator's boot polls and
    the notebook's grace requeues until the slice is Warm and bound."""
    pool_world(s, config=fast_config(s, pool_bind_grace_s=0.3),
               boot_delay_s=1.0, window=0.35)
    # pool and notebook land together: nothing is Warm inside the grace
    # window, only Warming
    create_pool(s, warm=1)
    create_notebook(s)
    settle(s)
    assert slice_ready(s) and s.pool_api.bound_slice_ref(notebook(s)), \
        "never bound the slow-warming slice"
    assert annotation(s, s.names.POOL_BIND_MISS_ANNOTATION) is None, \
        "grace timed out a notebook the pool had admitted"
    # heartbeat cleared once bound
    assert annotation(s, s.names.POOL_BIND_PENDING_ANNOTATION) is None
    return {}


def bind_grace_timeout_cold_rolls_when_pool_controller_down(s):
    # pool CR exists but NO pool controller runs: the core must not wait
    # forever — BindTimeout miss, then the normal cold roll. The gate
    # polls every 20 ms of real time until the 0.2 s grace has passed.
    pool_world(s, config=fast_config(s, pool_bind_grace_s=0.2,
                                     pool_poll_s=0.02),
               with_pool_controller=False, window=0.05)
    s.store.create(s.slice_pool("pool-a", "v5e-16", 1))
    create_notebook(s)
    settle(s)
    assert slice_ready(s), "never cold-rolled"
    assert annotation(s, s.names.POOL_BIND_MISS_ANNOTATION) == "BindTimeout"
    assert s.store.get_or_none("StatefulSet", NS, "nb") is not None
    return {}


# -------------------------------------------------------------- contention
def contended_pool_fair_share_losers_cold_roll(s):
    pool_world(s)
    create_pool(s, warm=2, weights={"ns-a": 1, "ns-b": 1})
    settle(s)
    assert len(pool_slices(s, "Warm")) == 2
    for i in range(2):
        create_notebook(s, f"a{i}", ns="ns-a")
        create_notebook(s, f"b{i}", ns="ns-b")
    settle(s)
    mark(s, "admitted")

    def settled():
        states = []
        for ns, name in (("ns-a", "a0"), ("ns-a", "a1"),
                         ("ns-b", "b0"), ("ns-b", "b1")):
            anns = s.k8s.annotations(
                s.store.get_or_none(s.api.KIND, ns, name)) or {}
            if s.names.BOUND_SLICE_ANNOTATION in anns:
                states.append("bound")
            elif s.names.POOL_BIND_MISS_ANNOTATION in anns:
                states.append("miss")
            else:
                return None
        return states
    states = settled()
    assert states is not None, "admission never ran"
    assert states.count("bound") == 2 and states.count("miss") == 2
    # equal weights → one bind per namespace, the FIFO head of each
    assert states[0] == "bound" and states[2] == "bound"
    # everyone still reaches SliceReady (losers by cold roll)
    assert all(slice_ready(s, n, ns) for ns, n in
               (("ns-a", "a0"), ("ns-a", "a1"), ("ns-b", "b0"),
                ("ns-b", "b1")))
    assert s.metrics.counter(
        "slicepool_bind_misses_total", "").sum_where(
        {"reason": "PoolContended"}) == 2
    assert events(s, "PoolBindMiss", "ns-a") or \
        events(s, "PoolBindMiss", "ns-b")
    return {"states": states}


# -------------------------------------------------------- release / rebind
def stop_releases_slice_back_to_pool_scrubbed(s):
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    bound = bound_of(s)
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-08-04T00:00:00Z"}}})
    settle(s)
    mark(s, "released")
    assert s.pool_api.bound_slice_ref(notebook(s)) is None, "never unbound"
    # released, NOT deleted — and scrubbed back to Warm
    assert s.k8s.get_annotation(
        s.store.get_or_none("StatefulSet", *bound) or {},
        s.names.POOL_STATE_ANNOTATION) == "Warm", "never re-warmed"
    sts = s.store.get("StatefulSet", *bound)
    assert s.names.NOTEBOOK_NAME_LABEL not in (s.k8s.labels(sts) or {})
    assert s.k8s.get_annotation(sts, s.names.POOL_BOUND_TO_ANNOTATION) \
        is None
    assert events(s, "SliceReleased")
    # the stopped notebook's Service must NOT keep routing into the
    # released slice: the core flips it back to the endpoint-less cold
    # selector shape
    assert s.store.get("Service", NS, "nb")["spec"].get("type") != \
        "ExternalName", "stale ExternalName kept routing into the slice"
    # resume: stripping the stop annotation re-binds a warm slice again
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: None}}})
    settle(s)
    assert slice_ready(s) and s.pool_api.bound_slice_ref(notebook(s))
    assert s.store.list("StatefulSet", NS) == []  # still no cold STS
    return {"bound": bound}


def notebook_deletion_releases_slice(s):
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    bound = bound_of(s)
    s.store.delete(s.api.KIND, NS, "nb")
    settle(s)
    assert s.k8s.get_annotation(
        s.store.get_or_none("StatefulSet", *bound) or {},
        s.names.POOL_STATE_ANNOTATION) == "Warm", \
        "slice not released after notebook deletion"
    return {}


def half_bind_crash_heals_from_slice_side(s):
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm"), "never warm"
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    bound = bound_of(s)
    # simulate the crash window: the slice knows the notebook, the
    # notebook lost its annotation (e.g. restored from backup)
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.BOUND_SLICE_ANNOTATION: None}}})
    settle(s)
    assert bound_of(s) == bound, "bind never healed from the slice side"
    return {}


# -------------------------------------------------------------- migration
def preemption_migrates_bound_notebook_with_identity(s):
    pool_world(s)
    create_pool(s, warm=2)  # capacity 2: one bound + one warm spare
    settle(s)
    assert len(pool_slices(s, "Warm")) == 2
    create_notebook(s, annotations={s.names.RUNTIME_STEP_ANNOTATION: "4242"})
    settle(s)
    assert slice_ready(s)
    nb = notebook(s)
    old_bound = s.pool_api.bound_slice_ref(nb)
    identity = s.k8s.get_annotation(nb, s.names.SLICE_IDENTITY_ANNOTATION)
    node = pod0(s, old_bound)["spec"]["nodeName"]
    s.kubelet.preempt_node(s.store, node)
    s.kubelet.kill_node(s.store, node)
    settle(s)
    mark(s, "migrated")

    nb = notebook(s)
    b = s.pool_api.bound_slice_ref(nb)
    assert b is not None and b != old_bound and s.k8s.get_annotation(
        nb, s.names.MIGRATION_STATE_ANNOTATION) is None and slice_ready(s), \
        "never migrated to the warm spare"
    # identity preserved end to end: annotation AND the new pods' env
    assert s.k8s.get_annotation(nb, s.names.SLICE_IDENTITY_ANNOTATION) == \
        identity
    new_bound = s.pool_api.bound_slice_ref(nb)
    for pod in s.pool_api.bound_slice_pods(s.store, new_bound):
        env = {e["name"]: e.get("value")
               for e in pod["spec"]["containers"][0].get("env", [])}
        assert env.get("TPU_WORKER_HOSTNAMES") == identity
    # checkpoint step continuity, no quarantine, no cold roll
    assert s.k8s.get_annotation(nb, s.names.RESUMED_STEP_ANNOTATION) == \
        "4242"
    assert s.k8s.get_annotation(nb, s.names.QUARANTINE_ANNOTATION) is None
    assert s.k8s.get_annotation(nb, s.names.POOL_BIND_MISS_ANNOTATION) \
        is None
    assert s.store.list("StatefulSet", NS) == []
    assert events(s, "NotebookMigrated")
    assert s.metrics.counter("notebook_migrations_total", "").sum_where(
        {"outcome": "success"}) == 1
    # the consumed slice left the Bound state: drained (deleted — doomed
    # capacity) or scrubbed back toward Warm; either way the pool holds a
    # warm spare again
    sts = s.store.get_or_none("StatefulSet", *old_bound)
    assert sts is None or s.k8s.get_annotation(
        sts, s.names.POOL_BOUND_TO_ANNOTATION) is None, \
        "consumed slice never drained/released"
    assert len(pool_slices(s, "Warm")) >= 1, \
        "pool never re-warmed after the migration"
    # slice atomicity held throughout: replicas only ever 0 or full
    assert s.replicas_observed <= {0, 4}
    return {"old": old_bound, "new": new_bound, "identity": identity,
            "replicas": sorted(s.replicas_observed)}


def failed_migration_falls_back_to_cold_roll(s):
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    s.config.pool_migration_timeout_s = 0.5
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    old_bound = bound_of(s)
    # zero the capacity target: the drained slice will NOT be replaced,
    # so the migration genuinely has nowhere warm to land
    pool = s.store.get(s.pool_api.KIND, "", "pool-a")
    pool["spec"]["warmReplicas"] = 0
    s.store.update(pool)
    settle(s)
    s.kubelet.kill_node(s.store, pod0(s, old_bound)["spec"]["nodeName"])
    settle(s)
    mark(s, "fell back")
    nb = notebook(s)
    assert s.k8s.get_annotation(nb, s.names.POOL_BIND_MISS_ANNOTATION) \
        is not None and s.k8s.get_annotation(
            nb, s.names.MIGRATION_STATE_ANNOTATION) is None, \
        "migration never fell back"
    # the notebook is NOT lost: it cold-rolls its own StatefulSet and the
    # repair machinery owns it from here
    assert slice_ready(s) and s.store.get_or_none(
        "StatefulSet", NS, "nb") is not None, \
        "fallback cold roll never converged"
    assert s.metrics.counter("notebook_migrations_total", "").sum_where(
        {"outcome": "fallback"}) == 1
    assert events(s, "NotebookMigrationFallback")
    return {"miss": s.k8s.get_annotation(
        nb, s.names.POOL_BIND_MISS_ANNOTATION)}


def contention_spills_to_other_matching_pool(s):
    """Fair-share losers in the first-fit pool must NOT eat a permanent
    miss while another matching pool has spare capacity: they stay
    pending and bind warm once first-fit moves past the exhausted pool."""
    pool_world(s)
    create_pool(s, "pool-a", warm=1)
    create_pool(s, "pool-b", warm=2)
    settle(s)
    assert len(pool_slices(s, "Warm")) == 3
    for i in range(3):
        create_notebook(s, f"s{i}")
    settle(s)
    mark(s, "spilled")
    assert all(s.pool_api.bound_slice_ref(
        s.store.get_or_none(s.api.KIND, NS, f"s{i}") or {})
        for i in range(3)), \
        "contention losers never spilled into the second pool"
    for i in range(3):
        assert annotation(s, s.names.POOL_BIND_MISS_ANNOTATION,
                          f"s{i}") is None
    pools_used = {annotation(s, s.names.BOUND_POOL_ANNOTATION, f"s{i}")
                  for i in range(3)}
    assert pools_used == {"pool-a", "pool-b"}
    return {"pools": sorted(pools_used)}


def same_pass_release_is_biddable_capacity(s):
    """A slice released in the same reconcile pass (tenant stopped) must
    count as capacity for pending notebooks. Driven as ONE deterministic
    reconcile pass."""
    s.pool_api.install_slicepool_crd(s.store)
    s.store.create(s.slice_pool("p1", "v5e-16", 1))
    s.store.create({
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": "p1-w0", "namespace": POOL_NS,
                     "labels": {s.names.POOL_LABEL: "p1",
                                "statefulset": "p1-w0"},
                     "annotations": {
                         s.names.POOL_STATE_ANNOTATION: "Bound",
                         s.names.POOL_BOUND_TO_ANNOTATION:
                             f"{NS}/stopped"}},
        "spec": {"replicas": 4, "selector": {"matchLabels": {
            "statefulset": "p1-w0"}},
            "template": {"metadata": {}, "spec": {"containers": [
                {"name": "warm-slice", "image": "img"}]}}}})
    s.store.create(s.api.new_notebook("stopped", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.BOUND_SLICE_ANNOTATION: f"{POOL_NS}/p1-w0",
        s.names.BOUND_POOL_ANNOTATION: "p1",
        s.names.STOP_ANNOTATION: "t"}))
    s.store.create(s.api.new_notebook("waiting", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    rec = s.SlicePoolReconciler(s.store, fast_config(s), s.metrics,
                                clock=s.clock, wall_clock=s.clock)
    rec.reconcile(s.Request("", "p1"))
    waiting = s.store.get(s.api.KIND, NS, "waiting")
    assert s.k8s.get_annotation(
        waiting, s.names.POOL_BIND_MISS_ANNOTATION) is None, \
        "same-pass release was not counted as biddable capacity"
    return {}


def contended_pool_migration_rebind_wins_over_new_create(s):
    """A migration re-bind holds first claim on a contended pool's warm
    slice even when fair-share tie-breaking would favor the new create's
    namespace."""
    s.pool_api.install_slicepool_crd(s.store)
    s.store.create(s.slice_pool("p1", "v5e-16", 1))
    rec = s.SlicePoolReconciler(s.store, fast_config(s), s.metrics,
                                clock=s.clock, wall_clock=s.clock)
    rec.reconcile(s.Request("", "p1"))  # creates the warm slice
    sts = s.store.list("StatefulSet", POOL_NS)[0]
    s.store.patch("StatefulSet", POOL_NS, s.k8s.name(sts), {"metadata": {
        "annotations": {s.names.POOL_STATE_ANNOTATION: "Warm"}}})
    # 'alpha' sorts before 'zeta': plain fair share would admit it first
    s.store.create(s.api.new_notebook("fresh", "alpha", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.store.create(s.api.new_notebook("moving", "zeta", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.MIGRATION_STATE_ANNOTATION: "Binding",
        s.names.SLICE_IDENTITY_ANNOTATION: "localhost"}))
    rec._pending_dirty.add("p1")  # what the Notebook-watch mapper would do
    rec.reconcile(s.Request("", "p1"))
    moving = s.store.get(s.api.KIND, "zeta", "moving")
    assert s.pool_api.bound_slice_ref(moving) is not None, \
        "migration re-bind lost the contended slice to a new create"
    fresh = s.store.get(s.api.KIND, "alpha", "fresh")
    assert s.k8s.get_annotation(fresh, s.names.POOL_BIND_MISS_ANNOTATION) \
        is not None
    return {}


def runtime_step_never_churns_cold_template(s):
    """runtime-step updates must not propagate into the StatefulSet pod
    template — each update would be spurious drift and roll the slice."""
    rec = s.NotebookReconciler(s.store)
    nb = s.api.new_notebook("nb", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.RUNTIME_STEP_ANNOTATION: "500",
        s.names.CHECKPOINT_TOKEN_ANNOTATION: "{}"})
    sts = rec.generate_statefulset(
        nb, TOPOLOGY[s.side].parse_short_name(s.accelerator("v5e-16")),
        actual_sts_name="nb")
    tmpl_anns = s.k8s.get_in(sts, "spec", "template", "metadata",
                             "annotations", default={}) or {}
    assert s.names.RUNTIME_STEP_ANNOTATION not in tmpl_anns
    assert s.names.CHECKPOINT_TOKEN_ANNOTATION not in tmpl_anns
    return {"sts": normalise(sts, s.side)}


def migration_window_service_not_routed_into_old_slice(s):
    """Between unbind and re-bind the notebook's Service must NOT keep
    the ExternalName route into the old slice: the core repoints it to
    the endpoint-less cold selector shape and mirrors
    PoolBound=False/Migrating."""
    rec = s.NotebookReconciler(s.store, fast_config(s))
    s.store.create(s.api.new_notebook("mignb", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.MIGRATION_STATE_ANNOTATION: "Binding",
        s.names.SLICE_IDENTITY_ANNOTATION: "localhost"}))
    # stale Service left over from the pre-migration bind
    s.store.create({
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "mignb", "namespace": NS,
                     "labels": {s.names.NOTEBOOK_NAME_LABEL: "mignb"}},
        "spec": {"type": "ExternalName",
                 "externalName": f"old-slice.{POOL_NS}.svc.cluster.local",
                 "ports": []}})
    rec.reconcile(s.Request(NS, "mignb"))
    svc = s.store.get("Service", NS, "mignb")
    assert svc["spec"].get("type") != "ExternalName"
    assert svc["spec"].get("selector") == {"statefulset": "mignb"}
    nb = s.store.get(s.api.KIND, NS, "mignb")
    cond = s.api.get_condition(nb, s.api.CONDITION_POOL_BOUND)
    assert cond and cond["status"] == "False" and \
        cond["reason"] == "Migrating"
    # the gate still holds the cold roll: no owned StatefulSet appeared
    assert s.store.list("StatefulSet", NS) == []
    return {}


# ------------------------------------------------------------- validation
def slicepool_admission_rejects_bad_specs(s):
    s.pool_api.install_slicepool_crd(s.store)
    s.store.create(s.slice_pool("ok", "v5e-16", 2))
    rejected = []
    for pool in (
            s.pool_api.new_slice_pool("bad-acc", BAD_ACCELERATOR[s.side], 1),
            s.slice_pool("bad-warm", "v5e-16", -1),
            s.slice_pool("bad-weights", "v5e-16", 1, weights={"ns": 0})):
        with pytest.raises(INVALID[s.side]) as exc:
            s.store.create(pool)
        rejected.append((exc.value.code, exc.value.message.split(":")[0]))
    return {"rejected": rejected}


def pool_deletion_reaps_unbound_slices(s):
    pool_world(s)
    create_pool(s, warm=2)
    settle(s)
    assert len(pool_slices(s, "Warm")) == 2
    s.store.delete(s.pool_api.KIND, "", "pool-a")
    settle(s)
    assert not pool_slices(s), \
        "unbound warm slices not reaped with their pool"
    return {}


def pool_deletion_with_bound_slice_reaps_on_release(s):
    """Deleting a pool while a notebook is bound must keep serving it —
    and once the notebook stops, the orphaned slice is DELETED (there is
    no pool to re-warm into), never leaked."""
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    bound = bound_of(s)
    s.store.delete(s.pool_api.KIND, "", "pool-a")
    settle(s)      # the teardown pass runs; the bound slice survives it
    mark(s, "torn down")
    assert s.store.get_or_none("StatefulSet", *bound) is not None, \
        "pool deletion killed a slice still serving a notebook"
    assert slice_ready(s)
    s.store.patch(s.api.KIND, NS, "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-08-04T00:00:00Z"}}})
    settle(s)
    assert s.store.get_or_none("StatefulSet", *bound) is None, \
        "orphaned slice leaked after its notebook stopped"
    assert s.pool_api.bound_slice_ref(notebook(s)) is None, \
        "stopped notebook left annotated bound"
    return {}


def raised_target_creates_replacements_despite_bound_slices(s):
    """warmReplicas is capacity: with 1 bound slice and the target raised
    to 3, the pool must create 2 MORE slices."""
    pool_world(s)
    create_pool(s, warm=1)
    settle(s)
    assert pool_slices(s, "Warm")
    create_notebook(s)
    settle(s)
    assert slice_ready(s)
    pool = s.store.get(s.pool_api.KIND, "", "pool-a")
    pool["spec"]["warmReplicas"] = 3
    s.store.update(pool)
    settle(s)
    assert len(pool_slices(s)) == 3 and len(pool_slices(s, "Warm")) == 2, \
        "raised target did not rebuild to capacity"
    return {"slices": sorted(s.k8s.name(x) for x in pool_slices(s))}


CASES = {fn.__name__: fn for fn in (
    fair_share_weighted_max_min_and_fifo,
    fair_share_equal_weights_round_robin,
    pool_warms_to_target_with_slice_identity,
    bind_on_create_skips_cold_roll,
    no_matching_pool_cold_rolls_immediately,
    slow_warming_pool_does_not_bind_timeout,
    bind_grace_timeout_cold_rolls_when_pool_controller_down,
    contended_pool_fair_share_losers_cold_roll,
    stop_releases_slice_back_to_pool_scrubbed,
    notebook_deletion_releases_slice,
    half_bind_crash_heals_from_slice_side,
    preemption_migrates_bound_notebook_with_identity,
    failed_migration_falls_back_to_cold_roll,
    contention_spills_to_other_matching_pool,
    same_pass_release_is_biddable_capacity,
    contended_pool_migration_rebind_wins_over_new_create,
    runtime_step_never_churns_cold_template,
    migration_window_service_not_routed_into_old_slice,
    slicepool_admission_rejects_bad_specs,
    pool_deletion_reaps_unbound_slices,
    pool_deletion_with_bound_slice_reaps_on_release,
    raised_target_creates_replacements_despite_bound_slices)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slicepool_case_through_both_stacks(case):
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


def test_warm_slices_roll_an_image_that_drives_h100():
    """Every warm slice's template and every pool pod, bound ones too,
    carry the port's CUDA default image; the reference's JAX default is
    one the port's webhook would swap out."""
    images = {}
    for s in (Stack("ref"), Stack("port")):
        s.clock, s.marks = FakeClock(), []
        bind_on_create_skips_cold_roll(s)
        templates = [c["image"] for sts in pool_slices(s) for c in
                     s.k8s.get_in(sts, "spec", "template", "spec",
                                  "containers")]
        pods = [c["image"] for p in s.store.list("Pod", POOL_NS)
                for c in p["spec"]["containers"]]
        assert templates and len(pods) == 4 * len(pool_slices(s))
        images[s.side] = set(templates + pods)
    assert images["port"] == {ControllerConfig().tpu_default_image}
    assert not _cannot_drive_h100(ControllerConfig().tpu_default_image)
    assert images["ref"] == {RefConfig().tpu_default_image}
    assert _cannot_drive_h100(RefConfig().tpu_default_image)


# ------------------------------------------------ utils/fairness.py, seeded
def _random_pending(rng, api):
    namespaces = [f"ns-{i}" for i in range(int(rng.integers(1, 5)))]
    return [api.new_notebook(f"nb-{i}", str(rng.choice(namespaces)))
            for i in range(int(rng.integers(0, 12)))], namespaces


@pytest.mark.parametrize("fn", ["fair_share_admit", "first_fit_pack"])
def test_fairness_matches_the_reference_on_seeded_inputs(fn):
    """300 inputs drawn from one seed: both packages' outputs equal."""
    rng = np.random.default_rng(SEED)
    ref_stack, port_stack = Stack("ref"), Stack("port")
    for _ in range(300):
        if fn == "fair_share_admit":
            state = rng.bit_generator.state
            pending_ref, namespaces = _random_pending(rng, ref_stack.api)
            rng.bit_generator.state = state
            pending_port, _ = _random_pending(rng, port_stack.api)
            weights = {ns: int(rng.integers(1, 6)) for ns in namespaces
                       if rng.random() < 0.6}
            capacity = int(rng.integers(0, len(pending_ref) + 3))
            want = ref_fairness.fair_share_admit(pending_ref, weights,
                                                 capacity)
            have = fairness.fair_share_admit(pending_port, weights, capacity)
            assert [names_of(port_stack, part) for part in have] == \
                [names_of(ref_stack, part) for part in want]
        else:
            bins = {f"h100-{int(c)}": int(rng.integers(0, 4))
                    for c in rng.choice([1, 2, 4, 8, 16, 32],
                                        size=int(rng.integers(0, 5)))}
            requests = [(f"gang-{i}", int(rng.integers(1, 4)))
                        for i in range(int(rng.integers(0, 10)))]
            want = ref_fairness.first_fit_pack(requests, dict(bins))
            have = fairness.first_fit_pack(requests, bins)
            assert have == want
