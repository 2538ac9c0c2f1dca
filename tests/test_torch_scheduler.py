"""The port's fleet scheduler and TPUQuota API held against the
reference's, case for case.

Every case of tests/test_scheduler.py runs through both stacks
(``torch_parity.Stack``: store, Manager, NotebookReconciler,
SliceRepairReconciler, SchedulerReconciler and the StatefulSet simulator
with its node lifecycle), each side with the case's own assertions. The
v5e-16 request maps to h100-32 (four workers on both sides) and the
topology-bin case's v5e-32 pool to an h100-64 one (eight workers).

Both sides run on one fake clock, set back to the same start before each
side's run: the scheduler's ``wall_clock`` (the ``sched-enqueued-at`` and
preemption ``resize-started-at`` epochs, and so the gang wait), the
repairer's ``clock`` and the notebook reconciler's ``wall_clock``; each
side's repairer gets ``random.Random(SEED)``. The scheduler's and the
repairer's polls (``sched_poll_s``, ``slice_repair_poll_s``) are set far
beyond any drain's window, so only a watch event or ``tick`` (advance
the clock, enqueue both controllers for every notebook) runs them; where
the reference waits on wall time, the case ticks until its condition
holds and returns the number of ticks it took. The preemption cases
drive each package's own ``SimulatedElasticAgent`` with ``poll_once``
between ticks. The two dead-scheduler grace cases wait on real time as
the reference's do, bounded: the notebook gate's ``time.monotonic``
grace of 0.2 s.

At the points each case marks, every object of both stores is compared
after ``normalise``, and so are the ``scheduler_*`` and
``elastic_resizes_total`` families, exposition line for line. No case
sleeps and no manager is started.

Last, the usage helpers (``gang_slices``, ``tier_of``,
``elastic_current``, ``elastic_held``, ``reserved_slices``,
``notebook_usage``) of both packages on 500 annotation sets drawn with
numpy from a seed, and ``validate_tpu_quota``, ``tenant_quota`` and the
CRD of both packages: equal outputs, exactly.
"""

from __future__ import annotations

import random
import re

import numpy as np
import pytest

from kubeflow_tpu.api import tpuquota as ref_quota_api
from kubeflow_tpu.cluster.errors import InvalidError as RefInvalidError
from kubeflow_tpu.controllers import scheduler as ref_scheduler
from kubeflow_tpu.deploy.manifests import tpuquota_crd as ref_tpuquota_crd
from kubeflow_tpu.runtime import elastic as ref_elastic
from kubeflow_tpu.utils import names as ref_names
from kubeflow_tpu_torch.api import tpuquota as quota_api
from kubeflow_tpu_torch.cluster.errors import InvalidError
from kubeflow_tpu_torch.controllers import scheduler
from kubeflow_tpu_torch.runtime import elastic
from kubeflow_tpu_torch.utils import names
from torch_parity import Stack, normalise

NS = "sched-ns"
SEED = 18
T0 = 1_000_000.0
POLL = 3600.0          # the scheduler's and the repairer's polls: never due
GRACE = 0.005          # the simulator's NotReady -> eviction window
WINDOW = 0.02          # timed requeues a drain runs (the simulator's)
TICK = 0.02            # the reference's fast sched_poll_s, on the fake clock
FAMILIES = ("scheduler_admissions_total", "scheduler_preemptions_total",
            "scheduler_gang_wait_seconds", "scheduler_quota_used",
            "elastic_resizes_total")
ELASTIC = {"ref": ref_elastic, "port": elastic}
INVALID = {"ref": RefInvalidError, "port": InvalidError}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def fast_config(s, **overrides):
    """tests/test_scheduler.py's ``fast_config`` with the scheduler's and
    the repairer's polls out of a drain's reach."""
    defaults = dict(sched_poll_s=POLL,
                    sched_admission_grace_s=0.4,
                    sched_default_capacity=4,
                    slice_repair_backoff_base_s=0.01,
                    slice_repair_backoff_max_s=0.05,
                    slice_repair_poll_s=POLL)
    defaults.update(overrides)
    return s.Config(**defaults)


def sched_world(s, config=None, with_scheduler=True,
                window=WINDOW) -> None:
    """The reference's ``SchedWorld`` on stack ``s``: the TPUQuota and
    SlicePool CRDs, the notebook reconciler, the repairer, the scheduler
    (all on the case's fake clock) and the simulator, in that order."""
    s.config = config or fast_config(s)
    s.quota_api.install_tpuquota_crd(s.store)
    s.pool_api.install_slicepool_crd(s.store)
    s.reconciler(wall_clock=s.clock)
    s.repairer(clock=s.clock, rng=random.Random(SEED))
    s.sched = s.scheduler(wall_clock=s.clock) if with_scheduler else None
    s.simulator(node_grace_s=GRACE)
    s.window = window


def settle(s, timeout: float = 10.0) -> int:
    return s.drain(include_delayed_under=s.window, timeout=timeout)


def tick(s, seconds: float = TICK) -> None:
    """Advance the fake clock and run the scheduler's and the repairer's
    polls of every notebook, as their timed requeues would."""
    s.clock.advance(seconds)
    for nb in s.store.list(s.api.KIND):
        req = s.Request(s.k8s.namespace(nb), s.k8s.name(nb))
        s.manager.enqueue("slice-repair-controller", req)
        s.manager.enqueue("fleet-scheduler", req)
    settle(s)


def wait(s, cond, agent=None, turns: int = 40) -> int:
    """The reference's ``world.wait`` on the fake clock: tick (the agent
    polling first, if one runs) until ``cond`` holds; the ticks it
    took."""
    settle(s)
    for turn in range(turns):
        if cond():
            return turn
        if agent is not None:
            agent.poll_once()
        tick(s)
    assert cond(), f"not within {turns} ticks"
    return turns


def create_gang(s, name, slices, tier=None, ns=NS,
                accelerator="v5e-16") -> None:
    annotations = {s.names.TPU_ACCELERATOR_ANNOTATION:
                   s.accelerator(accelerator),
                   s.names.SCHED_GANG_ANNOTATION: str(slices)}
    if tier is not None:
        annotations[s.names.SCHED_TIER_ANNOTATION] = tier
    s.store.create(s.api.new_notebook(name, ns, annotations=annotations))


def create_elastic(s, name="train", slices=3, ns=NS) -> None:
    s.store.create(s.api.new_notebook(name, ns, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.ELASTIC_ANNOTATION: "true",
        s.names.ELASTIC_SLICES_ANNOTATION: str(slices),
        s.names.ELASTIC_CURRENT_SLICES_ANNOTATION: str(slices),
    }))


def notebook(s, name, ns=NS):
    return s.store.get(s.api.KIND, ns, name)


def state(s, name, ns=NS):
    return s.scheduler_mod.sched_state(notebook(s, name, ns))


def anno(s, name, annotation, ns=NS):
    return s.k8s.get_annotation(notebook(s, name, ns), annotation)


def set_anno(s, name, annotations, ns=NS) -> None:
    s.store.patch(s.api.KIND, ns, name,
                  {"metadata": {"annotations": annotations}})


def rolled(s, name, ns=NS) -> bool:
    return bool(s.store.list("StatefulSet", ns,
                             {s.names.NOTEBOOK_NAME_LABEL: name}))


def reasons(s, ns=NS) -> set:
    return {e["reason"] for e in s.store.list("Event", ns)}


def counter(s, family, labels) -> float:
    return s.metrics.counter(family, "").get(labels)


def outcome(s, what, ns=NS) -> float:
    return counter(s, "scheduler_admissions_total",
                   {"tenant": ns, "outcome": what})


def families(s) -> list[str]:
    """The exposition lines of the scheduler and elastic metric families
    (a scrape: ``scheduler_quota_used`` is computed in it)."""
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


# --------------------------------------------------------------- admission
def gang_admission_two_phase_then_roll(s):
    sched_world(s)
    create_gang(s, "g1", 2, tier="interactive")
    settle(s)
    assert state(s, "g1") == s.scheduler_mod.SCHED_ADMITTED, \
        "gang never admitted"
    assert anno(s, "g1", s.names.SCHED_RESERVED_ANNOTATION) == "2"
    assert anno(s, "g1", s.names.SCHED_ENQUEUED_AT_ANNOTATION) == \
        "%.3f" % T0
    assert rolled(s, "g1"), "admitted gang never rolled its StatefulSet"
    assert "GangAdmitted" in reasons(s)
    assert outcome(s, "admitted") >= 1
    assert s.metrics.histogram(
        "scheduler_gang_wait_seconds", "").total_count() >= 1
    assert s.scheduler_mod.notebook_usage(notebook(s, "g1")) == 2
    mark(s, "admitted")
    return {"admitted": outcome(s, "admitted")}


def non_gang_notebook_bypasses_the_scheduler(s):
    sched_world(s)
    s.store.create(s.api.new_notebook("plain", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    settle(s)
    assert rolled(s, "plain")
    assert state(s, "plain") is None
    return {}


def quota_denies_until_quota_lifted(s):
    sched_world(s)
    s.store.create(s.quota("cap", NS, 1))
    create_gang(s, "g1", 2)
    turns = wait(s, lambda: outcome(s, "quota-denied") >= 2)
    assert state(s, "g1") == s.scheduler_mod.SCHED_PENDING
    assert not rolled(s, "g1")
    mark(s, "denied")

    s.store.delete(s.quota_api.KIND, "", "cap")
    lifted = wait(s, lambda: state(s, "g1") ==
                  s.scheduler_mod.SCHED_ADMITTED)
    assert rolled(s, "g1")
    return {"turns": turns, "lifted": lifted}


def min_quota_wins_across_duplicates(s):
    sched_world(s)
    s.store.create(s.quota("cap-a", NS, 3))
    s.store.create(s.quota("cap-b", NS, 1))
    settle(s)
    assert s.sched._tenant_quota(NS) == 1
    assert s.quota_api.tenant_quota(s.store, NS) == 1
    assert s.quota_api.tenant_quota(s.store, "other-ns") is None
    return {}


def capacity_blocks_second_gang_until_release(s):
    sched_world(s)
    create_gang(s, "g1", 3)
    first = wait(s, lambda: state(s, "g1") ==
                 s.scheduler_mod.SCHED_ADMITTED)
    create_gang(s, "g2", 2)
    turns = wait(s, lambda: outcome(s, "no-capacity") >= 2)
    assert state(s, "g2") == s.scheduler_mod.SCHED_PENDING
    mark(s, "blocked")

    set_anno(s, "g1", {s.names.SCHED_GANG_ANNOTATION: None})
    released = wait(s, lambda: state(s, "g2") ==
                    s.scheduler_mod.SCHED_ADMITTED)
    assert state(s, "g1") is None
    assert anno(s, "g1", s.names.SCHED_RESERVED_ANNOTATION) is None
    assert "GangReleased" in reasons(s)
    return {"first": first, "turns": turns, "released": released}


def gang_fits_requires_one_topology_bin(s):
    sched_world(s)
    s.store.create(s.slice_pool("pool-a", "v5e-16", 2))
    s.store.create(s.slice_pool("pool-b", "v5e-32", 2))
    create_gang(s, "wide", 3)
    turns = wait(s, lambda: outcome(s, "no-capacity") >= 2)
    assert state(s, "wide") == s.scheduler_mod.SCHED_PENDING
    mark(s, "wide refused")
    create_gang(s, "narrow", 2)
    narrow = wait(s, lambda: state(s, "narrow") ==
                  s.scheduler_mod.SCHED_ADMITTED)
    assert state(s, "wide") == s.scheduler_mod.SCHED_PENDING
    return {"turns": turns, "narrow": narrow}


# ----------------------------------------------------------- crash recovery
def reserving_state_found_at_startup_converges_to_admitted(s):
    sched_world(s)
    s.store.create(s.api.new_notebook("crashed", NS, annotations={
        s.names.SCHED_GANG_ANNOTATION: "2",
        s.names.SCHED_STATE_ANNOTATION: s.scheduler_mod.SCHED_RESERVING,
        s.names.SCHED_RESERVED_ANNOTATION: "2",
        s.names.SCHED_ENQUEUED_AT_ANNOTATION: "%.3f" % s.clock(),
    }))
    turns = wait(s, lambda: state(s, "crashed") ==
                 s.scheduler_mod.SCHED_ADMITTED)
    return {"turns": turns}


def stale_reservation_over_capacity_reverts(s):
    sched_world(s)
    create_elastic(s, "train", slices=3)
    s.store.create(s.api.new_notebook("crashed", NS, annotations={
        s.names.SCHED_GANG_ANNOTATION: "2",
        s.names.SCHED_TIER_ANNOTATION: "training",
        s.names.SCHED_STATE_ANNOTATION: s.scheduler_mod.SCHED_RESERVING,
        s.names.SCHED_RESERVED_ANNOTATION: "2",
    }))
    turns = wait(s, lambda: state(s, "crashed") ==
                 s.scheduler_mod.SCHED_PENDING and
                 anno(s, "crashed", s.names.SCHED_RESERVED_ANNOTATION)
                 is None)
    assert outcome(s, "reverted") >= 1
    assert "GangReservationReverted" in reasons(s)
    mark(s, "reverted")
    return {"turns": turns}


# --------------------------------------------------------------- preemption
def interactive_gang_preempts_training_through_elastic_handshake(s):
    sched_world(s)
    create_elastic(s, "train", slices=3)
    settle(s)
    assert rolled(s, "train")
    agent = ELASTIC[s.side].SimulatedElasticAgent(s.store, NS, "train",
                                                  current_slices=3)
    create_gang(s, "burst", 2, tier="interactive")
    # the scheduler stamps the victim's drain + the grow-back hold
    held = wait(s, lambda: anno(s, "train",
                                s.names.SCHED_PREEMPTED_ANNOTATION) ==
                f"{NS}/burst", agent)
    mark(s, "preempting")
    drained = wait(s, lambda: agent.current == 2, agent)
    admitted = wait(s, lambda: state(s, "burst") ==
                    s.scheduler_mod.SCHED_ADMITTED, agent)
    assert counter(s, "scheduler_preemptions_total",
                   {"tier": "training", "outcome": "scheduled"}) >= 1
    assert "GangPreempting" in reasons(s)
    mark(s, "admitted")
    # the hold keeps the repair controller from growing back while the
    # preemptor is entitled to the capacity
    for _ in range(10):
        agent.poll_once()
        tick(s)
    assert agent.current == 2

    set_anno(s, "burst", {s.names.SCHED_GANG_ANNOTATION: None})
    swept = wait(s, lambda: anno(s, "train",
                                 s.names.SCHED_PREEMPTED_ANNOTATION) is None,
                 agent)
    grown = wait(s, lambda: agent.current == 3, agent)
    assert agent.violations == []
    assert agent.resizes == 2
    assert counter(s, "scheduler_preemptions_total",
                   {"tier": "training", "outcome": "released"}) >= 1
    assert "GangPreemptionReleased" in reasons(s)
    mark(s, "grown back")
    return {"held": held, "drained": drained, "admitted": admitted,
            "swept": swept, "grown": grown, "steps": agent.steps,
            "losses": agent.losses}


def gang_admitted_elastic_victim_reservation_yields_to_preemption(s):
    sched_world(s)
    s.store.create(s.api.new_notebook("train", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.ELASTIC_ANNOTATION: "true",
        s.names.ELASTIC_SLICES_ANNOTATION: "4",
        s.names.SCHED_GANG_ANNOTATION: "4",
        s.names.SCHED_TIER_ANNOTATION: "training",
    }))
    first = wait(s, lambda: state(s, "train") ==
                 s.scheduler_mod.SCHED_ADMITTED)
    assert anno(s, "train", s.names.SCHED_RESERVED_ANNOTATION) == "4"
    agent = ELASTIC[s.side].SimulatedElasticAgent(s.store, NS, "train",
                                                  current_slices=4)
    create_gang(s, "urgent", 1, tier="interactive")
    drained = wait(s, lambda: agent.current == 3, agent)
    admitted = wait(s, lambda: state(s, "urgent") ==
                    s.scheduler_mod.SCHED_ADMITTED, agent)
    # exactly one shrink: the freed slice satisfied the gang, so the
    # cascade must not have run the victim further down
    for _ in range(10):
        agent.poll_once()
        tick(s)
    assert agent.current == 3
    assert counter(s, "scheduler_preemptions_total",
                   {"tier": "training", "outcome": "scheduled"}) == 1
    mark(s, "one shrink")

    set_anno(s, "urgent", {s.names.SCHED_GANG_ANNOTATION: None,
                           s.names.SCHED_TIER_ANNOTATION: None})
    grown = wait(s, lambda: agent.current == 4, agent)
    assert agent.violations == []
    return {"first": first, "drained": drained, "admitted": admitted,
            "grown": grown, "steps": agent.steps}


def grow_back_headroom_is_never_readmitted(s):
    sched_world(s)
    s.store.create(s.api.new_notebook("train", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.ELASTIC_ANNOTATION: "true",
        s.names.ELASTIC_SLICES_ANNOTATION: "3",
        s.names.ELASTIC_CURRENT_SLICES_ANNOTATION: "2",
    }))
    assert s.scheduler_mod.notebook_usage(notebook(s, "train")) == 3
    create_gang(s, "greedy", 2)  # no tier → training, never preempts
    turns = wait(s, lambda: outcome(s, "no-capacity") >= 3)
    assert state(s, "greedy") == s.scheduler_mod.SCHED_PENDING
    create_gang(s, "modest", 1)
    modest = wait(s, lambda: state(s, "modest") ==
                  s.scheduler_mod.SCHED_ADMITTED)
    assert state(s, "greedy") == s.scheduler_mod.SCHED_PENDING
    mark(s, "modest admitted")
    return {"turns": turns, "modest": modest}


def equal_tier_never_preempts(s):
    sched_world(s)
    create_elastic(s, "train", slices=3)
    create_gang(s, "peer", 2)  # no tier → training
    turns = wait(s, lambda: outcome(s, "no-capacity") >= 3)
    assert state(s, "peer") == s.scheduler_mod.SCHED_PENDING
    assert anno(s, "train", s.names.ELASTIC_RESIZE_ANNOTATION) is None
    assert anno(s, "train", s.names.SCHED_PREEMPTED_ANNOTATION) is None
    return {"turns": turns}


def victim_on_last_slice_is_never_preempted(s):
    sched_world(s)
    s.store.create(s.api.new_notebook("train", NS, annotations={
        s.names.ELASTIC_ANNOTATION: "true",
        s.names.ELASTIC_SLICES_ANNOTATION: "1",
        s.names.ELASTIC_CURRENT_SLICES_ANNOTATION: "1",
    }))
    create_gang(s, "burst", 4, tier="interactive")
    turns = wait(s, lambda: outcome(s, "no-capacity") >= 2)
    assert anno(s, "train", s.names.ELASTIC_RESIZE_ANNOTATION) is None
    assert anno(s, "train", s.names.SCHED_PREEMPTED_ANNOTATION) is None
    assert state(s, "burst") == s.scheduler_mod.SCHED_PENDING
    return {"turns": turns}


# ------------------------------------------------------ dead-scheduler path
def dead_scheduler_grace_degrades_to_unscheduled_roll(s):
    # no scheduler and no sched-state ever stamped: the gate polls every
    # 20 ms of real time until the 0.2 s grace has passed, then rolls
    sched_world(s, config=fast_config(s, sched_admission_grace_s=0.2,
                                      sched_poll_s=0.02),
                with_scheduler=False, window=0.05)
    create_gang(s, "g1", 2)
    s.drain()   # no timed requeue: inside the grace window
    assert not rolled(s, "g1"), "gate must hold inside the grace window"
    settle(s)
    assert rolled(s, "g1"), \
        "notebook never rolled after the dead-scheduler grace"
    assert "SchedulerAdmissionTimeout" in reasons(s)
    assert state(s, "g1") is None
    return {}


def scheduler_progress_disables_the_grace_timeout(s):
    # Pending is stamped, so the gate waits for ever: a drain over 0.6 s
    # of real time (three grace windows) runs its 20 ms polls
    sched_world(s, config=fast_config(s, sched_admission_grace_s=0.2,
                                      sched_poll_s=0.02),
                with_scheduler=False, window=0.05)
    s.store.create(s.api.new_notebook("g1", NS, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.SCHED_GANG_ANNOTATION: "2",
        s.names.SCHED_STATE_ANNOTATION: s.scheduler_mod.SCHED_PENDING,
    }))
    settle(s, timeout=0.6)
    assert not rolled(s, "g1"), \
        "a queued gang must not cold-roll out from under admission"
    assert "SchedulerAdmissionTimeout" not in reasons(s)
    return {}


# -------------------------------------------------------------- API layer
def tpuquota_validation_and_new_tpu_quota(s):
    s.quota_api.install_tpuquota_crd(s.store)
    s.store.create(s.quota("ok", "team-a", 0))  # 0 = explicit freeze
    errors = []
    with pytest.raises(INVALID[s.side], match="tenant") as exc:
        s.store.create({"apiVersion": s.quota_api.API_VERSION,
                        "kind": s.quota_api.KIND,
                        "metadata": {"name": "no-tenant"},
                        "spec": {"maxSlices": 2}})
    errors.append(str(exc.value))
    with pytest.raises(INVALID[s.side], match="non-negative") as exc:
        s.store.create(s.quota("neg", "team-a", -1))
    errors.append(str(exc.value))
    with pytest.raises(INVALID[s.side], match="non-negative") as exc:
        # raw wire dict: new_tpu_quota would coerce the bool away
        s.quota_api.validate_tpu_quota({
            "apiVersion": s.quota_api.API_VERSION,
            "kind": s.quota_api.KIND, "metadata": {"name": "bool"},
            "spec": {"tenant": "team-a", "maxSlices": True}})
    errors.append(str(exc.value))
    return {"errors": errors}


CASES = {fn.__name__: fn for fn in (
    gang_admission_two_phase_then_roll,
    non_gang_notebook_bypasses_the_scheduler,
    quota_denies_until_quota_lifted,
    min_quota_wins_across_duplicates,
    capacity_blocks_second_gang_until_release,
    gang_fits_requires_one_topology_bin,
    reserving_state_found_at_startup_converges_to_admitted,
    stale_reservation_over_capacity_reverts,
    interactive_gang_preempts_training_through_elastic_handshake,
    gang_admitted_elastic_victim_reservation_yields_to_preemption,
    grow_back_headroom_is_never_readmitted,
    equal_tier_never_preempts,
    victim_on_last_slice_is_never_preempted,
    dead_scheduler_grace_degrades_to_unscheduled_roll,
    scheduler_progress_disables_the_grace_timeout,
    tpuquota_validation_and_new_tpu_quota)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_case_through_both_stacks(case):
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


def test_scheduler_metric_families_exported():
    """tests/test_observability.py's ``test_scheduler_metric_families_
    exported`` on both packages: the four families land in one exposition
    with their label shapes, ``scheduler_quota_used`` computed at scrape
    time from the fleet's annotations; the scheduler families of both
    expositions are equal line for line."""
    lines = {}
    for s in (Stack("ref"), Stack("port")):
        sched = s.scheduler_mod.SchedulerReconciler(s.store, s.Config(),
                                                    s.metrics)
        s.store.create(s.api.new_notebook("train", "team-a", annotations={
            s.names.ELASTIC_ANNOTATION: "true",
            s.names.ELASTIC_SLICES_ANNOTATION: "3",
            s.names.ELASTIC_CURRENT_SLICES_ANNOTATION: "3",
        }))
        sched.admissions_total.inc({"tenant": "team-a",
                                    "outcome": "admitted"})
        sched.admissions_total.inc({"tenant": "team-a",
                                    "outcome": "quota-denied"})
        sched.preemptions_total.inc({"tier": "training",
                                     "outcome": "scheduled"})
        sched.gang_wait.observe(1.5, {"tenant": "team-a"})
        text = s.metrics.expose()
        assert ('scheduler_admissions_total{outcome="admitted",'
                'tenant="team-a"} 1') in text
        assert ('scheduler_admissions_total{outcome="quota-denied",'
                'tenant="team-a"} 1') in text
        assert ('scheduler_preemptions_total{outcome="scheduled",'
                'tier="training"} 1') in text
        assert 'scheduler_gang_wait_seconds_count{tenant="team-a"} 1' in text
        assert 'scheduler_quota_used{tenant="team-a"} 3' in text
        lines[s.side] = [ln for ln in text.splitlines()
                         if "scheduler_" in ln]
    assert lines["port"] == lines["ref"]


def test_setup_watches_and_registers_one_worker():
    """``setup`` on both packages: one reconcile worker (the single
    writer that makes a reserve patch atomic), a watch on each of
    Notebook, SlicePool and TPUQuota, each dropping the scheduler's own
    echoes, and a read cache of its own when the manager has none."""
    seen = {}
    for s in (Stack("ref"), Stack("port")):
        calls = []
        watch = s.manager.watch

        def recording(kind, controller, _calls=calls, _watch=watch, **kw):
            _calls.append((kind, controller, kw.get("predicate") is not None,
                           kw.get("tee") is not None))
            return _watch(kind, controller, **kw)
        s.manager.watch = recording
        sched = s.scheduler()
        seen[s.side] = (s.manager._max_concurrent[sched.name], calls,
                        type(sched._read_cache).__name__)
    assert seen["port"] == seen["ref"]
    assert seen["port"] == (1, [(kind, "fleet-scheduler", True, True)
                                for kind in ("Notebook", "SlicePool",
                                             "TPUQuota")], "CachingClient")


# ------------------------------------------------ usage helpers, seeded
_ANNOTATION_VALUES = ["0", "1", "2", "3", "4", "7", "-1", "x", "", "2.5"]


def _random_annotations(rng, nm) -> dict:
    """An annotation set over the scheduler's and the elastic keys, each
    present or absent, with values valid, out of range or malformed."""
    out = {}
    for key in ("SCHED_GANG_ANNOTATION", "ELASTIC_SLICES_ANNOTATION",
                "ELASTIC_CURRENT_SLICES_ANNOTATION",
                "SCHED_RESERVED_ANNOTATION"):
        if rng.random() < 0.6:
            out[getattr(nm, key)] = str(rng.choice(_ANNOTATION_VALUES))
    if rng.random() < 0.5:
        out[nm.ELASTIC_ANNOTATION] = "true"
    if rng.random() < 0.6:
        out[nm.SCHED_TIER_ANNOTATION] = str(rng.choice(
            ["interactive", "serving", "training", "batch", ""]))
    if rng.random() < 0.7:
        out[nm.SCHED_STATE_ANNOTATION] = str(rng.choice(
            ["Pending", "Reserving", "Admitted", "Bogus"]))
    if rng.random() < 0.3:
        out[nm.SCHED_PREEMPTED_ANNOTATION] = "ns/preemptor"
    return out


HELPERS = ("gang_slices", "tier_of", "elastic_current", "elastic_held",
           "reserved_slices", "notebook_usage", "sched_state")


def test_usage_helpers_match_the_reference_on_seeded_annotations():
    """500 annotation sets drawn from one seed: every usage helper of
    both packages returns the same value."""
    # the annotation keys are the same strings in both packages
    for key in dir(ref_names):
        if key.startswith(("SCHED_", "ELASTIC_")) and \
                isinstance(getattr(ref_names, key), str):
            assert getattr(names, key) == getattr(ref_names, key), key
    ref_stack, port_stack = Stack("ref"), Stack("port")
    rng = np.random.default_rng(SEED)
    seen = set()
    for i in range(500):
        anns = _random_annotations(rng, ref_names)
        ref_nb = ref_stack.api.new_notebook(f"nb-{i}", NS, annotations=anns)
        port_nb = port_stack.api.new_notebook(f"nb-{i}", NS,
                                              annotations=dict(anns))
        for fn in HELPERS:
            want = getattr(ref_scheduler, fn)(ref_nb)
            have = getattr(scheduler, fn)(port_nb)
            assert have == want, (fn, anns)
            seen.add((fn, want))
    # the draw reaches every branch: each helper takes several values
    for fn in HELPERS:
        assert len({v for f, v in seen if f == fn}) >= 2, fn
    assert scheduler.TIER_RANK == ref_scheduler.TIER_RANK
    assert scheduler.DEFAULT_TIER == ref_scheduler.DEFAULT_TIER


# ------------------------------------------------------- the quota API
class _ListClient:
    def __init__(self, objs):
        self.objs = objs

    def list(self, kind):
        return [o for o in self.objs if o.get("kind") == kind]


def _random_quota(rng, api, i) -> dict:
    q = api.new_tpu_quota(f"q-{i}", str(rng.choice(["team-a", "team-b"])),
                          int(rng.integers(0, 6)))
    roll = rng.random()
    if roll < 0.1:
        q["spec"]["maxSlices"] = bool(rng.integers(0, 2))
    elif roll < 0.2:
        q["spec"]["maxSlices"] = -int(rng.integers(1, 3))
    elif roll < 0.25:
        q["spec"]["maxSlices"] = "3"
    elif roll < 0.3:
        del q["spec"]["tenant"]
    elif roll < 0.35:
        q["apiVersion"] = "tpu.kubeflow.org/v2"
    elif roll < 0.4:
        q["metadata"]["name"] = ""
    return q


def test_quota_api_matches_the_reference_on_seeded_quotas():
    """``validate_tpu_quota`` (its verdict and message) and
    ``tenant_quota`` (duplicates resolve to the minimum; a bool
    ``maxSlices`` is refused by validation but read as an int by the
    ceiling, in both) of both packages on 300 quota sets drawn from one
    seed, and the two CRDs equal."""
    rng = np.random.default_rng(SEED)
    for _ in range(300):
        state_ = rng.bit_generator.state
        n = int(rng.integers(0, 5))
        ref_qs = [_random_quota(rng, ref_quota_api, i) for i in range(n)]
        rng.bit_generator.state = state_
        n = int(rng.integers(0, 5))
        port_qs = [_random_quota(rng, quota_api, i) for i in range(n)]
        assert port_qs == ref_qs
        for rq, pq in zip(ref_qs, port_qs):
            verdicts = []
            for fn, q, err in ((ref_quota_api.validate_tpu_quota, rq,
                                RefInvalidError),
                               (quota_api.validate_tpu_quota, pq,
                                InvalidError)):
                try:
                    fn(q)
                    verdicts.append(None)
                except err as exc:
                    verdicts.append((exc.code, str(exc)))
            assert verdicts[1] == verdicts[0]
        for tenant in ("team-a", "team-b", "team-c"):
            assert quota_api.tenant_quota(_ListClient(port_qs), tenant) == \
                ref_quota_api.tenant_quota(_ListClient(ref_qs), tenant)
    assert quota_api.tpuquota_crd() == ref_tpuquota_crd()
    for attr in ("GROUP", "VERSION", "API_VERSION", "KIND", "PLURAL"):
        assert getattr(quota_api, attr) == getattr(ref_quota_api, attr)
