"""Fleet scheduler: gang admission, tenant quota and tier preemption.

The port's copy of ``kubeflow_tpu/controllers/scheduler.py``, with the
same states, annotations, events, metrics and ``CONTRACT``/``PROTOCOL``
declarations, for H100 slices. A multi-slice job that acquires 2 of its
3 slices holds them against every other tenant while it deadlocks on the
third, and an interactive user waits behind a week-long training run
that could shrink by one slice without dying. This controller arbitrates
the fleet's slice capacity for **gang-annotated** Notebooks
(``tpu.kubeflow.org/gang-slices``; everything else bypasses it):

* **Gang admission**: a job's slices are acquired atomically or not at
  all. The reservation is ONE annotation (``sched-reserved``) persisted
  in the SAME patch as the ``Reserving`` state flip, so there is no
  multi-object window in which a crash strands a half-admitted gang:
  restart re-derives fleet usage from annotations and either completes
  the admission or reverts it.
* **Tenant quota**: cluster-scoped ``TPUQuota`` CRs (api/tpuquota.py)
  cap the slices one namespace may hold across all shapes; admission
  past the cap is refused (the gang stays Pending), never retro-enforced
  on running work.
* **Tier preemption through the elastic handshake**: when an
  ``interactive`` gang cannot fit, the scheduler picks a lower-tier
  elastic training victim and stamps the slice repair controller's
  ``elastic-resize: Draining`` request (controllers/slicerepair.py owns
  that machine). The trainer agent drains to a durable save and
  reshards; the slice is reclaimed only after the ack, so preemption is
  a scheduled migration, never a kill. A dead agent hits the repair
  controller's timeout latch and the reservation reverts. The
  ``sched-preempted`` hold stamped with the drain keeps the repair
  controller from growing the victim back until the preemptor releases.

Admission state rides the Notebook (absent = Idle)::

    Idle ──(gang-requested)──▶ Pending ──(capacity-reserved)──▶
    Reserving ──(reservation-verified)──▶ Admitted ──(gang-released)──▶ Idle
                 │ (reservation-lost)▲
                 ▼──────── Pending ──┘

Fleet usage is never cached in memory: every pass derives it from the
fleet's annotations (elastic entitlements + live reservations; an
unheld elastic run counts at its requested size, so a preempted victim's
grow-back headroom returns to the victim, never to the admission
queue), which is what makes a crash at ANY boundary recoverable. The
capacity is the SlicePools' ``warmReplicas`` (api/slicepool.py), else
``config.sched_default_capacity``. ``wall_clock`` stamps the
``sched-enqueued-at`` and preemption ``resize-started-at`` epochs, which
other controllers compare against their own wall clocks. The reference's
tracked lock is never taken (the one reconcile worker is the
serialisation), so the port keeps none.
"""

from __future__ import annotations

import logging
import time

from ..api import slicepool as pool_api
from ..api import tpuquota as quota_api
from ..api import types as api
from ..cluster import events
from ..utils import k8s, names
from ..utils.config import ControllerConfig
from ..utils.fairness import first_fit_pack
from ..utils.metrics import MetricsRegistry
from .manager import Manager, Request, Result

# API effect contract: what this reconciler reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py checks the
# reference's copy); update it with the code.
CONTRACT = {
    "role": "reconciler",
    "primary": "Notebook",
    "reads": ["Notebook", "SlicePool", "TPUQuota"],
    "watches": ["Notebook", "SlicePool", "TPUQuota"],
    "writes": {
        "Event": ["create"],
        "Notebook": ["patch"],
    },
    "cross_namespace": ["Notebook"],
    "annotations": [
        "ELASTIC_ACK_ANNOTATION", "ELASTIC_ANNOTATION",
        "ELASTIC_CURRENT_SLICES_ANNOTATION", "ELASTIC_RESIZE_ANNOTATION",
        "ELASTIC_RESIZE_STARTED_AT_ANNOTATION", "ELASTIC_SLICES_ANNOTATION",
        "ELASTIC_TARGET_ANNOTATION",
        "SCHED_ENQUEUED_AT_ANNOTATION", "SCHED_GANG_ANNOTATION",
        "SCHED_PREEMPTED_ANNOTATION", "SCHED_RESERVED_ANNOTATION",
        "SCHED_STATE_ANNOTATION", "SCHED_TIER_ANNOTATION",
    ],
}

# Protocol state machine, kept as data as the reference declares it (its
# ci/protocol_gate.py and ci/protocol_check.py check the reference's
# copy, composed with elastic-resize and pool-slice); update with the
# code.
PROTOCOL = [
    {
        "machine": "sched-admission",
        "doc": "Two-phase gang admission on the Notebook: the reservation "
               "count persists in the SAME patch as the Reserving flip, "
               "and usage is re-derived from annotations on every pass, "
               "so a controller crash never strands a gang half-admitted "
               "or leaks a reservation.",
        "owner": "scheduler",
        "carrier": {"object": "Notebook",
                    "annotation": "SCHED_STATE_ANNOTATION"},
        "fresh_reads": "echo-tracking",
        "states": {"Idle": None, "Pending": "Pending",
                   "Reserving": "Reserving", "Admitted": "Admitted"},
        "initial": "Idle",
        "terminal": ["Idle", "Admitted"],
        "aux": {
            "SCHED_RESERVED_ANNOTATION":
                "slice count reserved for the gang — stamped atomically "
                "with Reserving, cleared on revert/release; the unit of "
                "crash-safe usage accounting",
            "SCHED_ENQUEUED_AT_ANNOTATION":
                "gang wait clock (epoch seconds), stamped with Pending; "
                "feeds scheduler_gang_wait_seconds and the core "
                "reconciler's dead-scheduler grace timeout",
            "SCHED_PREEMPTED_ANNOTATION":
                "preemption hold on a training victim (value = preemptor "
                "ns/name): blocks the repair controller's grow-back gate "
                "until the preemptor releases",
        },
        "transitions": [
            {"from": "Idle", "to": "Pending", "trigger": "gang-requested",
             "doc": "gang-annotated notebook seen without admission "
                    "state: enqueue, stamp the wait clock"},
            {"from": "Pending", "to": "Reserving",
             "trigger": "capacity-reserved",
             "doc": "quota + capacity admit the gang: the reservation "
                    "count rides the SAME patch as the state flip"},
            {"from": "Reserving", "to": "Admitted",
             "trigger": "reservation-verified",
             "effects": ["event:GangAdmitted"],
             "effects_idempotent": True,
             "doc": "usage re-derived fresh still fits: the gang holds "
                    "its slices; the core reconciler may roll"},
            {"from": "Reserving", "to": "Pending",
             "trigger": "reservation-lost",
             "effects": ["event:GangReservationReverted"],
             "effects_idempotent": True,
             "doc": "capacity shrank under the reservation (pool scaled "
                    "down, preemption aborted by a dead agent): revert "
                    "and re-queue — never admit over capacity"},
            {"from": "Admitted", "to": "Idle", "trigger": "gang-released",
             "doc": "gang annotation removed or notebook stopping: the "
                    "reservation clears with the state in one patch"},
            {"from": "Pending", "to": "Idle", "trigger": "request-withdrawn",
             "doc": "gang annotation removed while still queued"},
        ],
    },
]

# sched-admission machine states (carrier absent = Idle)
SCHED_PENDING = "Pending"
SCHED_RESERVING = "Reserving"
SCHED_ADMITTED = "Admitted"

# priority tiers, highest first: an interactive gang may preempt a
# training run's slice; absent tier reads as the lowest (training) so an
# unlabeled job can never preempt anyone
TIER_RANK = {"interactive": 0, "serving": 1, "training": 2}
DEFAULT_TIER = "training"

log = logging.getLogger("kubeflow_tpu_torch.scheduler")


def sched_state(notebook: dict) -> str | None:
    """The sched-admission machine state carried on the Notebook
    (None = Idle)."""
    return k8s.get_annotation(notebook, names.SCHED_STATE_ANNOTATION)


def gang_slices(notebook: dict) -> int | None:
    """The notebook's gang request (slice count), or None when it does
    not participate in fleet scheduling at all."""
    raw = k8s.get_annotation(notebook, names.SCHED_GANG_ANNOTATION)
    if raw is None:
        return None
    try:
        n = int(raw)
    except (TypeError, ValueError):
        return None
    return n if n >= 1 else None


def tier_of(notebook: dict) -> str:
    tier = k8s.get_annotation(notebook, names.SCHED_TIER_ANNOTATION)
    return tier if tier in TIER_RANK else DEFAULT_TIER


def _int_annotation(obj: dict, annotation: str, default: int) -> int:
    raw = k8s.get_annotation(obj, annotation)
    try:
        return int(raw)
    except (TypeError, ValueError):
        return default


def elastic_current(notebook: dict) -> int:
    """Slices an elastic training run PHYSICALLY holds right now. The
    pre-resize count stays authoritative through a whole drain/reshard
    cycle (the repair controller stamps current-slices only at cycle
    completion), which keeps this view conservative: a slice is never
    counted free before the runtime confirmed it left. Preemption
    mechanics (victim choice, the drain target) work on this view."""
    if k8s.get_annotation(notebook, names.ELASTIC_ANNOTATION) is None:
        return 0
    requested = _int_annotation(notebook, names.ELASTIC_SLICES_ANNOTATION, 1)
    return _int_annotation(
        notebook, names.ELASTIC_CURRENT_SLICES_ANNOTATION, requested)


def elastic_held(notebook: dict) -> int:
    """Slices an elastic training run is ENTITLED to — its usage for
    admission accounting. An unheld run counts at max(current,
    requested): a preempted victim's grow-back headroom belongs to the
    victim the moment its hold is swept, never to the admission queue —
    without this, a gang admitted during the grow-back window (current
    still below requested, the grow cycle not yet complete) would
    oversubscribe the fleet when the grow lands. While a preemption hold
    pins the run, entitlement is capped at the physical count: the
    preemptor owns the reclaimed headroom."""
    if k8s.get_annotation(notebook, names.ELASTIC_ANNOTATION) is None:
        return 0
    current = elastic_current(notebook)
    if k8s.get_annotation(notebook, names.SCHED_PREEMPTED_ANNOTATION) \
            is not None:
        return current
    requested = _int_annotation(notebook, names.ELASTIC_SLICES_ANNOTATION, 1)
    return max(current, requested)


def reserved_slices(notebook: dict) -> int:
    """Slices held by a gang reservation (Reserving or Admitted). A gang
    that is also elastic counts once, at the max of the two views."""
    if sched_state(notebook) not in (SCHED_RESERVING, SCHED_ADMITTED):
        return 0
    return _int_annotation(notebook, names.SCHED_RESERVED_ANNOTATION, 0)


def notebook_usage(notebook: dict) -> int:
    """A notebook's slice count in the fleet usage ledger. Normally the
    max of the two accounting views (elastic entitlement, gang
    reservation) so a gang that is also elastic counts once at the
    larger. Exception: while a preemption hold pins an elastic victim,
    the capped entitlement is authoritative — an elastic run that
    ENTERED via gang admission keeps its admission-size reservation
    annotation, and letting that stale count win would pin the reclaimed
    slice in the ledger forever (the preemptor's gang never sees the
    freed capacity and the scheduler cascades down to the last-slice
    guard)."""
    held = elastic_held(notebook)
    if k8s.get_annotation(notebook, names.ELASTIC_ANNOTATION) is not None \
            and k8s.get_annotation(
                notebook, names.SCHED_PREEMPTED_ANNOTATION) is not None:
        return held
    return max(held, reserved_slices(notebook))


class SchedulerReconciler:
    """Single-writer fleet admission: registered with
    max_concurrent_reconciles=1 so two gangs can never interleave their
    reserve patches — atomicity by construction, the same serialization
    argument the pool controller makes for binds."""

    name = "fleet-scheduler"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 wall_clock=time.time):
        from ..cluster.echo import EchoTrackingClient
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        # wall clock for every annotation timestamp this controller
        # stamps (enqueued-at, the preemption resize-started-at): other
        # controllers compare them against THEIR wall clocks, so these
        # are cross-controller epoch protocols like the pool bind
        # heartbeat — injectable, never monotonic
        self.wall_clock = wall_clock
        self.recorder = events.EventRecorder(client, component=self.name)
        self._read_cache = None
        self._gauge_seen: set[str] = set()
        self.admissions_total = self.metrics.counter(
            "scheduler_admissions_total",
            "Gang admission decisions by tenant and outcome (admitted / "
            "reverted / quota-denied / no-capacity). A Pending gang is "
            "re-evaluated every pass, so denied outcomes count "
            "evaluations, not unique gangs.")
        self.preemptions_total = self.metrics.counter(
            "scheduler_preemptions_total",
            "Preemption cascades by victim tier and outcome (scheduled / "
            "released): scheduled stamps the elastic Draining handshake, "
            "released clears the grow-back hold.")
        self.gang_wait = self.metrics.histogram(
            "scheduler_gang_wait_seconds",
            "Gang-requested to Admitted latency, by tenant.")
        self.quota_used = self.metrics.gauge(
            "scheduler_quota_used",
            "Slices currently held per tenant (elastic holdings + live "
            "gang reservations), the scheduler's own usage derivation.")
        self.metrics.on_scrape(self._scrape_usage)

    # ------------------------------------------------------------- wiring
    def setup(self, mgr: Manager) -> None:
        """Own gang-annotated Notebook keys; any fleet event (a Notebook
        changing shape, a pool resizing, a quota edit) re-enqueues every
        gang still in flight — admission is a fleet-global decision, so
        the mapper fans out rather than guessing relevance."""
        mgr.register(self, max_concurrent_reconciles=1)
        from ..cluster.cache import CachingClient
        if mgr.read_cache is not None:
            cache, tee = mgr.read_cache, None
        else:
            cache = CachingClient(self.client, disable_for=(),
                                  auto_informer=False)
            tee = cache.feed
        self._read_cache = cache
        ne = self.client.not_echo
        mgr.watch(api.KIND, self.name, mapper=self._gangs_for_obj, tee=tee,
                  predicate=ne)
        mgr.watch(pool_api.KIND, self.name, mapper=self._gangs_for_obj,
                  tee=tee, predicate=ne)
        mgr.watch(quota_api.KIND, self.name, mapper=self._gangs_for_obj,
                  tee=tee, predicate=ne)
        for kind in (api.KIND, pool_api.KIND, quota_api.KIND):
            try:
                cache.backfill(kind)
            except Exception:  # noqa: BLE001 — degrade to live reads
                log.warning("read-cache backfill for %s failed; reads "
                            "stay live", kind, exc_info=True)

    def _reader(self):
        return self._read_cache or self.client

    def _gangs_for_obj(self, obj: dict) -> list[Request]:
        """Fan a fleet event out to every Notebook with scheduling state
        in play. Gangs are few (they are whole-slice jobs), so listing
        here is the slicepool mapper's cost model, not a fleet walk per
        pod event — only Notebook/SlicePool/TPUQuota events arrive."""
        out = []
        if k8s.kind(obj) == api.KIND and (
                gang_slices(obj) is not None or sched_state(obj) is not None
                or k8s.get_annotation(
                    obj, names.SCHED_PREEMPTED_ANNOTATION) is not None):
            out.append(Request(k8s.namespace(obj), k8s.name(obj)))
        for nb in self._reader().list(api.KIND):
            if gang_slices(nb) is None and sched_state(nb) is None:
                continue
            req = Request(k8s.namespace(nb), k8s.name(nb))
            if req not in out:
                out.append(req)
        return out

    # ------------------------------------------------------- fleet views
    def _fleet_notebooks(self) -> list[dict]:
        return self._reader().list(api.KIND)

    def _capacity(self) -> int:
        """Total fleet slice capacity: the SlicePools' declared warm
        targets (capacity including bound slices — the pool's own
        accounting), or the configured default when no pool exists (the
        pure-cold-roll fleet still deserves admission control)."""
        reader = self._reader()
        pools = reader.list(pool_api.KIND)
        total = sum(_spec_int(p, "warmReplicas") for p in pools)
        return total if pools else self.config.sched_default_capacity

    def _tenant_quota(self, tenant: str) -> int | None:
        """Effective slice ceiling for a tenant: the MINIMUM over every
        TPUQuota naming it (duplicate-apply races resolve conservative),
        None = no quota = unlimited. Mirrors api.tpuquota.tenant_quota
        for out-of-controller tooling."""
        reader = self._reader()
        caps = [k8s.get_in(q, "spec", "maxSlices")
                for q in reader.list(quota_api.KIND)
                if k8s.get_in(q, "spec", "tenant") == tenant]
        caps = [c for c in caps if isinstance(c, int)]
        return min(caps) if caps else None

    def _usage(self, fleet: list[dict],
               exclude: tuple[str, str] | None = None) -> int:
        return sum(notebook_usage(nb) for nb in fleet
                   if (k8s.namespace(nb), k8s.name(nb)) != exclude)

    def _tenant_usage(self, fleet: list[dict], tenant: str,
                      exclude: tuple[str, str] | None = None) -> int:
        return sum(notebook_usage(nb) for nb in fleet
                   if k8s.namespace(nb) == tenant
                   and (k8s.namespace(nb), k8s.name(nb)) != exclude)

    def _scrape_usage(self) -> None:
        usage: dict[str, int] = {}
        for nb in self._fleet_notebooks():
            held = notebook_usage(nb)
            if held:
                ns = k8s.namespace(nb)
                usage[ns] = usage.get(ns, 0) + held
        for tenant in self._gauge_seen | set(usage):
            self.quota_used.set(usage.get(tenant, 0), {"tenant": tenant})
        self._gauge_seen |= set(usage)

    # ---------------------------------------------------------- reconcile
    def reconcile(self, req: Request) -> Result | None:
        notebook = self.client.get_or_none(api.KIND, req.namespace,
                                           req.name)
        self._sweep_holds()
        if notebook is None or k8s.is_deleting(notebook):
            # deletion takes the annotations (and thus the reservation)
            # with it: usage derivation frees the capacity with no
            # cleanup write to lose
            return None
        gang = gang_slices(notebook)
        state = sched_state(notebook)
        key = (req.namespace, req.name)

        if gang is None:
            # gang annotation removed (or never valid): withdraw. The
            # requeue matters for liveness: our own release patch is an
            # echo our watches drop, so without it the follow-up pass
            # that sweeps the (now-unentitled) preemption holds would
            # wait for an unrelated fleet event.
            if state == SCHED_PENDING:
                self.client.patch(api.KIND, key[0], key[1], {
                    "metadata": {"annotations": {
                        names.SCHED_STATE_ANNOTATION: None,
                        names.SCHED_ENQUEUED_AT_ANNOTATION: None,
                    }}})
                return Result(requeue_after=0)
            if state in (SCHED_RESERVING, SCHED_ADMITTED):
                self._release(notebook, key)
                return Result(requeue_after=0)
            return None

        if state is None:
            # Idle → Pending: enqueue, start the wait clock
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: SCHED_PENDING,
                    names.SCHED_ENQUEUED_AT_ANNOTATION:
                        "%.3f" % self.wall_clock(),
                }}})
            return Result(requeue_after=0)
        if state == SCHED_PENDING:
            return self._admit(notebook, key, gang)
        if state == SCHED_RESERVING:
            return self._verify_reservation(notebook, key, gang)
        if state == SCHED_ADMITTED:
            return None  # holding; release paths run above
        log.warning("unknown sched-state %r on %s/%s; leaving it for an "
                    "operator", state, *key)
        return None

    # ---------------------------------------------------------- admission
    def _admit(self, notebook: dict, key: tuple[str, str],
               gang: int) -> Result | None:
        """Pending → Reserving, or stay Pending (quota / capacity), or
        schedule a preemption and wait for the drain to free slices."""
        state = sched_state(notebook)
        fleet = self._fleet_notebooks()
        tenant = key[0]
        quota = self._tenant_quota(tenant)
        if quota is not None and \
                self._tenant_usage(fleet, tenant, exclude=key) + gang > quota:
            self.admissions_total.inc(
                {"tenant": tenant, "outcome": "quota-denied"})
            return Result(requeue_after=self.config.sched_poll_s)

        capacity = self._capacity()
        free = capacity - self._usage(fleet, exclude=key)
        if state == SCHED_PENDING and free >= gang and self._gang_fits(gang):
            # the reservation and the state flip are ONE patch: the
            # crash-atomicity the two-phase protocol rests on
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: SCHED_RESERVING,
                    names.SCHED_RESERVED_ANNOTATION: str(gang),
                }}})
            return Result(requeue_after=0)

        if free < gang:
            self._maybe_preempt(notebook, key, fleet, gang, free)
        self.admissions_total.inc(
            {"tenant": tenant, "outcome": "no-capacity"})
        return Result(requeue_after=self.config.sched_poll_s)

    def _gang_fits(self, gang: int) -> bool:
        """Topology-aware placement check: when pools declare capacity
        bins, the gang must land WHOLE in one of them (a gang split
        across topologies is not a gang). With no pools the fleet is one
        flat bin and raw free-count admission is exact."""
        reader = self._reader()
        pools = reader.list(pool_api.KIND)
        if not pools:
            return True
        bins: dict[str, int] = {}
        for p in pools:
            accel = k8s.get_in(p, "spec", "accelerator") or k8s.name(p)
            bins[accel] = bins.get(accel, 0) + _spec_int(p, "warmReplicas")
        placements, _ = first_fit_pack([("gang", gang)], bins)
        return "gang" in placements

    def _verify_reservation(self, notebook: dict, key: tuple[str, str],
                            gang: int) -> Result | None:
        """Reserving → Admitted when a FRESH usage derivation still fits
        the reservation, Reserving → Pending when it cannot (capacity
        shrank, a preemption aborted): the verify pass is what makes a
        crash between reserve and admit harmless — either outcome is
        recomputed from annotations, never from memory."""
        state = sched_state(notebook)
        fleet = self._fleet_notebooks()
        free = self._capacity() - self._usage(fleet, exclude=key)
        if state == SCHED_RESERVING and free >= gang \
                and self._gang_fits(gang):
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: SCHED_ADMITTED,
                }}})
            self.admissions_total.inc(
                {"tenant": key[0], "outcome": "admitted"})
            enqueued = k8s.get_annotation(
                notebook, names.SCHED_ENQUEUED_AT_ANNOTATION)
            try:
                waited = max(0.0, self.wall_clock() - float(enqueued))
            except (TypeError, ValueError):
                waited = 0.0
            self.gang_wait.observe(waited, {"tenant": key[0]})
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "GangAdmitted",
                f"gang of {gang} slice(s) admitted after {waited:.1f}s")
            return Result(requeue_after=0)
        if state == SCHED_RESERVING:
            # the reservation can no longer be honored: revert, re-queue
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: SCHED_PENDING,
                    names.SCHED_RESERVED_ANNOTATION: None,
                }}})
            self.admissions_total.inc(
                {"tenant": key[0], "outcome": "reverted"})
            self.recorder.eventf(
                notebook, events.TYPE_WARNING, "GangReservationReverted",
                f"capacity for the {gang}-slice reservation disappeared; "
                f"re-queued")
        return Result(requeue_after=self.config.sched_poll_s)

    def _release(self, notebook: dict, key: tuple[str, str]) -> None:
        """Admitted (or a withdrawn Reserving) → Idle: the reservation
        clears with the state in one patch, so no crash order leaks it."""
        state = sched_state(notebook)
        if state == SCHED_ADMITTED:
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: None,
                    names.SCHED_RESERVED_ANNOTATION: None,
                    names.SCHED_ENQUEUED_AT_ANNOTATION: None,
                }}})
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "GangReleased",
                "gang released its slices")
        elif state == SCHED_RESERVING:
            # withdrawn mid-reserve: the declared revert edge, then the
            # Pending→Idle withdraw completes on the next pass
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.SCHED_STATE_ANNOTATION: SCHED_PENDING,
                    names.SCHED_RESERVED_ANNOTATION: None,
                }}})

    # --------------------------------------------------------- preemption
    def _maybe_preempt(self, notebook: dict, key: tuple[str, str],
                       fleet: list[dict], gang: int, free: int) -> None:
        """Schedule (never perform) a migration off a lower-tier elastic
        run: stamp the repair controller's Draining request — declared
        handoffs on the elastic-resize machine — plus the grow-back hold,
        all in ONE patch on the victim. The handshake, its ack gating,
        and its dead-agent abort all stay owned by slicerepair; this
        controller only re-derives progress from annotations."""
        tier = tier_of(notebook)
        me = f"{key[0]}/{key[1]}"
        victims = sorted(
            (nb for nb in fleet if self._preemptable(nb, tier, me)),
            key=lambda nb: (-TIER_RANK[tier_of(nb)], -elastic_current(nb),
                            k8s.namespace(nb), k8s.name(nb)))
        for victim in victims[:gang - free]:
            held = elastic_current(victim)
            vkey = (k8s.namespace(victim), k8s.name(victim))
            self.client.patch(api.KIND, vkey[0], vkey[1], {
                "metadata": {"annotations": {
                    names.ELASTIC_RESIZE_ANNOTATION: "Draining",
                    names.ELASTIC_TARGET_ANNOTATION: str(held - 1),
                    # wall clock: the repair controller compares this
                    # stamp against ITS wall clock for the dead-agent
                    # timeout — same cross-controller epoch protocol as
                    # the enqueued-at annotation
                    names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION:
                        "%.3f" % self.wall_clock(),
                    names.ELASTIC_ACK_ANNOTATION: None,
                    names.SCHED_PREEMPTED_ANNOTATION: me,
                }}})
            self.preemptions_total.inc(
                {"tier": tier_of(victim), "outcome": "scheduled"})
            self.recorder.eventf(
                victim, events.TYPE_WARNING, "GangPreempting",
                f"draining one slice ({held} → {held - 1}) for "
                f"higher-tier gang {me}")

    def _preemptable(self, nb: dict, preemptor_tier: str, me: str) -> bool:
        if TIER_RANK[preemptor_tier] >= TIER_RANK[tier_of(nb)]:
            return False  # only strictly higher tiers preempt
        if elastic_current(nb) <= 1:
            return False  # a run's last slice is never preempted
        if k8s.get_annotation(nb, names.ELASTIC_RESIZE_ANNOTATION) \
                is not None:
            return False  # a cycle is already in flight
        if k8s.get_annotation(nb, names.ELASTIC_ACK_ANNOTATION) is not None:
            return False  # Aborted latch (dead agent) or a cycle settling
        hold = k8s.get_annotation(nb, names.SCHED_PREEMPTED_ANNOTATION)
        return hold is None or hold == me

    def _sweep_holds(self) -> None:
        """Clear preemption holds whose preemptor released (or vanished):
        the hold's clearance is what re-opens the repair controller's
        grow-back gate, turning the preemption into a round-trip
        migration instead of a permanent shrink. Derived entirely from
        annotations, so a crash between the preemptor's release and this
        sweep just means the next pass clears it."""
        reader = self._reader()
        for nb in reader.list(api.KIND):
            hold = k8s.get_annotation(nb, names.SCHED_PREEMPTED_ANNOTATION)
            if hold is None:
                continue
            ns, _, name = hold.partition("/")
            preemptor = reader.get_or_none(api.KIND, ns, name) \
                if ns and name else None
            if preemptor is not None and sched_state(preemptor) in (
                    SCHED_PENDING, SCHED_RESERVING, SCHED_ADMITTED):
                continue  # still entitled to the capacity
            self.client.patch(api.KIND, k8s.namespace(nb), k8s.name(nb), {
                "metadata": {"annotations": {
                    names.SCHED_PREEMPTED_ANNOTATION: None,
                }}})
            self.preemptions_total.inc(
                {"tier": tier_of(nb), "outcome": "released"})
            self.recorder.eventf(
                nb, events.TYPE_NORMAL, "GangPreemptionReleased",
                f"preemptor {hold} released; grow-back unblocked")


def _spec_int(obj: dict, field: str) -> int:
    value = k8s.get_in(obj, "spec", field)
    return value if isinstance(value, int) else 0
