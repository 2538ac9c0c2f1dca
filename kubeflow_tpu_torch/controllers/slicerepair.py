"""Slice health & repair controller: node-preemption-aware, slice-atomic
recovery with poison-pill quarantine.

The port's copy of ``kubeflow_tpu/controllers/slicerepair.py``, with the
same states, annotations, events, metrics and ``CONTRACT``/``PROTOCOL``
declarations. An NCCL world cannot run degraded: one dead worker hangs
every collective of every other. So the failures that dominate GPU
fleets (node preemption and maintenance, a worker VM going NotReady, a
crashlooping worker image) are answered by repairing the *whole slice*
or by deliberately stopping. This controller watches Pods AND Nodes for
every slice notebook and drives a state machine:

    Healthy ──(worker NotReady / node NotReady / preemption-notice taint /
               crashloop)──▶ Degraded ──▶ Repairing ──▶ Healthy
                                │
                                └─(K FAILED repairs in a sliding window)──▶
                                  Quarantined (poison pill: repairs stop
                                  until an operator clears the annotation)

Repair is **slice-atomic**: the one StatefulSet is rolled through
replicas 0 → N, never by deleting single workers, so pods are only ever
observed at 0 or the full worker count and ordinals and hostnames
(``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES``, which ``runtime/bootstrap.py``
forms the world from) are kept. The scale-down is the
``tpu.kubeflow.org/repair-scale-down`` annotation on the Notebook; the
core reconciler's ``desired_replicas`` honours it, so ``spec.replicas``
has ONE writer (as with the culler's stop annotation).

State rides the Notebook's annotations (it survives controller restarts
and leader failover) and the core reconciler mirrors it into the
``SliceDegraded``/``SliceRepairing``/``SliceQuarantined`` conditions
beside ``SliceReady``. Every transition emits an Event, and four metric
families export the fleet view: ``slice_repairs_total``,
``slice_repair_duration_seconds``, ``slice_quarantines_total`` and
``slice_degraded`` (computed at scrape time).

Backoff between repair attempts of one slice is decorrelated jitter
(``min(cap, uniform(base, prev*3))``) drawn from the injected ``rng``, so a
zone-wide preemption wave does not re-roll every slice in lockstep; the
injected ``clock`` times repairs, the failure window and the elastic
handshake.

An elastic notebook (``runtime/elastic.py``'s agent on the trainer side)
shrinks by one slice through an ack-gated handshake instead of stopping,
and grows back once the slice is whole. A pool-bound notebook takes the
checkpoint-migration path (``runtime/migrate.py``); its cases need the
SlicePool reconciler, which is not ported yet (ROADMAP.md queue A item 3),
so they are held with it. Plain ``threading`` locks stand in for the
reference's tracked ones.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from ..api import slicepool as pool_api
from ..api import types as api
from ..cluster import events
from ..gpu.topology import GpuRequestError, SliceSpec, parse_slice_request
from ..utils import k8s, names, tracing
from ..utils.config import ControllerConfig
from ..utils.metrics import MetricsRegistry
from .manager import Manager, Request, Result

# API effect contract: what this reconciler reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py checks the
# reference's copy); update it with the code.
CONTRACT = {
    "role": "reconciler",
    "primary": "Notebook",
    "reads": ["Notebook", "Pod"],
    "watches": ["Node", "Notebook", "Pod"],
    "writes": {
        "Event": ["create"],
        "Notebook": ["patch"],
    },
    "annotations": [
        "BOUND_NAMESPACE_LABEL", "BOUND_POOL_ANNOTATION",
        "BOUND_SLICE_ANNOTATION", "CHECKPOINT_TOKEN_ANNOTATION",
        "ELASTIC_ACK_ANNOTATION", "ELASTIC_ANNOTATION",
        "ELASTIC_CURRENT_SLICES_ANNOTATION", "ELASTIC_RESIZE_ANNOTATION",
        "ELASTIC_RESIZE_STARTED_AT_ANNOTATION", "ELASTIC_SLICES_ANNOTATION",
        "ELASTIC_TARGET_ANNOTATION",
        "MIGRATION_STARTED_AT_ANNOTATION", "MIGRATION_STATE_ANNOTATION",
        "NOTEBOOK_NAME_LABEL", "POOL_BIND_MISS_ANNOTATION",
        "QUARANTINE_ANNOTATION", "REPAIR_FAILURES_ANNOTATION",
        "REPAIR_SCALE_DOWN_ANNOTATION", "REPAIR_STARTED_AT_ANNOTATION",
        "SCHED_PREEMPTED_ANNOTATION",
        "SLICE_HEALTH_ANNOTATION", "SLICE_HEALTH_REASON_ANNOTATION",
        "STOP_ANNOTATION", "TRACE_CONTEXT_ANNOTATION",
    ],
}

# Protocol state machines: every annotation this reconciler writes, with
# its states, transitions and their effects, kept as data as the reference
# declares them (its ci/protocol_gate.py and ci/protocol_check.py check the
# reference's copy). Update the declarations and the code together.
PROTOCOL = [
    {
        "machine": "slice-health",
        "doc": "Slice-atomic repair with poison-pill quarantine; state "
               "rides the Notebook so restarts/failover resume it.",
        "owner": "slicerepair",
        "carrier": {"object": "Notebook",
                    "annotation": "SLICE_HEALTH_ANNOTATION"},
        "fresh_reads": "echo-tracking",
        "states": {"Healthy": None, "Degraded": "Degraded",
                   "Repairing": "Repairing", "Quarantined": "Quarantined"},
        "initial": "Healthy",
        "terminal": ["Healthy", "Quarantined"],
        "aux": {
            "SLICE_HEALTH_REASON_ANNOTATION": "why not Healthy",
            "REPAIR_SCALE_DOWN_ANNOTATION":
                "hold-at-0 handshake with the core's desired_replicas",
            "REPAIR_STARTED_AT_ANNOTATION": "repair timeout clock",
            "REPAIR_FAILURES_ANNOTATION":
                "sliding quarantine window (survives restarts)",
            "QUARANTINE_ANNOTATION":
                "poison pill; cleared only by an operator",
        },
        "transitions": [
            {"from": "Healthy", "to": "Degraded",
             "trigger": "problem-detected",
             "effects": ["event:SliceDegraded"],
             "effects_idempotent": True},
            {"from": "Degraded", "to": "Repairing",
             "trigger": "backoff-elapsed",
             "effects": ["event:SliceRepairStarted"],
             "effects_idempotent": True},
            {"from": "Repairing", "to": "Healthy",
             "trigger": "workers-ready",
             "effects": ["event:SliceRepaired"],
             "effects_idempotent": True},
            {"from": "Repairing", "to": "Degraded",
             "trigger": "repair-timeout",
             "effects": ["event:SliceRepairFailed"],
             "effects_idempotent": True},
            {"from": "Degraded", "to": "Healthy",
             "trigger": "transient-recovery",
             "effects": ["event:SliceRecovered"],
             "effects_idempotent": True},
            {"from": ["Degraded", "Repairing"], "to": "Quarantined",
             "trigger": "failure-window-full",
             "effects": ["event:SliceQuarantined"],
             "effects_idempotent": True},
            {"from": "Quarantined", "to": "Healthy",
             "trigger": "operator-cleared",
             "effects": ["event:SliceQuarantineCleared"],
             "effects_idempotent": True},
            {"from": ["Degraded", "Repairing"], "to": "Healthy",
             "trigger": "notebook-stopped",
             "doc": "deliberate scale-to-0 drops transient repair state"},
            {"from": ["Healthy", "Degraded", "Repairing"],
             "to": "Quarantined", "trigger": "quarantine-normalize",
             "doc": "quarantine annotation present (restored from backup "
                    "or the patch raced): quarantined means NOT repairing"},
        ],
    },
    {
        "machine": "migration",
        "doc": "Checkpoint-based move of a pool-bound notebook; every "
               "state is persisted BEFORE its driver side effect so a "
               "crash resumes exactly where it left off.",
        "owner": "slicerepair",
        "carrier": {"object": "Notebook",
                    "annotation": "MIGRATION_STATE_ANNOTATION"},
        "fresh_reads": "echo-tracking",
        "states": {"Idle": None, "Checkpointing": "Checkpointing",
                   "Binding": "Binding", "Resuming": "Resuming"},
        "initial": "Idle",
        "terminal": ["Idle"],
        "aux": {
            "MIGRATION_STARTED_AT_ANNOTATION": "migration timeout clock",
            "CHECKPOINT_TOKEN_ANNOTATION":
                "kept across fallback: restore-at-boot picks it up",
        },
        "transitions": [
            {"from": "Idle", "to": "Checkpointing",
             "trigger": "bound-slice-degraded",
             "effects": ["event:NotebookMigrationStarted",
                         "call:migrator.checkpoint"],
             "effects_idempotent": True},
            {"from": "Checkpointing", "to": "Binding",
             "trigger": "checkpoint-taken",
             "doc": "the unbind rides the SAME patch — atomic handoff to "
                    "the pool controller's re-bind queue"},
            {"from": "Binding", "to": "Resuming",
             "trigger": "rebound-and-ready",
             "effects": ["call:migrator.resume"],
             "effects_idempotent": True},
            {"from": "Resuming", "to": "Idle", "trigger": "resumed",
             "effects": ["event:NotebookMigrated"],
             "effects_idempotent": True},
            {"from": ["Checkpointing", "Binding", "Resuming"],
             "to": "Idle", "trigger": "fallback",
             "effects": ["event:NotebookMigrationFallback"],
             "effects_idempotent": True,
             "doc": "timeout / bind-miss / driver failure: release the "
                    "pool path, cold-roll a dedicated StatefulSet — "
                    "preemption must never lose the notebook"},
        ],
    },
    {
        "machine": "elastic-resize",
        "doc": "Elastic shrink/grow handshake with the trainer-side agent "
               "(runtime/elastic.py): the controller never releases a "
               "slice the runtime has not confirmed it drained off, and "
               "never counts a resize done before the runtime resharded. "
               "Each controller advance waits on the agent echoing the "
               "carrier state into the ack annotation.",
        "owner": "slicerepair",
        "carrier": {"object": "Notebook",
                    "annotation": "ELASTIC_RESIZE_ANNOTATION"},
        "fresh_reads": "echo-tracking",
        "states": {"Stable": None, "Draining": "Draining",
                   "Resharding": "Resharding"},
        "initial": "Stable",
        "terminal": ["Stable"],
        "aux": {
            "ELASTIC_TARGET_ANNOTATION":
                "slice count this cycle resizes to",
            "ELASTIC_CURRENT_SLICES_ANNOTATION":
                "controller-written slice count, stamped at cycle "
                "completion so the pre-resize count stays readable for "
                "the whole handshake",
            "ELASTIC_RESIZE_STARTED_AT_ANNOTATION":
                "handshake timeout clock (dead-agent bound)",
            "ELASTIC_ACK_ANNOTATION":
                "agent-written echo of the carrier; the controller only "
                "clears it or latches 'Aborted' on timeout — a latch only "
                "a LIVE agent clears, so a dead agent cannot re-trigger "
                "an endless resize loop",
        },
        "handoffs": [
            {"writer": "scheduler", "annotation": "ELASTIC_RESIZE_ANNOTATION",
             "reason": "tier preemption enters Draining through THIS "
                       "handshake — a preempted trainer is drained to a "
                       "durable save and resharded, never killed; from "
                       "the stamp on, this controller drives the cycle"},
            {"writer": "scheduler", "annotation": "ELASTIC_TARGET_ANNOTATION",
             "reason": "preemption target (current-1) rides the same "
                       "patch as the Draining stamp"},
            {"writer": "scheduler",
             "annotation": "ELASTIC_RESIZE_STARTED_AT_ANNOTATION",
             "reason": "preemption arms the SAME dead-agent timeout clock "
                       "so a dark trainer falls back to the repair roll"},
            {"writer": "scheduler", "annotation": "ELASTIC_ACK_ANNOTATION",
             "reason": "cleared with the Draining stamp so a stale ack "
                       "from the previous cycle cannot fast-forward this "
                       "one"},
        ],
        "transitions": [
            {"from": "Stable", "to": "Draining",
             "trigger": "elastic-resize-needed",
             "effects": ["event:ElasticResizeStarted"],
             "effects_idempotent": True},
            {"from": "Draining", "to": "Resharding",
             "trigger": "runtime-drained",
             "doc": "agent acked Draining: queue drained, checkpoint "
                    "durable — the slice may now be released"},
            {"from": "Resharding", "to": "Stable",
             "trigger": "runtime-resharded",
             "effects": ["event:ElasticResized"],
             "effects_idempotent": True},
            {"from": ["Draining", "Resharding"], "to": "Stable",
             "trigger": "resize-timeout-or-agent-dead",
             "effects": ["event:ElasticResizeAborted"],
             "effects_idempotent": True,
             "doc": "no ack within elastic_resize_timeout_s: latch the "
                    "Aborted ack and fall back to the plain repair roll"},
        ],
    },
]


MIGRATION_CHECKPOINTING = "Checkpointing"
MIGRATION_BINDING = "Binding"
MIGRATION_RESUMING = "Resuming"

# elastic-resize machine states (carrier absent = Stable) and the ack
# latch value the controller stamps when the agent goes dark
ELASTIC_DRAINING = "Draining"
ELASTIC_RESHARDING = "Resharding"
ELASTIC_ABORTED = "Aborted"

log = logging.getLogger("kubeflow_tpu_torch.slicerepair")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.slicerepair")

HEALTHY = None  # annotation absent
DEGRADED = "Degraded"
REPAIRING = "Repairing"
QUARANTINED = "Quarantined"

# containerStatuses restart count at which a worker counts as crashlooping
# even before the kubelet labels it CrashLoopBackOff
CRASHLOOP_RESTARTS = 3


def node_problem(node: dict | None) -> tuple[str, str] | None:
    """Why a node can't host slice workers: (reason, detail) or None.
    Stricter than the kubelet's doom check (cluster/kubelet.node_doomed):
    a NoSchedule preemption NOTICE leaves pods running — the kubelet does
    not evict for it — but for a slice the notice alone is Degraded,
    because the repair must roll the slice off the node BEFORE the
    termination lands mid-step."""
    if node is None:
        return ("NodeGone", "node object deleted")
    for taint in k8s.get_in(node, "spec", "taints", default=[]) or []:
        if taint.get("key") == names.PREEMPTION_TAINT_KEY:
            return ("NodePreempted", "impending termination notice")
        if taint.get("effect") == "NoExecute":
            return ("NodeNotReady", f"NoExecute taint {taint.get('key')}")
    for cond in k8s.get_in(node, "status", "conditions", default=[]) or []:
        if cond.get("type") == "Ready" and cond.get("status") != "True":
            return ("NodeNotReady",
                    cond.get("reason") or "Ready condition not True")
    return None


def slice_health(notebook: dict) -> str | None:
    """Current health state of a notebook's slice (annotation-carried):
    "Degraded" / "Repairing" / "Quarantined", or None = healthy. The
    culler consults this to pause the idle clock mid-repair."""
    return k8s.get_annotation(notebook, names.SLICE_HEALTH_ANNOTATION)


def elastic_resize_state(notebook: dict) -> str | None:
    """Current elastic-resize handshake state (annotation-carried):
    "Draining" / "Resharding", or None = Stable (no resize in flight)."""
    return k8s.get_annotation(notebook, names.ELASTIC_RESIZE_ANNOTATION)


def _int_annotation(notebook: dict, anno: str, default: int) -> int:
    raw = k8s.get_annotation(notebook, anno)
    try:
        return max(1, int(raw)) if raw is not None else default
    except (TypeError, ValueError):
        return default


class SliceRepairReconciler:
    name = "slice-repair-controller"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock=time.time, rng: random.Random | None = None,
                 migrator=None):
        from ..cluster.echo import EchoTrackingClient
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        self.clock = clock
        self._rng = rng or random.Random()
        if migrator is None:
            from ..runtime.migrate import SimulatedMigrationDriver
            migrator = SimulatedMigrationDriver()
        # checkpoint-migration driver (runtime/migrate.py): checkpoints the
        # runtime on a dying BOUND slice and resumes it on the re-bound one
        self.migrator = migrator
        self.recorder = events.EventRecorder(client, component=self.name)
        self._read_cache = None
        # per-slice decorrelated-jitter backoff state (in-memory is fine:
        # a restarted controller starting its first repair immediately is
        # correct — the QUARANTINE window, which must survive restarts,
        # rides the repair-failures annotation instead)
        self._lock = threading.Lock()
        self._backoff: dict[tuple[str, str], float] = {}
        self._not_before: dict[tuple[str, str], float] = {}
        # label combinations the slice_degraded gauge has ever exported —
        # a state draining to zero must overwrite its stale sample
        self._gauge_seen: set[tuple[str, str]] = set()
        self.repairs_total = self.metrics.counter(
            "slice_repairs_total",
            "Slice-atomic repair attempts started, by namespace and "
            "triggering reason.")
        self.repair_duration = self.metrics.histogram(
            "slice_repair_duration_seconds",
            "Wall time from repair start to all workers Ready again, by "
            "namespace.")
        self.quarantines_total = self.metrics.counter(
            "slice_quarantines_total",
            "Slices quarantined after repeated failed repairs, by "
            "namespace.")
        self.degraded_gauge = self.metrics.gauge(
            "slice_degraded",
            "Slices currently not healthy, by namespace and state "
            "(Degraded/Repairing/Quarantined).")
        self.migrations_total = self.metrics.counter(
            "notebook_migrations_total",
            "Checkpoint-based notebook migrations between pool slices, by "
            "outcome (success / fallback).")
        self.elastic_resizes_total = self.metrics.counter(
            "elastic_resizes_total",
            "Elastic resize handshake outcomes, by namespace and outcome "
            "(shrink / grow / abort).")
        self.metrics.on_scrape(self._scrape_health)

    # ------------------------------------------------------------- wiring
    def setup(self, mgr: Manager) -> None:
        """Own Notebook keys; map Pods via the notebook-name label and
        Nodes via the pods bound to them (the Node kind was in the
        restmapper/store all along but unwatched — this is the controller
        that closes that loop)."""
        mgr.register(self)
        from ..cluster.cache import CachingClient
        if mgr.read_cache is not None:
            cache, tee = mgr.read_cache, None
        else:
            cache = CachingClient(self.client, disable_for=(),
                                  auto_informer=False)
            tee = cache.feed
        self._read_cache = cache
        ne = self.client.not_echo
        mgr.watch(api.KIND, self.name, tee=tee, predicate=ne)
        # bound-aware: pool-bound workers live in the pool namespace but
        # their health belongs to a Notebook elsewhere
        mgr.watch("Pod", self.name, mapper=pool_api.pod_notebook_mapper,
                  tee=tee)
        mgr.watch("Node", self.name, mapper=self._node_requests, tee=tee)
        for kind in (api.KIND, "Pod", "Node"):
            try:
                cache.backfill(kind)
            except Exception:  # noqa: BLE001 — degrade to live reads
                log.warning("read-cache backfill for %s failed; reads "
                            "stay live", kind, exc_info=True)

    def _reader(self):
        return self._read_cache or self.client

    def _node_requests(self, node: dict) -> list[Request]:
        """Node event → the notebooks with slice workers bound to it
        (cache.pods_on_node: the by-field ``spec.nodeName`` index when the
        reader carries one, O(pods on THIS node))."""
        from ..cluster.cache import pods_on_node
        out, seen = [], set()
        for pod in pods_on_node(self._reader(), k8s.name(node)):
            nb = k8s.get_label(pod, names.NOTEBOOK_NAME_LABEL)
            # a bound pool pod's notebook lives in the bound namespace,
            # not the pool namespace the pod runs in
            ns = k8s.get_label(pod, names.BOUND_NAMESPACE_LABEL) or \
                k8s.namespace(pod)
            key = (ns, nb)
            if nb and key not in seen:
                seen.add(key)
                out.append(Request(*key))
        return out

    def _scrape_health(self) -> None:
        """slice_degraded is computed at scrape time from the (cached)
        Notebook population — the same shape as notebook_running."""
        reader = self._reader()
        counts: dict[tuple[str, str], int] = {}
        for nb in reader.list(api.KIND):
            state = slice_health(nb)
            if state:
                key = (k8s.namespace(nb), state)
                counts[key] = counts.get(key, 0) + 1
        for key in self._gauge_seen | set(counts):
            self.degraded_gauge.set(counts.get(key, 0),
                                    {"namespace": key[0], "state": key[1]})
        self._gauge_seen |= set(counts)

    # ---------------------------------------------------------- reconcile
    def reconcile(self, req: Request) -> Result | None:
        notebook = self.client.get_or_none(api.KIND, req.namespace, req.name)
        key = (req.namespace, req.name)
        if notebook is None or k8s.is_deleting(notebook):
            with self._lock:
                self._backoff.pop(key, None)
                self._not_before.pop(key, None)
            return None
        try:
            slice_spec = parse_slice_request(
                k8s.get_in(notebook, "metadata", "annotations", default={}))
        except GpuRequestError:
            return None  # admission rejects these; nothing to repair
        if slice_spec is None:
            return None  # CPU notebook: no slice semantics

        state = slice_health(notebook)
        quarantined = k8s.get_annotation(notebook,
                                         names.QUARANTINE_ANNOTATION)

        # user stopped the notebook: the slice is deliberately at 0 — drop
        # transient repair state (quarantine, if any, stays: it is cleared
        # only by the operator)
        if k8s.get_annotation(notebook, names.STOP_ANNOTATION) is not None:
            self._patch(notebook, {
                names.SLICE_HEALTH_ANNOTATION:
                    QUARANTINED if quarantined else None,
                names.SLICE_HEALTH_REASON_ANNOTATION:
                    None if not quarantined else k8s.get_annotation(
                        notebook, names.SLICE_HEALTH_REASON_ANNOTATION),
                names.REPAIR_SCALE_DOWN_ANNOTATION: None,
                names.REPAIR_STARTED_AT_ANNOTATION: None,
            }, only_if_changed=True)
            self._reset_backoff(key)
            return None

        # ---------------------------------------------------- poison pill
        if quarantined is not None:
            if state != QUARANTINED:
                # normalize (e.g. annotation restored from backup, or the
                # quarantine patch raced): quarantined means NOT repairing
                self._patch(notebook, {
                    names.SLICE_HEALTH_ANNOTATION: QUARANTINED,
                    names.REPAIR_SCALE_DOWN_ANNOTATION: None,
                    names.REPAIR_STARTED_AT_ANNOTATION: None,
                })
            return None  # no repairs, no polling — events re-trigger us
        if state == QUARANTINED:
            # operator cleared the annotation: resume and RESET the window
            self._patch(notebook, {
                names.SLICE_HEALTH_ANNOTATION: None,
                names.SLICE_HEALTH_REASON_ANNOTATION: None,
                names.REPAIR_FAILURES_ANNOTATION: None,
            })
            self._reset_backoff(key)
            self.recorder.eventf(notebook, events.TYPE_NORMAL,
                                 "SliceQuarantineCleared",
                                 "quarantine annotation cleared; repairs "
                                 "resume with a fresh failure window")
            return Result(requeue_after=0)

        # pool-bound notebooks take the MIGRATION path (checkpoint → rebind
        # under the same hostname identity → resume) instead of an in-place
        # repair roll: the slice is pool infrastructure, and warm capacity
        # makes moving cheaper than rebuilding. A migration already in
        # flight stays owned by this branch even after the unbind.
        bound = pool_api.bound_slice_ref(notebook)
        mstate = k8s.get_annotation(notebook,
                                    names.MIGRATION_STATE_ANNOTATION)
        if bound is not None or mstate is not None:
            return self._reconcile_migration(notebook, slice_spec, bound,
                                             mstate, key)

        # pods/nodes read through the informer cache (index-served, zero
        # wire cost on the poll loop); the notebook itself stays on
        # self.client — in the wired composition that IS the cache, and a
        # standalone reconciler needs the freshest view of its own patches
        pods = self._reader().list("Pod", req.namespace,
                                   {names.NOTEBOOK_NAME_LABEL: req.name})
        problems = self._detect(notebook, pods)
        if not problems and state is None:
            # silent worker replacement: every pod Ready, but some (not
            # all) differ from the world-formation UIDs — the restarted
            # worker's communicator is orphaned; only a slice roll re-forms
            # the world. This latch closes the race where a node death +
            # kubelet self-heal completes faster than our event handling.
            replaced = self._worker_replacement(notebook, slice_spec, pods)
            if replaced:
                problems = [replaced]

        # elastic notebooks: a preemption notice shrinks the hybrid mesh
        # (checkpoint → drop a slice → keep training) instead of stopping
        # the run; the handshake machine owns the notebook while a resize
        # is in flight. Falls through (None) when there is nothing elastic
        # to do — the plain repair ladder below then proceeds as ever.
        eres = self._reconcile_elastic(notebook, problems, state, key)
        if eres is not None:
            return eres

        if state == REPAIRING:
            return self._continue_repair(notebook, slice_spec, problems,
                                         pods, key)

        if problems:
            reason, detail = problems[0]
            if state != DEGRADED:
                self._patch(notebook, {
                    names.SLICE_HEALTH_ANNOTATION: DEGRADED,
                    names.SLICE_HEALTH_REASON_ANNOTATION: reason,
                })
                self.recorder.eventf(
                    notebook, events.TYPE_WARNING, "SliceDegraded",
                    f"slice degraded ({reason}): {detail}")
            return self._maybe_start_repair(notebook, reason, detail, key)

        if state == DEGRADED:
            ready = sum(1 for p in pods if _pod_ready(p))
            if ready < slice_spec.num_workers:
                # no explicit signal left, but the slice never got back to
                # full readiness (e.g. a repair that replaced the pods with
                # ones that wedge mid-boot): still degraded — a premature
                # "recovered" here would reset the quarantine ladder and
                # let a broken image restart-storm forever
                reason = k8s.get_annotation(
                    notebook, names.SLICE_HEALTH_REASON_ANNOTATION) or \
                    "WorkersNotReady"
                return self._maybe_start_repair(
                    notebook, reason,
                    f"{ready}/{slice_spec.num_workers} workers ready", key)
            # transient — recovered without a repair (e.g. node flapped
            # back inside the grace window)
            self._patch(notebook, {
                names.SLICE_HEALTH_ANNOTATION: None,
                names.SLICE_HEALTH_REASON_ANNOTATION: None,
            })
            self._reset_backoff(key)
            self.recorder.eventf(notebook, events.TYPE_NORMAL,
                                 "SliceRecovered",
                                 "slice healthy again without repair")
            # echo-filtered watches won't re-deliver our own patch: an
            # elastic notebook below its requested slice count needs an
            # explicit requeue to start the grow-back cycle
            return self._elastic_followup(notebook)
        return None

    # ------------------------------------------------------------ elastic
    def _reconcile_elastic(self, notebook: dict, problems: list,
                           state: str | None,
                           key: tuple[str, str]) -> Result | None:
        """Drive the elastic-resize handshake:

            Stable ──(preemption notice / capacity freed)──▶ Draining
                   ──(agent ack: drained + durable save)──▶ Resharding
                   ──(agent ack: resharded, new slice count)──▶ Stable

        Shrink and grow run the SAME cycle — only the target differs.
        Every controller advance is gated on the trainer-side agent
        echoing the carrier state into the ack annotation; an agent that
        stays silent past ``elastic_resize_timeout_s`` aborts the cycle
        with the ``Aborted`` ack latch (only a live agent clears it), and
        the plain repair ladder takes the notebook from there.

        Returns None when the elastic path has nothing to do — the caller
        falls through to the ordinary repair logic."""
        elastic = elastic_resize_state(notebook)
        if k8s.get_annotation(notebook, names.ELASTIC_ANNOTATION) is None \
                and elastic is None:
            return None  # not an elastic notebook, nothing in flight
        poll = Result(requeue_after=self.config.slice_repair_poll_s)
        now = self.clock()
        requested = _int_annotation(notebook,
                                    names.ELASTIC_SLICES_ANNOTATION, 1)
        current = _int_annotation(
            notebook, names.ELASTIC_CURRENT_SLICES_ANNOTATION, requested)
        ack = k8s.get_annotation(notebook, names.ELASTIC_ACK_ANNOTATION)

        if elastic is not None:
            started_raw = k8s.get_annotation(
                notebook, names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION)
            try:
                started = float(started_raw) if started_raw else now
            except (TypeError, ValueError):
                started = now
            if now - started > self.config.elastic_resize_timeout_s:
                # dead agent: abort the cycle and LATCH the ack, so the
                # shrink/grow gates below stay closed until a live agent
                # clears it — without the latch an agentless notebook
                # would re-enter Draining forever
                self._patch(notebook, {
                    names.ELASTIC_RESIZE_ANNOTATION: None,
                    names.ELASTIC_TARGET_ANNOTATION: None,
                    names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION: None,
                    names.ELASTIC_ACK_ANNOTATION: ELASTIC_ABORTED,
                })
                self.elastic_resizes_total.inc(
                    {"namespace": key[0], "outcome": "abort"})
                self.recorder.eventf(
                    notebook, events.TYPE_WARNING, "ElasticResizeAborted",
                    f"trainer agent did not ack within "
                    f"{self.config.elastic_resize_timeout_s:.0f}s; "
                    f"falling back to the repair roll")
                return Result(requeue_after=0)
            if elastic == ELASTIC_DRAINING and ack == ELASTIC_DRAINING:
                # runtime drained + checkpoint durable: the slice may go
                self._patch(notebook, {
                    names.ELASTIC_RESIZE_ANNOTATION: ELASTIC_RESHARDING,
                })
                return poll
            if elastic == ELASTIC_RESHARDING and ack == ELASTIC_RESHARDING:
                target = _int_annotation(
                    notebook, names.ELASTIC_TARGET_ANNOTATION, current)
                outcome = "shrink" if target < current else "grow"
                # the controller is the single writer of current-slices:
                # stamping it HERE (not agent-side with the ack) keeps the
                # pre-resize count readable until the cycle completes —
                # which is also what makes the outcome label above correct
                self._patch(notebook, {
                    names.ELASTIC_CURRENT_SLICES_ANNOTATION: str(target),
                    names.ELASTIC_RESIZE_ANNOTATION: None,
                    names.ELASTIC_TARGET_ANNOTATION: None,
                    names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION: None,
                    names.ELASTIC_ACK_ANNOTATION: None,
                })
                self.elastic_resizes_total.inc(
                    {"namespace": key[0], "outcome": outcome})
                self.recorder.eventf(
                    notebook, events.TYPE_NORMAL, "ElasticResized",
                    f"runtime resharded onto {target} slice(s) "
                    f"({outcome}); training continued without restart")
                return Result(requeue_after=0)
            return poll  # waiting on the agent's ack

        if problems and state is None and current > 1 \
                and ack != ELASTIC_ABORTED:
            # shrink instead of stopping: Degraded and Draining persist in
            # ONE patch — a crash between two separate patches would leave
            # a Degraded notebook whose repair ladder races the elastic
            # cycle we intended. Both events follow the persist.
            reason, detail = problems[0]
            self._patch(notebook, {
                names.SLICE_HEALTH_ANNOTATION: DEGRADED,
                names.SLICE_HEALTH_REASON_ANNOTATION: reason,
                names.ELASTIC_RESIZE_ANNOTATION: ELASTIC_DRAINING,
                names.ELASTIC_TARGET_ANNOTATION: str(current - 1),
                names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION: "%.3f" % now,
                names.ELASTIC_ACK_ANNOTATION: None,
            })
            self.recorder.eventf(
                notebook, events.TYPE_WARNING, "SliceDegraded",
                f"slice degraded ({reason}): {detail}")
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "ElasticResizeStarted",
                f"shrinking {current} → {current - 1} slice(s) instead of "
                f"stopping ({reason})")
            return poll

        if not problems and state is None and current < requested \
                and ack != ELASTIC_ABORTED \
                and k8s.get_annotation(
                    notebook, names.SCHED_PREEMPTED_ANNOTATION) is None:
            # grow back: repair completed (or capacity freed) while the
            # run holds fewer slices than requested. The scheduler's
            # preemption hold blocks this gate — the reclaimed slice is
            # serving a higher tier; the hold's clearance (preemptor
            # released) is what re-opens grow-back.
            self._patch(notebook, {
                names.ELASTIC_RESIZE_ANNOTATION: ELASTIC_DRAINING,
                names.ELASTIC_TARGET_ANNOTATION: str(current + 1),
                names.ELASTIC_RESIZE_STARTED_AT_ANNOTATION: "%.3f" % now,
                names.ELASTIC_ACK_ANNOTATION: None,
            })
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "ElasticResizeStarted",
                f"growing {current} → {current + 1} slice(s) after "
                f"repair")
            return poll
        return None

    def _elastic_followup(self, notebook: dict) -> Result | None:
        """After a repair/recovery leaves the slice Healthy: requeue
        immediately if an elastic notebook still holds fewer slices than
        requested, so the grow-back cycle starts without waiting for an
        external event (our own patches are echo-filtered)."""
        if k8s.get_annotation(notebook, names.ELASTIC_ANNOTATION) is None:
            return None
        requested = _int_annotation(notebook,
                                    names.ELASTIC_SLICES_ANNOTATION, 1)
        current = _int_annotation(
            notebook, names.ELASTIC_CURRENT_SLICES_ANNOTATION, requested)
        if current < requested:
            return Result(requeue_after=0)
        return None

    # ---------------------------------------------------------- migration
    def _migration_span(self, notebook: dict, phase: str,
                        attributes: dict | None = None):
        """Span for one migration leg, parented on the notebook's carried
        lifecycle-trace context (TRACE_CONTEXT_ANNOTATION) so the stitched
        CR trace shows WHY a notebook went un-Ready and how long each
        migration phase took. A shared no-op context manager when tracing
        is off."""
        if not tracing.is_recording():
            return _TRACER.start_span(phase)  # no-op CM, zero alloc
        parent = tracing.parse_traceparent(
            k8s.get_annotation(notebook, names.TRACE_CONTEXT_ANNOTATION))
        attrs = {"k8s.namespace": k8s.namespace(notebook),
                 "k8s.name": k8s.name(notebook)}
        attrs.update(attributes or {})
        return _TRACER.start_span(f"repair.migrate.{phase}", attrs,
                                  parent=parent)

    def _reconcile_migration(self, notebook: dict, slice_spec: SliceSpec,
                             bound: tuple[str, str] | None,
                             mstate: str | None,
                             key: tuple[str, str]) -> Result | None:
        """Checkpoint-based migration of a pool-bound notebook:

            (problem detected) → Checkpointing → Binding → Resuming → done

        Each state is annotation-persisted BEFORE its side effect runs, so
        a controller crash resumes exactly where it left off (the driver
        steps are idempotent). Any failure or timeout falls back to the
        cold-roll path via a bind-miss — preemption must never lose
        the notebook, only its warm start."""
        now = self.clock()
        poll = Result(requeue_after=self.config.slice_repair_poll_s)
        reader = self._reader()
        pods = pool_api.bound_slice_pods(reader, bound) if bound else []
        state = slice_health(notebook)

        if mstate is None:
            problems = self._detect(notebook, pods)
            if not problems and state is None:
                # the silent worker-replacement latch applies to bound
                # slices too: every pod Ready but a PARTIAL UID mismatch
                # vs the world-formation baseline = an orphaned
                # communicator — migration re-forms the world on a fresh
                # slice
                replaced = self._worker_replacement(notebook, slice_spec,
                                                   pods)
                if replaced:
                    problems = [replaced]
            if not problems:
                if state is not None:
                    ready = sum(1 for p in pods if _pod_ready(p))
                    if ready < slice_spec.num_workers:
                        return poll  # still converging; stay Degraded
                    self._patch(notebook, {
                        names.SLICE_HEALTH_ANNOTATION: None,
                        names.SLICE_HEALTH_REASON_ANNOTATION: None,
                    })
                    self._reset_backoff(key)
                    self.recorder.eventf(
                        notebook, events.TYPE_NORMAL, "SliceRecovered",
                        "bound slice healthy again without migration")
                return None
            reason, detail = problems[0]
            if state != DEGRADED:
                self._patch(notebook, {
                    names.SLICE_HEALTH_ANNOTATION: DEGRADED,
                    names.SLICE_HEALTH_REASON_ANNOTATION: reason,
                })
                self.recorder.eventf(
                    notebook, events.TYPE_WARNING, "SliceDegraded",
                    f"bound slice degraded ({reason}): {detail}")
            # persist the migration intent FIRST, then checkpoint
            with self._migration_span(notebook, "start",
                                      {"reason": reason}):
                self._patch(notebook, {
                    names.MIGRATION_STATE_ANNOTATION:
                        MIGRATION_CHECKPOINTING,
                    names.MIGRATION_STARTED_AT_ANNOTATION: "%.3f" % now,
                })
                self.recorder.eventf(
                    notebook, events.TYPE_NORMAL, "NotebookMigrationStarted",
                    f"checkpointing runtime off degraded slice "
                    f"{bound[0]}/{bound[1]} ({reason})")
            mstate = MIGRATION_CHECKPOINTING

        started_raw = k8s.get_annotation(
            notebook, names.MIGRATION_STARTED_AT_ANNOTATION)
        try:
            started = float(started_raw) if started_raw else now
        except (TypeError, ValueError):
            started = now
        if now - started > self.config.pool_migration_timeout_s or \
                k8s.get_annotation(notebook,
                                   names.POOL_BIND_MISS_ANNOTATION):
            return self._migration_fallback(
                notebook, key, "MigrationTimeout"
                if not k8s.get_annotation(
                    notebook, names.POOL_BIND_MISS_ANNOTATION)
                else "NoWarmSlice")

        if mstate == MIGRATION_CHECKPOINTING:
            with self._migration_span(notebook, "checkpoint") as span:
                try:
                    token = self.migrator.checkpoint(self.client, notebook)
                except Exception as exc:  # noqa: BLE001 — any checkpoint
                    # failure (driver bug, unreadable state) must degrade to
                    # the cold roll, never wedge the notebook mid-migration
                    log.warning("checkpoint for %s/%s failed: %s",
                                key[0], key[1], exc)
                    span.record_exception(exc)
                    return self._migration_fallback(notebook, key,
                                                   "CheckpointFailed")
                # unbind: the pool controller drains/replaces the old slice
                # and re-binds us (migration re-binds queue first) under the
                # SAME slice-identity — TPU_WORKER_HOSTNAMES is preserved by
                # construction
                self._patch(notebook, {
                    names.MIGRATION_STATE_ANNOTATION: MIGRATION_BINDING,
                    names.CHECKPOINT_TOKEN_ANNOTATION: token,
                    names.BOUND_SLICE_ANNOTATION: None,
                    names.BOUND_POOL_ANNOTATION: None,
                })
            return poll

        if mstate == MIGRATION_BINDING:
            if bound is None:
                return poll  # waiting for the pool controller's re-bind
            ready = sum(1 for p in pods if _pod_ready(p))
            if ready < slice_spec.num_workers or \
                    self._detect(notebook, pods):
                return poll  # re-bound slice still rolling its identity in
            self._patch(notebook, {
                names.MIGRATION_STATE_ANNOTATION: MIGRATION_RESUMING})
            mstate = MIGRATION_RESUMING

        if mstate == MIGRATION_RESUMING:
            if bound is None:
                return poll
            token = k8s.get_annotation(
                notebook, names.CHECKPOINT_TOKEN_ANNOTATION) or ""
            with self._migration_span(
                    notebook, "resume",
                    {"slice": f"{bound[0]}/{bound[1]}"}) as span:
                try:
                    self.migrator.resume(self.client, notebook, token)
                except Exception as exc:  # noqa: BLE001 — same contract as
                    # checkpoint: fall back rather than wedge
                    log.warning("resume for %s/%s failed: %s",
                                key[0], key[1], exc)
                    span.record_exception(exc)
                    return self._migration_fallback(notebook, key,
                                                   "ResumeFailed")
                duration = max(now - started, 0.0)
                self._patch(notebook, {
                    names.MIGRATION_STATE_ANNOTATION: None,
                    names.MIGRATION_STARTED_AT_ANNOTATION: None,
                    names.CHECKPOINT_TOKEN_ANNOTATION: None,
                    names.SLICE_HEALTH_ANNOTATION: None,
                    names.SLICE_HEALTH_REASON_ANNOTATION: None,
                })
                span.set_attribute("migration.duration_s",
                                   round(duration, 3))
            self._reset_backoff(key)
            self.migrations_total.inc({"outcome": "success"})
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "NotebookMigrated",
                f"resumed on warm slice {bound[0]}/{bound[1]} after "
                f"{duration:.1f}s (identity preserved)")
            return None
        # unknown persisted state (operator edit): treat as failed
        return self._migration_fallback(notebook, key, "UnknownState")

    def _migration_fallback(self, notebook: dict, key: tuple[str, str],
                            reason: str) -> Result | None:
        """Migration could not complete (no warm capacity, checkpoint or
        resume failure, timeout): release the pool path entirely and let
        the core reconciler cold-roll a dedicated StatefulSet — the
        repair machinery owns the notebook from there. The checkpoint
        token is kept: a restore-at-boot can still pick it up."""
        self._patch(notebook, {
            names.MIGRATION_STATE_ANNOTATION: None,
            names.MIGRATION_STARTED_AT_ANNOTATION: None,
            names.BOUND_SLICE_ANNOTATION: None,
            names.BOUND_POOL_ANNOTATION: None,
            names.POOL_BIND_MISS_ANNOTATION: reason,
            names.SLICE_HEALTH_ANNOTATION: None,
            names.SLICE_HEALTH_REASON_ANNOTATION: None,
        })
        self._reset_backoff(key)
        self.migrations_total.inc({"outcome": "fallback"})
        self.recorder.eventf(
            notebook, events.TYPE_WARNING, "NotebookMigrationFallback",
            f"migration abandoned ({reason}); cold-rolling a dedicated "
            f"StatefulSet instead — runtime resumes from the last "
            f"checkpoint at boot")
        return Result(requeue_after=0)

    # ---------------------------------------------------------- detection
    def _detect(self, notebook: dict,
                pods: list[dict]) -> list[tuple[str, str]]:
        """Scan the slice's workers and their nodes. Returns
        [(reason, detail), ...]; empty = no problem. Pods still booting
        (no explicit Ready=False) are NOT problems — boot is the core
        reconciler's business, and flagging it would roll freshly-created
        slices forever."""
        problems: list[tuple[str, str]] = []
        nodes_seen: set[str] = set()
        for pod in pods:
            pod_name = k8s.name(pod)
            node_name = k8s.get_in(pod, "spec", "nodeName")
            if node_name and node_name not in nodes_seen:
                nodes_seen.add(node_name)
                node = self._reader().get_or_none("Node", "", node_name)
                prob = node_problem(node)
                if prob:
                    problems.append(
                        (prob[0], f"node {node_name}: {prob[1]}"))
            for cond in k8s.get_in(pod, "status", "conditions",
                                   default=[]) or []:
                if cond.get("type") == "Ready" and \
                        cond.get("status") == "False":
                    problems.append(
                        ("WorkerNotReady",
                         f"worker {pod_name} Ready=False "
                         f"({cond.get('reason', '')})"))
            for cs in k8s.get_in(pod, "status", "containerStatuses",
                                 default=[]) or []:
                waiting = k8s.get_in(cs, "state", "waiting", "reason")
                if waiting == "CrashLoopBackOff" or \
                        int(cs.get("restartCount", 0)) >= CRASHLOOP_RESTARTS:
                    problems.append(
                        ("WorkerCrashLoop",
                         f"worker {pod_name} container "
                         f"{cs.get('name', '')} crashlooping"))
        return problems

    def _worker_replacement(self, notebook: dict, slice_spec: SliceSpec,
                            pods: list[dict]) -> tuple[str, str] | None:
        """Compare live pod UIDs against status.workerUIDs (stamped by the
        core reconciler atomically with SliceReady=True). Partial overlap =
        broken mesh; complete replacement = a consistent new mesh (restart
        annotation, cull/resume, our own repair roll) that the core
        refreshes the baseline for."""
        baseline = k8s.get_in(notebook, "status", "workerUIDs") or {}
        if not baseline or slice_spec.num_workers < 2:
            return None  # single-host: a replaced pod IS a whole new mesh
        ready = {k8s.name(p): k8s.uid(p) for p in pods if _pod_ready(p)}
        if len(ready) < slice_spec.num_workers or \
                set(ready) != set(baseline):
            return None  # not fully re-formed: the readiness paths own this
        changed = sorted(n for n in baseline if baseline[n] != ready[n])
        if changed and len(changed) < len(baseline):
            return ("WorkerReplaced",
                    f"worker(s) {', '.join(changed)} restarted since mesh "
                    f"formation; the mesh must re-form slice-atomically")
        return None

    # ------------------------------------------------------------- repair
    def _maybe_start_repair(self, notebook: dict, reason: str, detail: str,
                            key: tuple[str, str]) -> Result | None:
        now = self.clock()
        failures = self._failure_window(notebook, now)
        if len(failures) >= self.config.slice_repair_max_failures:
            return self._quarantine(notebook, reason, failures)
        with self._lock:
            not_before = self._not_before.get(key, 0.0)
        if now < not_before:
            return Result(requeue_after=max(not_before - now, 0.01))
        # start: hold the slice at 0 via the scale-down annotation; the
        # core reconciler scales the one StatefulSet (slice-atomic by
        # construction), and Pod DELETED events drive the next phase
        self._patch(notebook, {
            names.SLICE_HEALTH_ANNOTATION: REPAIRING,
            names.SLICE_HEALTH_REASON_ANNOTATION: reason,
            names.REPAIR_SCALE_DOWN_ANNOTATION: "true",
            names.REPAIR_STARTED_AT_ANNOTATION: "%.3f" % now,
        })
        self.repairs_total.inc({"namespace": key[0], "reason": reason})
        self.recorder.eventf(
            notebook, events.TYPE_NORMAL, "SliceRepairStarted",
            f"slice-atomic repair: rolling StatefulSet 0 -> full "
            f"({reason}: {detail})")
        return Result(requeue_after=self.config.slice_repair_poll_s)

    def _continue_repair(self, notebook: dict, slice_spec: SliceSpec,
                         problems: list, pods: list[dict],
                         key: tuple[str, str]) -> Result | None:
        now = self.clock()
        started_raw = k8s.get_annotation(notebook,
                                         names.REPAIR_STARTED_AT_ANNOTATION)
        try:
            started = float(started_raw) if started_raw else None
        except (TypeError, ValueError):
            started = None
        if started is None:
            # lost/corrupted start stamp (operator annotation edit, backup
            # restore): re-stamp NOW so the timeout clock is bounded from
            # here — without this the repair could poll forever, untimed,
            # unquarantinable
            started = now
            self._patch(notebook, {
                names.REPAIR_STARTED_AT_ANNOTATION: "%.3f" % now})
        poll = Result(requeue_after=self.config.slice_repair_poll_s)
        ns = key[0]

        if now - started > self.config.slice_repair_timeout_s:
            return self._repair_failed(notebook, key, now)

        if k8s.get_annotation(notebook,
                              names.REPAIR_SCALE_DOWN_ANNOTATION) is not None:
            if pods:
                return poll  # waiting for the slice-atomic reap
            # all workers gone together — release the hold; the core
            # reconciler scales straight back to the FULL worker count
            self._patch(notebook,
                        {names.REPAIR_SCALE_DOWN_ANNOTATION: None})
            return poll

        ready = sum(1 for p in pods if _pod_ready(p))
        if ready >= slice_spec.num_workers and not problems:
            duration = max(now - started, 0.0)
            self.repair_duration.observe(duration, {"namespace": ns})
            self._patch(notebook, {
                names.SLICE_HEALTH_ANNOTATION: None,
                names.SLICE_HEALTH_REASON_ANNOTATION: None,
                names.REPAIR_STARTED_AT_ANNOTATION: None,
            })
            self._reset_backoff(key)
            self.recorder.eventf(
                notebook, events.TYPE_NORMAL, "SliceRepaired",
                f"all {slice_spec.num_workers} workers ready again "
                f"after {duration:.1f}s")
            # an elastic notebook that shrank during the outage grows
            # back now that the slice is whole again
            return self._elastic_followup(notebook)
        return poll

    def _repair_failed(self, notebook: dict, key: tuple[str, str],
                       now: float) -> Result | None:
        """Repair timed out: record the failure in the sliding window and
        either quarantine (window full) or fall back to Degraded for the
        next backed-off attempt."""
        reason = k8s.get_annotation(
            notebook, names.SLICE_HEALTH_REASON_ANNOTATION) or "RepairTimeout"
        failures = self._failure_window(notebook, now)
        failures.append(now)
        if len(failures) >= self.config.slice_repair_max_failures:
            return self._quarantine(notebook, reason, failures)
        # persist the Degraded fallback AND the failure window before
        # emitting: a crash after the event but before the persist would
        # leave Repairing with a stale started-at stamp — the restarted
        # controller re-times-out immediately, re-emits, and the window
        # never fills, so quarantine never engages (event storm)
        self._patch(notebook, {
            names.SLICE_HEALTH_ANNOTATION: DEGRADED,
            names.SLICE_HEALTH_REASON_ANNOTATION: reason,
            names.REPAIR_SCALE_DOWN_ANNOTATION: None,
            names.REPAIR_STARTED_AT_ANNOTATION: None,
            names.REPAIR_FAILURES_ANNOTATION: _join_stamps(failures),
        })
        self.recorder.eventf(
            notebook, events.TYPE_WARNING, "SliceRepairFailed",
            f"repair did not converge within "
            f"{self.config.slice_repair_timeout_s:.0f}s "
            f"(failure {len(failures)}/"
            f"{self.config.slice_repair_max_failures} in window)")
        # decorrelated-jitter gate before the NEXT attempt — armed on
        # failure (a successful repair resets it), so a wedged slice
        # backs off instead of restart-storming
        with self._lock:
            self._not_before[key] = now + self._next_backoff_locked(key)
        return Result(requeue_after=self.config.slice_repair_poll_s)

    def _quarantine(self, notebook: dict, reason: str,
                    failures: list[float]) -> None:
        """Poison pill: stop repairing. The slice stays scaled up (a
        broken-but-present slice is debuggable; an endless restart storm
        is not) and nothing short of an operator deleting the quarantine
        annotation resumes repairs."""
        ns = k8s.namespace(notebook)
        self._patch(notebook, {
            names.SLICE_HEALTH_ANNOTATION: QUARANTINED,
            names.SLICE_HEALTH_REASON_ANNOTATION: reason,
            names.REPAIR_SCALE_DOWN_ANNOTATION: None,
            names.REPAIR_STARTED_AT_ANNOTATION: None,
            names.REPAIR_FAILURES_ANNOTATION: _join_stamps(failures),
            names.QUARANTINE_ANNOTATION:
                f"{k8s.now_iso()} {reason}: {len(failures)} failed "
                f"repairs in window",
        })
        self.quarantines_total.inc({"namespace": ns})
        self.recorder.eventf(
            notebook, events.TYPE_WARNING, "SliceQuarantined",
            f"{len(failures)} failed repairs inside "
            f"{self.config.slice_repair_window_s:.0f}s — repairs stopped; "
            f"clear the {names.QUARANTINE_ANNOTATION} annotation to resume")
        return None

    # ------------------------------------------------------------ helpers
    def _failure_window(self, notebook: dict, now: float) -> list[float]:
        raw = k8s.get_annotation(notebook,
                                 names.REPAIR_FAILURES_ANNOTATION) or ""
        stamps = []
        for part in raw.split(","):
            try:
                stamps.append(float(part))
            except ValueError:
                continue
        cutoff = now - self.config.slice_repair_window_s
        return [s for s in stamps if s >= cutoff]

    def _next_backoff_locked(self, key: tuple[str, str]) -> float:
        base = self.config.slice_repair_backoff_base_s
        cap = self.config.slice_repair_backoff_max_s
        prev = self._backoff.get(key, base)
        delay = min(cap, self._rng.uniform(base, max(prev * 3, base)))
        self._backoff[key] = delay
        return delay

    def _reset_backoff(self, key: tuple[str, str]) -> None:
        with self._lock:
            self._backoff.pop(key, None)
            self._not_before.pop(key, None)

    def _patch(self, notebook: dict, annotations: dict,
               only_if_changed: bool = False) -> None:
        if only_if_changed and all(
                k8s.get_annotation(notebook, k) == v
                for k, v in annotations.items()):
            return
        from ..cluster import errors
        try:
            self.client.patch(api.KIND, k8s.namespace(notebook),
                              k8s.name(notebook),
                              {"metadata": {"annotations": annotations}})
        except errors.NotFoundError:
            pass  # deleted mid-flight; the DELETE event cleans us up


def _pod_ready(pod: dict) -> bool:
    return k8s.condition_true(pod, "Ready")


def _join_stamps(stamps: list[float]) -> str:
    return ",".join("%.3f" % s for s in stamps)
