"""Warm slice pool controller: bind-on-create, release-on-cull, re-warm.

The port's copy of ``kubeflow_tpu/controllers/slicepool.py``, with the
same states, annotations, events, metrics and ``CONTRACT``/``PROTOCOL``
declarations, for H100 slices. A cold roll pays node provisioning, image
pull and the slice's NCCL world formation every time; a pool pre-rolls
that capacity and hands it over:

- For every ``SlicePool`` (api/slicepool.py) it pre-rolls
  ``spec.warmReplicas`` pool-owned StatefulSets (``warm_slice_statefulset``
  below: full replicas, the CUDA warm image, the H100 node selectors,
  ``nvidia.com/gpu`` requests and the worker env) to Ready in the pool
  namespace and holds them **Warm**.
- A Notebook created with a matching shape **binds** a Warm slice:
  annotation flip on both sides (Notebook ``bound-slice`` ↔ StatefulSet
  ``pool-bound-to``), notebook-name/bound-namespace labels on slice +
  pods (watch routing), and slice-identity adoption — the notebook's
  ``TPU_WORKER_HOSTNAMES`` identity is stamped at first bind and imposed
  on every slice bound later (checkpoint migration re-binds under the
  SAME identity). The core reconciler sees the annotation and repoints
  the notebook Service instead of rolling its own StatefulSet: CR→Ready
  collapses to one reconcile.
- Cull/stop/delete **releases** the slice: scrubbed (user labels/
  annotations stripped, pods deleted for a fresh boot — a re-bind never
  inherits another tenant's state or a stale idle clock) and re-warmed.
  A slice consumed by a migration off dying capacity is **Drained**
  (torn down, replaced by a fresh Warming slice) instead.
- When the pool is contended, a **fair-share admission queue** with
  per-namespace weights (weighted max-min, FIFO within a namespace;
  utils/fairness.py) decides who binds; losers are stamped with a
  bind-miss and cold-roll. Across pools, a request **first-fits** into
  the lowest-named pool whose accelerator matches and has capacity.

State rides annotations on the pool StatefulSets (restart/failover safe,
same discipline as the repair controller); the bound edge is recorded on
BOTH objects so a crash between the two patches heals from either side.
Events: ``SliceBound`` / ``SliceReleased`` / ``PoolBindMiss``. Metrics:
``slicepool_size{pool,state}``, ``slicepool_bind_latency_seconds``,
``slicepool_bind_misses_total{reason}``. The injected ``clock`` times
binds and ``wall_clock`` stamps the bind-pending heartbeat; a plain
``threading.Lock`` guards the controller's in-memory state.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import slicepool as pool_api
from ..api import types as api
from ..cluster import errors, events
from ..gpu.topology import SliceSpec, parse_short_name, parse_slice_request
from ..utils import k8s, names, tracing
from ..utils.config import ControllerConfig
from ..utils.fairness import fair_share_admit
from ..utils.metrics import MetricsRegistry
from .manager import Manager, Request, Result
from .notebook import gpu_resources, worker_env
from .slicerepair import node_problem


def slice_hostnames(spec: SliceSpec, sts_name: str, pool_ns: str) -> str:
    """The identity a slice is born with: its workers' stable DNS names
    through its own headless Service (single-host slices are
    ``localhost``, as the notebook's StatefulSet gets)."""
    if not spec.multi_host:
        return "localhost"
    return ",".join(spec.worker_hostnames(sts_name, sts_name, pool_ns))


def warm_slice_statefulset(pool: dict, spec: SliceSpec, pool_ns: str,
                           name: str, image: str) -> dict:
    """The StatefulSet that pre-rolls slice ``name`` of ``pool`` to full
    replicas with the warm ``image``, a CUDA one. The name is the caller's
    (``_create_warm_slice`` picks the lowest free ``<pool>-wN``); its
    selector, pod label and worker env are all right in this one
    object."""
    if len(name) > names.MAX_STS_NAME_LENGTH:
        raise ValueError(f"slice name {name!r} is longer than "
                         f"{names.MAX_STS_NAME_LENGTH} characters")
    pool_name = k8s.name(pool)
    container = {"name": "warm-slice", "image": image,
                 "resources": gpu_resources(spec)}
    worker_env(container, spec, slice_hostnames(spec, name, pool_ns))
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": name,
            "namespace": pool_ns,
            "labels": {names.POOL_LABEL: pool_name,
                       "statefulset": name,
                       names.TPU_SLICE_LABEL: spec.short_name},
            "annotations": {
                names.POOL_STATE_ANNOTATION: names.POOL_STATE_WARMING},
        },
        "spec": {
            "replicas": spec.num_workers,
            "selector": {"matchLabels": {"statefulset": name}},
            "serviceName": name,
            "podManagementPolicy": "Parallel",
            "template": {
                "metadata": {"labels": {names.POOL_LABEL: pool_name,
                                        "statefulset": name}},
                "spec": {
                    "nodeSelector": dict(spec.node_selectors()),
                    "containers": [container],
                },
            },
        },
    }


# API effect contract: what this reconciler reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py checks the
# reference's copy); update it with the code.
CONTRACT = {
    "role": "reconciler",
    "primary": "SlicePool",
    "reads": ["Node", "Notebook", "Pod", "SlicePool", "StatefulSet"],
    "watches": ["Notebook", "Pod", "SlicePool", "StatefulSet"],
    "writes": {
        "Event": ["create"],
        "Notebook": ["patch"],
        "Pod": ["delete", "patch"],
        "Service": ["create", "delete"],
        "SlicePool": ["update_status"],
        "StatefulSet": ["create", "delete", "patch", "update"],
    },
    "annotations": [
        "BOUND_NAMESPACE_LABEL", "BOUND_POOL_ANNOTATION",
        "BOUND_SLICE_ANNOTATION", "MIGRATION_STATE_ANNOTATION",
        "NOTEBOOK_NAME_LABEL", "POD_INDEX_LABEL", "POOL_BIND_MISS_ANNOTATION",
        "POOL_BIND_PENDING_ANNOTATION", "POOL_BOUND_TO_ANNOTATION",
        "POOL_LABEL", "POOL_STATE_ANNOTATION", "SLICE_IDENTITY_ANNOTATION",
        "STOP_ANNOTATION", "TPU_SLICE_LABEL", "TRACE_CONTEXT_ANNOTATION",
    ],
    "unwatched_writes": {
        "Service": "headless per-slice Service is create-once and deleted "
            "with its StatefulSet",
    },
    "cross_namespace": {
        "Notebook": "bound-mode bind/unbind patches into the notebook's "
            "namespace",
        "Pod": "repair evicts bound-notebook pods in their namespace",
        "Service": "per-slice headless Service lands in the bound namespace",
        "StatefulSet": "warm slices materialize in the pool-configured "
            "namespace",
    },
}

# Protocol state machine: the pool slice's states, transitions and their
# effects, kept as data as the reference declares it (its
# ci/protocol_gate.py and ci/protocol_check.py check the reference's
# copy). Update the declaration and the code together.
PROTOCOL = [
    {
        "machine": "pool-slice",
        "doc": "Warm-slice lifecycle on the pool StatefulSet; the bound "
               "edge is mirrored on the Notebook so a crash between the "
               "two bind patches heals from either side.",
        "owner": "slicepool",
        "carrier": {"object": "StatefulSet",
                    "annotation": "POOL_STATE_ANNOTATION"},
        "fresh_reads": "optimistic-concurrency",
        "states": {"Warming": "Warming", "Warm": "Warm", "Bound": "Bound",
                   "Draining": "Draining", "Gone": "__deleted__"},
        "initial": "Warming",
        "terminal": ["Warm", "Bound", "Gone"],
        "aux": {
            "POOL_BOUND_TO_ANNOTATION": "slice-side half of the bound edge",
            "BOUND_SLICE_ANNOTATION":
                "notebook-side half of the bound edge",
            "BOUND_POOL_ANNOTATION": "which pool owns the bound slice",
            "SLICE_IDENTITY_ANNOTATION":
                "TPU_WORKER_HOSTNAMES stamped at first bind, imposed on "
                "every re-bind (migration keeps the SAME identity)",
            "POOL_BIND_PENDING_ANNOTATION":
                "admission-queue heartbeat while the notebook waits",
            "POOL_BIND_MISS_ANNOTATION":
                "terminal pool verdict: the notebook cold-rolls",
        },
        "handoffs": [
            {"writer": "slicerepair", "annotation": "BOUND_SLICE_ANNOTATION",
             "reason": "migration Checkpointing->Binding clears the bound "
                       "edge atomically with the state flip"},
            {"writer": "slicerepair", "annotation": "BOUND_POOL_ANNOTATION",
             "reason": "cleared with BOUND_SLICE on migration unbind"},
            {"writer": "slicerepair",
             "annotation": "POOL_BIND_MISS_ANNOTATION",
             "reason": "migration fallback stamps a miss so the notebook "
                       "cold-rolls instead of re-queueing"},
            {"writer": "notebook", "annotation": "POOL_BIND_MISS_ANNOTATION",
             "reason": "bind-wait timeout: the notebook gives up on the "
                       "pool and cold-rolls"},
        ],
        "transitions": [
            {"from": "Warming", "to": "Warm", "trigger": "workers-ready"},
            {"from": "Warm", "to": "Bound", "trigger": "notebook-admitted",
             "effects": ["event:SliceBound"], "effects_idempotent": True},
            {"from": "Bound", "to": "Warming", "trigger": "released-scrub",
             "effects": ["event:SliceReleased"],
             "effects_idempotent": True,
             "doc": "cull/stop/unbind: scrub tenant residue, delete pods "
                    "for a fresh boot, re-warm"},
            {"from": "Bound", "to": "Draining", "trigger": "doomed-capacity",
             "effects": ["call:_delete_slice", "event:SliceReleased"],
             "effects_idempotent": True,
             "doc": "slice consumed by a migration off dying capacity is "
                    "torn down, not re-warmed"},
            {"from": "Draining", "to": "Gone", "trigger": "draining-sweep",
             "via": "_delete_slice"},
            {"from": ["Warming", "Warm", "Bound"], "to": "Gone",
             "trigger": "pool-teardown", "via": "_delete_slice"},
        ],
    },
]


log = logging.getLogger("kubeflow_tpu_torch.slicepool")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.slicepool")


def notebook_trace_parent(notebook: dict) -> tracing.SpanContext | None:
    """The notebook's carried lifecycle-trace context
    (TRACE_CONTEXT_ANNOTATION), or None — cross-controller spans (bind,
    migration) parent on it so the CR→Ready trace stitches through them;
    None falls back to the calling reconcile's own span stack."""
    return tracing.parse_traceparent(
        k8s.get_annotation(notebook, names.TRACE_CONTEXT_ANNOTATION))


POOL_STATES = (names.POOL_STATE_WARMING, names.POOL_STATE_WARM,
               names.POOL_STATE_BOUND, names.POOL_STATE_DRAINING)

#: annotations a released slice keeps — everything else is tenant residue
#: the scrub strips (incl. any leaked activity/idle-clock annotations)
_POOL_KEEP_ANNOTATIONS = frozenset({
    names.POOL_STATE_ANNOTATION,
})


def pool_state(sts: dict) -> str:
    return k8s.get_annotation(sts, names.POOL_STATE_ANNOTATION) or \
        names.POOL_STATE_WARMING


class SlicePoolReconciler:
    name = "slice-pool-controller"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic, wall_clock=time.time):
        from ..cluster.echo import EchoTrackingClient
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        self.clock = clock
        # wall clock for the bind-pending heartbeat annotation: it is a
        # cross-controller epoch-seconds protocol (the notebook reconciler
        # compares it against ITS wall clock), so it cannot be monotonic —
        # but it can be injected, keeping bind-timeout tests sleepless
        self.wall_clock = wall_clock
        self.recorder = events.EventRecorder(client, component=self.name)
        self._read_cache = None
        self._lock = threading.Lock()
        # (ns, nb) → monotonic time first seen pending, for bind latency
        self._first_pending: dict[tuple[str, str], float] = {}
        # pending-scan gating: a pool scans the Notebook fleet only when a
        # Notebook event marked it dirty (the mapper fires for every
        # matching-topology event) or its last scan left a backlog
        # (admitted notebooks waiting on Warming slices) — the
        # poll-while-warming requeue must not walk the whole fleet at
        # poll frequency for a pool with nothing pending
        self._pending_dirty: set[str] = set()
        self._pending_backlog: set[str] = set()
        # pools that have been scanned at least once this process: a fresh
        # controller must scan every pool on first sight (notebooks that
        # went pending before we started never produce an event for us)
        self._pending_scanned: set[str] = set()
        self._gauge_seen: set[tuple[str, str]] = set()
        self.bind_latency = self.metrics.histogram(
            "slicepool_bind_latency_seconds",
            "Pending-notebook to warm-slice-bound latency, by pool.")
        self.bind_misses = self.metrics.counter(
            "slicepool_bind_misses_total",
            "Notebooks sent to the cold-roll path instead of a warm bind, "
            "by reason (PoolContended / BindTimeout / NoWarmSlice).")
        self.size_gauge = self.metrics.gauge(
            "slicepool_size",
            "Pool slices by pool and state "
            "(Warming / Warm / Bound / Draining).")
        self.metrics.on_scrape(self._scrape_size)

    # ------------------------------------------------------------- wiring
    def setup(self, mgr: Manager) -> None:
        """Own SlicePool keys; map pool StatefulSets/Pods back via the pool
        label and Notebooks to every matching pool. Registered with
        max_concurrent_reconciles=1: pools are few and serializing the
        controller makes bind admission single-writer by construction (two
        pools can otherwise race a double-bind that, while self-healing,
        wastes a warm slice for one round-trip)."""
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
        mgr.watch(pool_api.KIND, self.name, tee=tee, predicate=ne)
        mgr.watch("StatefulSet", self.name, mapper=self._pool_of_obj,
                  tee=tee, predicate=ne)
        mgr.watch("Pod", self.name, mapper=self._pool_of_obj, tee=tee)
        mgr.watch(api.KIND, self.name, mapper=self._pools_for_notebook,
                  tee=tee)
        for kind in (pool_api.KIND, api.KIND, "StatefulSet", "Pod"):
            try:
                cache.backfill(kind)
            except Exception:  # noqa: BLE001 — degrade to live reads
                log.warning("read-cache backfill for %s failed; reads "
                            "stay live", kind, exc_info=True)

    def _reader(self):
        return self._read_cache or self.client

    def _live_get(self, kind: str, namespace: str, name: str):
        """LIVE read for read-modify-update loops: after a 409 (the sim's
        status write races every slice edit) the cached copy may not have
        caught up, and resending its stale resourceVersion would burn every
        retry — the exact failure mode cache.live_reader exists for."""
        from ..cluster.cache import live_reader
        return lambda: live_reader(self.client).get_or_none(kind, namespace,
                                                            name)

    def _pool_of_obj(self, obj: dict) -> list[Request]:
        pool = k8s.get_label(obj, names.POOL_LABEL)
        return [Request("", pool)] if pool else []

    def _pools_for_notebook(self, nb: dict) -> list[Request]:
        """A Notebook event wakes every pool whose accelerator matches it
        (bind/release decisions); a DELETED frame may be a slim skeleton
        without annotations, so it wakes every pool (pools are few and the
        reconcile no-ops fast)."""
        try:
            spec = _notebook_slice_spec(nb)
        except Exception:  # noqa: BLE001 — malformed request: nothing to bind
            return []
        out = []
        bound_pool = k8s.get_annotation(nb, names.BOUND_POOL_ANNOTATION)
        if bound_pool:
            # the bound edge routes even when the pool CR is gone (its
            # teardown still owns releasing this notebook's slice)
            out.append(Request("", bound_pool))
        pools = self._reader().list(pool_api.KIND)
        if spec is None:
            if k8s.get_in(nb, "metadata", "annotations") is not None:
                return out  # full frame, CPU notebook: no pool interest
            out += [Request("", k8s.name(p)) for p in pools
                    if k8s.name(p) != bound_pool]
        else:
            out += [Request("", k8s.name(p)) for p in pools
                    if k8s.get_in(p, "spec", "accelerator")
                    == spec.short_name and k8s.name(p) != bound_pool]
        with self._lock:
            self._pending_dirty.update(r.name for r in out)
        return out

    def _scrape_size(self) -> None:
        counts: dict[tuple[str, str], int] = {}
        for sts in self._reader().list("StatefulSet", None,
                                       {names.POOL_LABEL: None}):
            key = (k8s.get_label(sts, names.POOL_LABEL), pool_state(sts))
            counts[key] = counts.get(key, 0) + 1
        for key in self._gauge_seen | set(counts):
            self.size_gauge.set(counts.get(key, 0),
                                {"pool": key[0], "state": key[1]})
        self._gauge_seen |= set(counts)

    def _prune_pending(self) -> None:
        """Drop bind-latency entries for notebooks deleted while waiting —
        without this, churny fleets leak one dict entry per deleted
        pending notebook for the controller's lifetime. Cached reads, so
        the sweep is O(pending backlog) with zero wire cost."""
        reader = self._reader()
        with self._lock:
            keys = list(self._first_pending)
        for key in keys:
            nb = reader.get_or_none(api.KIND, *key)
            if nb is None or k8s.get_annotation(
                    nb, names.POOL_BIND_MISS_ANNOTATION) is not None:
                # deleted, or the CORE stamped a BindTimeout miss (only
                # the pool-side miss path pops its own entry): either way
                # this notebook left the warm path — and a stale stamp
                # must not pollute bind latency if an operator later
                # clears the miss to retry
                with self._lock:
                    self._first_pending.pop(key, None)

    # ---------------------------------------------------------- reconcile
    def reconcile(self, req: Request) -> Result | None:
        pool = self.client.get_or_none(pool_api.KIND, "", req.name)
        slices = self._reader().list("StatefulSet", None,
                                     {names.POOL_LABEL: req.name})
        self._prune_pending()
        if pool is None or k8s.is_deleting(pool):
            return self._teardown(req.name, slices)
        spec = pool.get("spec") or {}
        slice_spec = parse_short_name(spec.get("accelerator", ""))
        pool_ns = spec.get("namespace") or self.config.pool_namespace
        target = int(spec.get("warmReplicas", 0))

        by_state: dict[str, list[dict]] = {s: [] for s in POOL_STATES}
        for sts in sorted(slices, key=k8s.name):
            by_state[pool_state(sts)].append(sts)

        # ------------------------------------------------ slice lifecycle
        for sts in by_state[names.POOL_STATE_DRAINING]:
            self._delete_slice(sts)
        for sts in by_state[names.POOL_STATE_WARMING]:
            ready = k8s.get_in(sts, "status", "readyReplicas", default=0)
            if ready >= slice_spec.num_workers:
                self._patch_sts_annotations(sts, {
                    names.POOL_STATE_ANNOTATION: names.POOL_STATE_WARM})
                by_state[names.POOL_STATE_WARM].append(sts)
        by_state[names.POOL_STATE_WARMING] = [
            s for s in by_state[names.POOL_STATE_WARMING]
            if k8s.get_in(s, "status", "readyReplicas", default=0)
            < slice_spec.num_workers]
        released = 0
        for sts in list(by_state[names.POOL_STATE_BOUND]):
            outcome = self._reconcile_bound_slice(pool, sts, slice_spec,
                                                  pool_ns)
            if outcome:
                by_state[names.POOL_STATE_BOUND].remove(sts)
                if outcome == "released":
                    released += 1  # scrubbed in place: re-warming, not gone

        # ------------------------------------------- admission + binding
        # binds run BEFORE replacement warming: a waiting notebook's
        # latency is the product metric; re-warm creation is background
        # capacity work
        with self._lock:
            scan = req.name in self._pending_dirty or \
                req.name in self._pending_backlog or \
                req.name not in self._pending_scanned
            self._pending_dirty.discard(req.name)
            self._pending_scanned.add(req.name)
        pending = self._pending_notebooks(req.name, slice_spec) if scan \
            else []
        # biddable capacity: live spares, slices released THIS pass (they
        # are already re-warming even though the pre-release snapshot
        # still shows them Bound), and the rebuild headroom the top-up
        # below will create for drained capacity — a notebook must never
        # eat a permanent bind-miss for a slice that is one poll away
        capacity = max(
            len(by_state[names.POOL_STATE_WARM]) +
            len(by_state[names.POOL_STATE_WARMING]) + released,
            target - len(by_state[names.POOL_STATE_BOUND]))
        weights = spec.get("weights") or {}
        spill: list[dict] = []
        if len(pending) > capacity:
            # migration re-binds hold FIRST claim on capacity (the repair
            # controller checkpointed against the promise of a warm
            # slice); fair share arbitrates only the remainder
            migrating = [nb for nb in pending if k8s.get_annotation(
                nb, names.MIGRATION_STATE_ANNOTATION)]
            fresh = [nb for nb in pending if k8s.get_annotation(
                nb, names.MIGRATION_STATE_ANNOTATION) is None]
            admitted = migrating[:capacity]
            rejected = migrating[capacity:]
            share, lost = fair_share_admit(
                fresh, weights, capacity - len(admitted))
            admitted += share
            for nb in rejected + lost:
                if self._other_matching_capacity(slice_spec, req.name):
                    # a later matching pool has spare capacity: leave the
                    # notebook pending — once THIS pool is exhausted,
                    # first-fit moves there and it binds warm instead of
                    # eating a permanent miss (the drain-runbook spill)
                    spill.append(nb)
                else:
                    self._bind_miss(nb, "PoolContended")
        else:
            admitted = pending
        warm_free = list(by_state[names.POOL_STATE_WARM])
        bound_now = 0
        deferred: list[tuple[dict, dict, str]] = []
        for nb in admitted:
            if not warm_free:
                break  # the rest wait for Warming slices to turn Warm
            done = self._bind(pool, nb, warm_free.pop(0), slice_spec,
                              pool_ns)
            if done is not None:  # None: the slice vanished mid-bind —
                deferred.append(done)  # the notebook stays pending
                bound_now += 1
        # deferred bind side effects — pod watch-routing labels and the
        # SliceBound events — land after EVERY admitted notebook has its
        # bind annotation: they are not on the CR→Ready critical path, and
        # inside the loop each one would tax every later bind's latency
        for nb, sts, identity in deferred:
            self._finish_bind(pool, nb, sts, identity)
        # admitted-but-waiting (slice still warming) and spill-waiting
        # notebooks get a liveness heartbeat: the core's bind-grace
        # timeout exists to detect a DEAD pool controller, and must not
        # cold-roll a notebook this controller is actively working on
        for nb in admitted[bound_now:] + spill:
            self._heartbeat_pending(nb)

        # ----------------------------------------------------- re-warming
        # warmReplicas is the CAPACITY the pool maintains: bound slices
        # count toward it, so a bind never triggers a replacement create
        # (no re-warm storm trailing every fan-out) — only capacity that
        # actually left the pool (drained doomed slices, a raised target)
        # is rebuilt. Just-bound slices are STILL in the Warm list (the
        # lists are this pass's inventory snapshot), so bound_now must
        # not be added on top — it would double-count them and under-
        # create replacements after a raised target.
        have = len(by_state[names.POOL_STATE_WARM]) + \
            len(by_state[names.POOL_STATE_WARMING]) + \
            len(by_state[names.POOL_STATE_BOUND]) + released
        # name allocation skips EVERY StatefulSet in the pool namespace,
        # not just this pool's: a foreign object (operator-created, or a
        # truncation-colliding sibling pool) squatting on "<pool>-wN"
        # must be walked past, not AlreadyExists-retried forever
        taken = {k8s.name(s)
                 for s in self._reader().list("StatefulSet", pool_ns)}
        taken |= {k8s.name(s) for s in slices}
        created = max(target - have, 0)
        for _ in range(created):
            taken.add(self._create_warm_slice(pool, slice_spec, pool_ns,
                                              taken))

        self._update_pool_status(pool, {
            "warm": len(by_state[names.POOL_STATE_WARM]) - bound_now,
            "warming": len(by_state[names.POOL_STATE_WARMING]),
            "bound": len(by_state[names.POOL_STATE_BOUND]) + bound_now,
            "pending": len(admitted) - bound_now,
        })
        with self._lock:
            if len(admitted) > bound_now or spill:
                self._pending_backlog.add(req.name)
            else:
                self._pending_backlog.discard(req.name)
        if by_state[names.POOL_STATE_WARMING] or released or created or \
                spill or len(admitted) > bound_now:
            return Result(requeue_after=self.config.pool_poll_s)
        return None

    # ----------------------------------------------------- bound lifecycle
    def _reconcile_bound_slice(self, pool: dict, sts: dict,
                               slice_spec: SliceSpec,
                               pool_ns: str) -> str | None:
        """Converge one Bound slice. Returns "released" (scrubbed in place,
        re-warming) or "drained" (doomed capacity, deleted) when it left
        the Bound state, None while the bind is healthy."""
        ref = k8s.get_annotation(sts, names.POOL_BOUND_TO_ANNOTATION) or ""
        nb_ns, _, nb_name = ref.partition("/")
        nb = self.client.get_or_none(api.KIND, nb_ns, nb_name) \
            if nb_ns and nb_name else None
        if nb is not None and not k8s.is_deleting(nb) and \
                k8s.get_annotation(nb, names.STOP_ANNOTATION) is None and \
                k8s.get_annotation(
                    nb, names.POOL_BIND_MISS_ANNOTATION) is None:
            # a bind-missed notebook is NEVER a healthy bind, even when
            # the bound-slice edge still points here: a migration
            # fallback can stamp the miss concurrently with our
            # _stamp_notebook_bound re-writing the edge, and the core
            # controller cold-rolls on the miss — holding the slice
            # Bound to it would leak the slice until an operator clears
            # the miss. Fall through and release/drain instead.
            bound = pool_api.bound_slice_ref(nb)
            if bound == (k8s.namespace(sts), k8s.name(sts)):
                return None  # healthy bind
            if bound is None and k8s.get_annotation(
                    nb, names.MIGRATION_STATE_ANNOTATION) is None and \
                    not self._slice_nodes_doomed(sts) and \
                    not _has_own_sts(self._reader(), nb):
                # crash between the two bind patches: the slice knows the
                # notebook but not vice versa — finish the bind from this
                # side (idempotent: the annotations converge either way).
                # NOT healed: doomed slices (the drain below owns those);
                # bind-missed notebooks never reach here (outer guard).
                self._stamp_notebook_bound(pool, nb, sts, slice_spec,
                                           pool_ns)
                healed = self.client.get_or_none(api.KIND, nb_ns, nb_name)
                if healed is not None:
                    self._finish_bind(pool, healed, sts, k8s.get_annotation(
                        healed, names.SLICE_IDENTITY_ANNOTATION) or "")
                return None
            # the notebook moved on (migration re-bind, or it cold-rolled):
            # this slice is released below
        if nb is not None and not k8s.is_deleting(nb) and \
                pool_api.bound_slice_ref(nb) == (k8s.namespace(sts),
                                                 k8s.name(sts)):
            # stopped (culled) while bound: unbind the notebook side too
            self._unbind_notebook(nb)
        # release: the notebook is gone/stopped/unbound. Capacity sitting
        # on doomed nodes is drained and replaced; healthy capacity is
        # scrubbed and re-warmed in place.
        if self._slice_nodes_doomed(sts):
            self._drain_slice(sts, nb)
            return "drained"
        self._release_slice(sts, slice_spec, pool_ns, nb)
        return "released"

    def _slice_nodes_doomed(self, sts: dict) -> bool:
        reader = self._reader()
        for pod in pool_api.bound_slice_pods(reader,
                                             (k8s.namespace(sts),
                                              k8s.name(sts))):
            node_name = k8s.get_in(pod, "spec", "nodeName")
            if node_name and node_problem(
                    reader.get_or_none("Node", "", node_name)):
                return True
        return False

    def _release_slice(self, sts: dict, slice_spec: SliceSpec, pool_ns: str,
                       notebook: dict | None) -> None:
        """Scrub + re-warm: strip every tenant trace (labels, propagated
        annotations — incl. any leaked last-activity, so a re-bind never
        inherits a stale idle clock), restore the slice's own hostname
        identity, and bounce the pods for a fresh boot."""
        ns, name = k8s.namespace(sts), k8s.name(sts)

        def scrub(obj: dict) -> bool:
            anns = {k: v for k, v in (k8s.annotations(obj) or {}).items()
                    if k in _POOL_KEEP_ANNOTATIONS}
            anns[names.POOL_STATE_ANNOTATION] = names.POOL_STATE_WARMING
            obj["metadata"]["annotations"] = anns
            for meta in (obj["metadata"],
                         obj["spec"]["template"].setdefault("metadata", {})):
                labels = {k: v for k, v in (meta.get("labels") or {}).items()
                          if k not in (names.NOTEBOOK_NAME_LABEL,
                                       names.BOUND_NAMESPACE_LABEL)}
                labels[names.POOL_LABEL] = k8s.get_label(sts,
                                                         names.POOL_LABEL)
                labels["statefulset"] = name
                meta["labels"] = labels
            obj["spec"]["template"]["metadata"].pop("annotations", None)
            container = (obj["spec"]["template"]["spec"]
                         .get("containers") or [{}])[0]
            k8s.upsert_env(container, "TPU_WORKER_HOSTNAMES",
                           slice_hostnames(slice_spec, name, pool_ns))
            return True

        errors.update_with_conflict_retry(
            self.client, self._live_get("StatefulSet", ns, name), scrub)
        for pod in pool_api.bound_slice_pods(self.client, (ns, name)):
            try:  # fresh boot — no tenant state survives into the next bind
                self.client.delete("Pod", ns, k8s.name(pod))
            except errors.NotFoundError:
                pass
        involved = notebook if notebook is not None else sts
        self.recorder.eventf(
            involved, events.TYPE_NORMAL, "SliceReleased",
            f"slice {ns}/{name} released back to the pool "
            f"(scrubbed, re-warming)")

    def _drain_slice(self, sts: dict, notebook: dict | None) -> None:
        """Tear down a slice whose capacity is dying (preempted/doomed
        nodes): it is never reused in place — the top-up path replaces it
        with a fresh Warming slice on live capacity. The Draining state
        is stamped BEFORE the delete so a crash in between leaves a
        slice the next reconcile's draining sweep finishes off (and that
        never counts as pool capacity meanwhile)."""
        self._patch_sts_annotations(sts, {
            names.POOL_STATE_ANNOTATION: names.POOL_STATE_DRAINING,
            names.POOL_BOUND_TO_ANNOTATION: None})
        self._delete_slice(sts)
        involved = notebook if notebook is not None else sts
        self.recorder.eventf(
            involved, events.TYPE_NORMAL, "SliceReleased",
            f"slice {k8s.namespace(sts)}/{k8s.name(sts)} drained "
            f"(doomed capacity); pool re-warms a replacement")

    def _delete_slice(self, sts: dict) -> None:
        ns, name = k8s.namespace(sts), k8s.name(sts)
        for kind in ("StatefulSet", "Service"):
            try:
                self.client.delete(kind, ns, name)
            except errors.NotFoundError:
                pass

    # ------------------------------------------------------------ warm-up
    def _create_warm_slice(self, pool: dict, slice_spec: SliceSpec,
                           pool_ns: str, taken: set[str]) -> str:
        """Pre-roll one slice to full replicas with the CUDA warm image
        (``config.tpu_default_image``, the port's CUDA default).
        Slice names are chosen UP FRONT (lowest free ``<pool>-wN``) rather
        than via GenerateName: the immutable selector, the statefulset pod
        label, and the worker-identity env must all be correct in the ONE
        create — a late selector fix would orphan pods the StatefulSet
        controller already rolled from the unlabeled template."""
        pool_name = k8s.name(pool)
        # len(taken)+1 candidates always contain a free name (pigeonhole)
        for i in range(len(taken) + 1):
            name = f"{pool_name[: names.MAX_STS_NAME_LENGTH - 5]}-w{i}"
            if name not in taken:
                break
        sts = warm_slice_statefulset(pool, slice_spec, pool_ns, name,
                                     self.config.tpu_default_image)
        try:
            self.client.create(sts)
        except errors.AlreadyExistsError:
            # raced a concurrent creator (its object reaches the cache in
            # a moment, after which the name is in `taken`); next
            # reconcile re-counts against the fresh inventory
            log.warning("pool %s: slice name %s/%s already exists; "
                        "skipping this top-up pass", pool_name, pool_ns,
                        name)
            return name
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name,
                "namespace": pool_ns,
                "labels": {names.POOL_LABEL: pool_name},
            },
            "spec": {
                "clusterIP": "None",
                "publishNotReadyAddresses": True,
                "selector": {"statefulset": name},
                "ports": [{"name": "tpu-dcn", "port": 8471,
                           "protocol": "TCP"}],
            },
        }
        try:
            self.client.create(svc)
        except errors.AlreadyExistsError:
            pass
        return name

    # ------------------------------------------------------------ binding
    def _pending_notebooks(self, pool_name: str,
                           slice_spec: SliceSpec) -> list[dict]:
        """Notebooks waiting for a slice of this pool's topology, migration
        re-binds first, then FIFO by creation. A notebook first-fits into
        the lowest-named matching pool that has capacity — this pool skips
        requests an earlier pool will serve. First-fit is computed ONCE
        per pass (it depends only on the topology, not the notebook): a
        100-notebook fan-out must not re-walk the pool inventory per
        pending notebook."""
        reader = self._reader()
        first_fit = self._first_fit_pool(slice_spec)
        if first_fit != pool_name:
            return []
        out = []
        for nb in reader.list(api.KIND):
            try:
                spec = _notebook_slice_spec(nb)
            except Exception:  # noqa: BLE001 — admission rejects these
                continue
            if spec is None or spec.short_name != slice_spec.short_name:
                continue
            anns = k8s.annotations(nb) or {}
            if names.BOUND_SLICE_ANNOTATION in anns or \
                    names.POOL_BIND_MISS_ANNOTATION in anns or \
                    names.STOP_ANNOTATION in anns or k8s.is_deleting(nb):
                continue
            if _has_own_sts(reader, nb):
                continue
            key = (k8s.namespace(nb), k8s.name(nb))
            with self._lock:
                self._first_pending.setdefault(key, self.clock())
            out.append(nb)
        out.sort(key=lambda nb: (
            0 if k8s.get_annotation(nb, names.MIGRATION_STATE_ANNOTATION)
            else 1,
            k8s.get_in(nb, "metadata", "creationTimestamp", default=""),
            k8s.namespace(nb), k8s.name(nb)))
        return out

    def _other_matching_capacity(self, slice_spec: SliceSpec,
                                 exclude: str) -> bool:
        """Whether another pool serving this topology has spare capacity —
        live Warm/Warming slices, or rebuild headroom under its target."""
        reader = self._reader()
        for pool in reader.list(pool_api.KIND):
            name = k8s.name(pool)
            if name == exclude or k8s.get_in(pool, "spec", "accelerator") \
                    != slice_spec.short_name:
                continue
            bound = 0
            for sts in reader.list("StatefulSet", None,
                                   {names.POOL_LABEL: name}):
                state = pool_state(sts)
                if state in (names.POOL_STATE_WARM,
                             names.POOL_STATE_WARMING):
                    return True
                if state == names.POOL_STATE_BOUND:
                    bound += 1
            if int(k8s.get_in(pool, "spec", "warmReplicas",
                              default=0)) > bound:
                return True
        return False

    def _heartbeat_pending(self, nb: dict) -> None:
        """Refresh the bind-pending heartbeat (wall-clock epoch seconds,
        same cross-controller convention as the repair annotations) when
        it is stale by half the grace window — one patch per half-window
        per waiting notebook, not one per poll."""
        raw = k8s.get_annotation(nb, names.POOL_BIND_PENDING_ANNOTATION)
        try:
            last = float(raw) if raw else 0.0
        except (TypeError, ValueError):
            last = 0.0
        now = self.wall_clock()
        if now - last < self.config.pool_bind_grace_s / 2:
            return
        try:
            self.client.patch(api.KIND, k8s.namespace(nb), k8s.name(nb), {
                "metadata": {"annotations": {
                    names.POOL_BIND_PENDING_ANNOTATION: "%.3f" % now}}})
        except errors.NotFoundError:
            pass

    def _unbind_notebook(self, nb: dict) -> None:
        """Clear the notebook side of a bind (slice ref, pool, identity).
        Identity clears with it — a stop/teardown kills the runtime, so
        the next bind starts a FRESH mesh on the new slice's own
        hostnames (instant; no identity-adoption pod roll), unlike a
        migration which must keep the identity alive."""
        try:
            self.client.patch(api.KIND, k8s.namespace(nb), k8s.name(nb),
                              {"metadata": {"annotations": {
                                  names.BOUND_SLICE_ANNOTATION: None,
                                  names.BOUND_POOL_ANNOTATION: None,
                                  names.SLICE_IDENTITY_ANNOTATION: None,
                              }}})
        except errors.NotFoundError:
            pass

    def _first_fit_pool(self, slice_spec: SliceSpec) -> str | None:
        """First-fit over the fleet's mixed-topology pools: the lowest-named
        pool whose accelerator matches AND that has Warm/Warming capacity;
        with none capacious, the lowest-named match (it re-warms first)."""
        reader = self._reader()
        matches = sorted((p for p in reader.list(pool_api.KIND)
                          if k8s.get_in(p, "spec", "accelerator")
                          == slice_spec.short_name), key=k8s.name)
        for pool in matches:
            for sts in reader.list("StatefulSet", None,
                                   {names.POOL_LABEL: k8s.name(pool)}):
                if pool_state(sts) in (names.POOL_STATE_WARM,
                                       names.POOL_STATE_WARMING):
                    return k8s.name(pool)
        return k8s.name(matches[0]) if matches else None

    def _bind(self, pool: dict, notebook: dict, sts: dict,
              slice_spec: SliceSpec, pool_ns: str) \
            -> tuple[dict, dict, str] | None:
        """``_bind_inner`` wrapped in a ``pool.bind`` span parented on the
        notebook's carried trace context — the bind leg of the stitched
        CR→Ready trace. Untraced runs skip straight through."""
        if not tracing.is_recording():
            return self._bind_inner(pool, notebook, sts, slice_spec, pool_ns)
        with _TRACER.start_span(
                "pool.bind",
                {"pool": k8s.name(pool),
                 "k8s.namespace": k8s.namespace(notebook),
                 "k8s.name": k8s.name(notebook),
                 "slice": f"{pool_ns}/{k8s.name(sts)}"},
                parent=notebook_trace_parent(notebook)) as span:
            out = self._bind_inner(pool, notebook, sts, slice_spec, pool_ns)
            span.set_attribute("bound", out is not None)
            return out

    def _bind_inner(self, pool: dict, notebook: dict, sts: dict,
                    slice_spec: SliceSpec, pool_ns: str) \
            -> tuple[dict, dict, str] | None:
        """The bind itself: slice-side annotations/labels (+ identity
        adoption when the notebook already HAS a mesh identity from a
        previous slice — the migration contract), then the notebook-side
        annotation that flips the core reconciler into bound mode.
        Returns (notebook, slice, identity) for _finish_bind's deferred
        side effects."""
        nb_ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        sts_name = k8s.name(sts)
        own_identity = slice_hostnames(slice_spec, sts_name, pool_ns)
        identity = k8s.get_annotation(
            notebook, names.SLICE_IDENTITY_ANNOTATION) or own_identity
        bind_labels = {names.NOTEBOOK_NAME_LABEL: nb_name,
                       names.BOUND_NAMESPACE_LABEL: nb_ns}
        if identity == own_identity:
            # first bind: annotations + labels only — ONE merge patch, no
            # pod roll, which is what makes bind-on-create one reconcile
            try:
                self.client.patch(
                    "StatefulSet", k8s.namespace(sts), sts_name,
                    {"metadata": {
                        "annotations": {
                            names.POOL_STATE_ANNOTATION:
                                names.POOL_STATE_BOUND,
                            names.POOL_BOUND_TO_ANNOTATION:
                                f"{nb_ns}/{nb_name}"},
                        "labels": dict(bind_labels)},
                     "spec": {"template": {"metadata": {
                         "labels": dict(bind_labels)}}}})
            except errors.NotFoundError:
                return None  # slice vanished mid-bind; notebook stays pending
        else:
            def stamp(obj: dict) -> bool:
                anns = obj["metadata"].setdefault("annotations", {})
                anns[names.POOL_STATE_ANNOTATION] = names.POOL_STATE_BOUND
                anns[names.POOL_BOUND_TO_ANNOTATION] = f"{nb_ns}/{nb_name}"
                for meta in (obj["metadata"], obj["spec"]["template"]
                             .setdefault("metadata", {})):
                    meta.setdefault("labels", {}).update(bind_labels)
                # identity adoption: the new slice presents the SAME
                # TPU_WORKER_HOSTNAMES the notebook's mesh formed on (the
                # template edit rolls the pods once — a bounded pause, the
                # price of moving, paid on warm capacity)
                container = (obj["spec"]["template"]["spec"]
                             .get("containers") or [{}])[0]
                k8s.upsert_env(container, "TPU_WORKER_HOSTNAMES", identity)
                return True
            updated = errors.update_with_conflict_retry(
                self.client,
                self._live_get("StatefulSet", k8s.namespace(sts), sts_name),
                stamp)
            if updated is None:
                # slice vanished or the write kept conflicting: the slice
                # side never learned about this bind, so stamping the
                # notebook would point it at an unbound (possibly
                # reusable-by-others) slice — leave it pending and retry
                return None
        self._stamp_notebook_bound(pool, notebook, sts, slice_spec, pool_ns,
                                   identity=identity)
        return (notebook, sts, identity)

    def _finish_bind(self, pool: dict, notebook: dict, sts: dict,
                     identity: str) -> None:
        """Off-critical-path bind side effects: watch-routing labels on the
        bound pods (new pods inherit them from the patched template) and
        the SliceBound Event."""
        nb_ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        for pod in pool_api.bound_slice_pods(self.client,
                                             (k8s.namespace(sts),
                                              k8s.name(sts))):
            try:
                self.client.patch("Pod", k8s.namespace(pod), k8s.name(pod), {
                    "metadata": {"labels": {
                        names.NOTEBOOK_NAME_LABEL: nb_name,
                        names.BOUND_NAMESPACE_LABEL: nb_ns}}})
            except errors.NotFoundError:
                pass
        self.recorder.eventf(
            notebook, events.TYPE_NORMAL, "SliceBound",
            f"bound warm slice {k8s.namespace(sts)}/{k8s.name(sts)} from "
            f"pool {k8s.name(pool)} (identity {identity.split(',')[0]}"
            f"{',…' if ',' in identity else ''})")

    def _stamp_notebook_bound(self, pool: dict, notebook: dict, sts: dict,
                              slice_spec: SliceSpec, pool_ns: str,
                              identity: str | None = None) -> None:
        nb_ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        sts_name = k8s.name(sts)
        if identity is None:
            identity = k8s.get_annotation(
                notebook, names.SLICE_IDENTITY_ANNOTATION) or \
                slice_hostnames(slice_spec, sts_name, pool_ns)
        try:
            self.client.patch(api.KIND, nb_ns, nb_name, {
                "metadata": {"annotations": {
                    names.BOUND_SLICE_ANNOTATION:
                        f"{k8s.namespace(sts)}/{sts_name}",
                    names.BOUND_POOL_ANNOTATION: k8s.name(pool),
                    names.SLICE_IDENTITY_ANNOTATION: identity,
                    names.POOL_BIND_PENDING_ANNOTATION: None,
                }}})
        except errors.NotFoundError:
            return  # deleted mid-bind; the bound-slice heal releases it
        key = (nb_ns, nb_name)
        with self._lock:
            first = self._first_pending.pop(key, None)
        if first is not None:
            self.bind_latency.observe(max(self.clock() - first, 0.0),
                                      {"pool": k8s.name(pool)})

    def _bind_miss(self, notebook: dict, reason: str) -> None:
        try:
            self.client.patch(api.KIND, k8s.namespace(notebook),
                              k8s.name(notebook), {
                "metadata": {"annotations": {
                    names.POOL_BIND_MISS_ANNOTATION: reason,
                    names.POOL_BIND_PENDING_ANNOTATION: None}}})
        except errors.NotFoundError:
            return
        with self._lock:
            self._first_pending.pop((k8s.namespace(notebook),
                                     k8s.name(notebook)), None)
        self.bind_misses.inc({"reason": reason})
        self.recorder.eventf(
            notebook, events.TYPE_WARNING, "PoolBindMiss",
            f"no warm slice available ({reason}); cold-rolling a "
            f"dedicated StatefulSet")

    # ------------------------------------------------------------- helpers
    def _patch_sts_annotations(self, sts: dict, annotations: dict) -> None:
        try:
            self.client.patch("StatefulSet", k8s.namespace(sts),
                              k8s.name(sts),
                              {"metadata": {"annotations": annotations}})
        except errors.NotFoundError:
            pass

    def _update_pool_status(self, pool: dict, status: dict) -> None:
        if k8s.get_in(pool, "status") == status:
            return
        pool = k8s.deepcopy(pool)
        pool["status"] = status
        try:
            self.client.update_status(pool)
        except (errors.ConflictError, errors.NotFoundError):
            pass  # next event re-converges

    def _teardown(self, pool_name: str,
                  slices: list[dict]) -> Result | None:
        """Pool deleted: reap unbound slices immediately; Bound slices
        keep serving their notebooks and are DELETED (not re-warmed —
        there is no pool to return to) once their notebook stops, is
        deleted, or moves on. The requeue keeps the orphaned key alive
        until the last slice is gone, because with the pool object gone
        no Notebook event maps back here."""
        remaining = False
        for sts in slices:
            if pool_state(sts) != names.POOL_STATE_BOUND:
                self._delete_slice(sts)
                continue
            ref = k8s.get_annotation(sts,
                                     names.POOL_BOUND_TO_ANNOTATION) or ""
            nb_ns, _, nb_name = ref.partition("/")
            nb = self.client.get_or_none(api.KIND, nb_ns, nb_name) \
                if nb_ns and nb_name else None
            still_ours = nb is not None and pool_api.bound_slice_ref(nb) \
                == (k8s.namespace(sts), k8s.name(sts))
            if still_ours and not k8s.is_deleting(nb) and \
                    k8s.get_annotation(nb, names.STOP_ANNOTATION) is None:
                remaining = True  # actively serving: keep until released
                continue
            if still_ours and not k8s.is_deleting(nb):
                self._unbind_notebook(nb)  # stopped while bound
            self._delete_slice(sts)
        if remaining:
            return Result(requeue_after=max(self.config.pool_poll_s, 0.25))
        return None


def _notebook_slice_spec(nb: dict) -> SliceSpec | None:
    return parse_slice_request(
        k8s.get_in(nb, "metadata", "annotations", default={}) or {})


def _has_own_sts(reader, notebook: dict) -> bool:
    from ..cluster.cache import owned_objects
    for _sts in owned_objects(reader, "StatefulSet", notebook):
        return True
    return False
