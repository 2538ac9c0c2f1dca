"""Core Notebook reconciler: Notebook CR → StatefulSet + Service(s) + status.

The port's copy of ``NotebookReconciler`` in
``kubeflow_tpu/controllers/notebook.py``, which re-implements the
reference's upstream NotebookReconciler
(components/notebook-controller/controllers/notebook_controller.go:94-826)
with a slice-shaped workload layer:

- stop-annotation drives replicas 0 ↔ N (N = slice worker count, so
  culling is slice-atomic: one StatefulSet, all workers share one
  replica flip);
- names > 52 chars fall back to GenerateName "nb-" (reference :59,
  :444-449);
- labels/annotations propagate with the kubectl/notebook substring
  exclusion (reference :486-491);
- NB_PREFIX, default workdir and port, fsGroup 100 (reference :417-431,
  :493-521);
- Service: ClusterIP, port name "http-notebook", 80 → container port
  (reference :525-552), plus the annotated serving port;
- status mirrors pod-0's conditions and adds an aggregate SliceReady
  condition (every worker ready);
- the restart annotation deletes every worker pod and strips itself
  (reference :259-294);
- the fleet scheduler's admission gate and the warm pool's bind gate, as
  the reference wrote them: with no gang annotation and no SlicePool of
  the requested shape, both let the roll proceed.

The accelerator seam is the one change: ``generate_statefulset`` renders
an H100 slice with ``apply_gpu_spec`` (``nvidia.com/gpu`` requests, the
H100 node selectors of gpu/topology.py, the same worker env and headless
Service) where the reference calls ``_apply_tpu_spec``. ``apply_gpu_spec``
keeps a StatefulSet that ``desired_replicas`` put at 0 at 0, so a stopped
notebook stays stopped.

Reads and echoes as the reference's: the client is wrapped in
``cluster/echo.py``'s ``EchoTrackingClient``, whose ``not_echo``
predicate sits on the Notebook, StatefulSet, Service and VirtualService
watches, and ``setup`` takes the manager's ``read_cache`` or builds a
``cluster/cache.py`` ``CachingClient`` teed off its own watches; the
Event predicate, the re-emission, the ``notebook_running`` scrape and
the pool gate read through it, and the owned StatefulSet is found by
the by-owner index. Over the in-process store the echo filter drops
nothing (the store delivers a write's event before the write returns,
so the record lands after its echo), as in the reference.

The trace-context stamp (``_stamp_trace_context``): while a tracing
provider records, the first reconcile of a notebook that carries no
``TRACE_CONTEXT_ANNOTATION`` writes its reconcile root's traceparent
there, so every later reconcile, bind and migration of the notebook
joins one lifecycle trace; the annotation is never copied into the
StatefulSet's template.
"""

from __future__ import annotations

import logging
import time

from ..api import slicepool as pool_api
from ..api import types as api
from ..cluster import errors, events
from ..cluster.cache import CachingClient, owned_objects
from ..cluster.echo import EchoTrackingClient
from ..gpu.topology import SliceSpec, parse_slice_request
from ..utils import drift, k8s, names, tracing
from ..utils.config import ControllerConfig
from ..utils.metrics import MetricsRegistry
from .manager import Manager, Request, Result, owner_mapper

log = logging.getLogger("kubeflow_tpu_torch.notebook")

DEFAULT_CONTAINER_PORT = 8888
DEFAULT_SERVICE_PORT = 80
DEFAULT_WORKDIR = "/home/jovyan"
DEFAULT_FSGROUP = 100

# annotation substrings NOT copied from CR to pod template — the reference
# excludes keys *containing* these anywhere (strings.Contains, :486-491)
_EXCLUDED_ANNOTATION_SUBSTRINGS = ("kubectl", "notebook")


def headless_service_name(notebook_name: str) -> str:
    return f"{notebook_name}-workers"[: 63]


def worker_env(container: dict, spec: SliceSpec, hostnames: str | None) -> None:
    """The worker identity env of a slice's pod: ``hostnames`` (None
    leaves TPU_WORKER_HOSTNAMES unset), the worker id from the pod-index
    label, the accelerator and its topology."""
    if hostnames is not None:
        k8s.upsert_env(container, "TPU_WORKER_HOSTNAMES", hostnames)
    # worker id = StatefulSet pod ordinal, surfaced by the apps controller
    # as the pod-index label (stable across pod restarts)
    k8s.upsert_env_from(container, "TPU_WORKER_ID", {"fieldRef": {
        "fieldPath": f"metadata.labels['{names.POD_INDEX_LABEL}']"}})
    k8s.upsert_env(container, "TPU_ACCELERATOR_TYPE", spec.short_name)
    k8s.upsert_env(container, "TPU_TOPOLOGY", spec.topology_str)


def gpu_resources(spec: SliceSpec) -> dict:
    qty = str(spec.cards_per_worker)
    return {"requests": {names.GPU_RESOURCE_KEY: qty},
            "limits": {names.GPU_RESOURCE_KEY: qty}}


def apply_gpu_spec(sts: dict, notebook: dict, spec: SliceSpec,
                   sts_name: str | None) -> None:
    """Render an H100 slice onto a notebook's StatefulSet: nodeSelectors,
    card resources, worker identity env, the headless-service subdomain,
    and ``spec.num_workers`` replicas unless the StatefulSet has 0 (a
    stopped notebook, or a repair's scale-down, stays at 0).

    ``sts_name`` is None only on the very first create of a GenerateName
    StatefulSet; the multi-host hostnames are rendered once the apiserver
    has materialized the name, as in the reference."""
    nb_name = k8s.name(notebook)
    pod_spec = sts["spec"]["template"]["spec"]
    pod_spec.setdefault("nodeSelector", {}).update(spec.node_selectors())
    if sts["spec"].get("replicas") != 0:
        sts["spec"]["replicas"] = spec.num_workers

    sts["metadata"].setdefault("labels", {})[names.TPU_SLICE_LABEL] = (
        spec.short_name)
    sts["spec"]["template"]["metadata"]["labels"][names.TPU_SLICE_LABEL] = (
        spec.short_name)

    container = k8s.pod_spec_notebook_container(pod_spec, nb_name)
    if container is None:
        return  # structurally invalid CR; admission validation rejects these
    resources = container.setdefault("resources", {})
    for key, quantities in gpu_resources(spec).items():
        resources.setdefault(key, {}).update(quantities)

    hostnames = "localhost"
    if spec.multi_host:
        headless = headless_service_name(nb_name)
        sts["spec"]["serviceName"] = headless
        hostnames = None if sts_name is None else ",".join(
            spec.worker_hostnames(sts_name, headless, k8s.namespace(notebook)))
    worker_env(container, spec, hostnames)


class NotebookReconciler:
    name = "notebook-controller"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 wall_clock=time.time):
        # every write records its rv so our watches drop the echo of our
        # own writes (cluster/echo.py)
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        self.metrics.on_scrape(self._scrape_running)
        # wall clock for the bind-pending heartbeat check: the pool
        # controller stamps epoch seconds from ITS wall clock, so the
        # freshness comparison must be wall-to-wall — injected so tests
        # can expire the heartbeat without sleeping
        self.wall_clock = wall_clock
        self.recorder = events.EventRecorder(client, component=self.name)
        # watch-fed read cache for the Event predicate, the scrape and the
        # pool gate (built in setup(); without setup() reads stay live)
        self._read_cache = None
        # (ns, name) → monotonic time a poolable notebook was first seen
        # waiting for a warm-slice bind; past pool_bind_grace_s the core
        # stamps a BindTimeout miss and cold-rolls (in-memory is fine: a
        # restarted controller re-arming the grace window is correct)
        self._pool_pending_since: dict[tuple[str, str], float] = {}
        # (ns, name) → monotonic time a gang-annotated notebook was first
        # seen waiting for the fleet scheduler's Admitted verdict; past
        # sched_admission_grace_s with no scheduler progress the core
        # proceeds anyway (a down scheduler must never strand creation)
        self._sched_pending_since: dict[tuple[str, str], float] = {}
        # (ns, name) → traceparent this process already stamped: keeps the
        # reconciles that race the stamp's own watch echo from stamping
        # again (filled only while a recording provider is installed)
        self._stamped_traces: dict[tuple[str, str], str] = {}

    # ------------------------------------------------------------- wiring
    def setup(self, mgr: Manager) -> None:
        """Watch wiring — reference SetupWithManager
        (notebook_controller.go:778-826): own Notebook, own STS/Service,
        map Pods via the notebook-name label."""
        mgr.register(self)
        # The Event predicate resolves involvedObject → Notebook on every
        # delivered Event; the reference answers that from its informer
        # cache (notebook_controller.go:739-767). The manager's read cache
        # is that layer, fed and backfilled by mgr.watch; a standalone
        # reconciler builds its own cache teed off the same streams.
        if mgr.read_cache is not None:
            cache, tee = mgr.read_cache, None
        else:
            cache = CachingClient(self.client, disable_for=(),
                                  auto_informer=False)
            tee = cache.feed
        self._read_cache = cache
        # drop the echoes of our own status/STS/Service writes
        ne = self.client.not_echo
        mgr.watch(api.KIND, self.name, tee=tee, predicate=ne)
        mgr.watch("StatefulSet", self.name, mapper=owner_mapper(api.KIND),
                  tee=tee, predicate=ne)
        mgr.watch("Service", self.name, mapper=owner_mapper(api.KIND),
                  predicate=ne)
        # bound-aware pod mapping: pool-bound workers live in the pool
        # namespace but belong to a Notebook elsewhere (the bound-namespace
        # label routes them home)
        mgr.watch("Pod", self.name, mapper=pool_api.pod_notebook_mapper,
                  tee=tee)
        if self.config.enable_slice_pool:
            # the bind gate reads SlicePools from the cache; pool events
            # enqueue nothing here: binds surface as Notebook annotation
            # patches, which the Notebook watch above delivers
            mgr.watch(pool_api.KIND, self.name, mapper=lambda obj: [],
                      tee=tee)
        # backfill after the watches above are live (watch-then-list; the
        # rv guard and tombstones make the overlap safe); idempotent when
        # the manager already backfilled the kind
        kinds = [api.KIND, "StatefulSet", "Pod"]
        if self.config.enable_slice_pool:
            kinds.append(pool_api.KIND)
        for kind in kinds:
            try:
                cache.backfill(kind)
            except Exception:  # noqa: BLE001 — see Manager.watch
                log.warning("read-cache backfill for %s failed; reads "
                            "stay live", kind, exc_info=True)
        # Events of known notebooks' Pods/STSs share the Notebook queue and
        # are re-emitted on the CR (reference predNBEvents + mapEventToRequest,
        # notebook_controller.go:739-767,780-800; delete events are ignored)
        mgr.watch(events.EVENT_KIND, self.name,
                  predicate=self._pred_nb_events)
        if self.config.use_istio:
            mgr.watch("VirtualService", self.name,
                      mapper=owner_mapper(api.KIND), predicate=ne)

    def _pred_nb_events(self, watch_event) -> bool:
        if watch_event.type == "DELETED":
            return False
        obj = watch_event.obj
        if not events.is_sts_or_pod_event(obj):
            return False
        reader = self._read_cache or self.client
        nb_name = events.nb_name_from_involved_object(
            reader, obj, names.NOTEBOOK_NAME_LABEL)
        if nb_name is None:
            return False
        return reader.get_or_none(api.KIND, k8s.namespace(obj),
                                  nb_name) is not None

    def _scrape_running(self) -> None:
        """notebook_running is computed at scrape time by listing STSs
        carrying the notebook-name label (reference pkg/metrics/
        metrics.go:60-99 uses client.HasLabels), from the read cache's
        by-label index once ``setup`` has wired it."""
        reader = self._read_cache or self.client
        stss = reader.list(
            "StatefulSet",
            label_selector={names.NOTEBOOK_NAME_LABEL: None})
        running = sum(1 for s in stss
                      if k8s.get_in(s, "status", "readyReplicas", default=0))
        self.metrics.notebook_running.set(running)

    # ---------------------------------------------------------- reconcile
    def reconcile(self, req: Request) -> Result | None:
        # Events ride the same queue as Notebooks: a request that names an
        # Event object is a re-emission request (reference event-or-notebook
        # disambiguation, notebook_controller.go:99-126, checked second here:
        # event names always carry a ".<hash>" suffix no Notebook's could)
        notebook = self.client.get_or_none(api.KIND, req.namespace, req.name)
        if notebook is None:
            # a notebook deleted while waiting for a bind must not leak
            # its grace-window entries (nor its stamped-trace entry)
            self._pool_pending_since.pop((req.namespace, req.name), None)
            self._sched_pending_since.pop((req.namespace, req.name), None)
            self._stamped_traces.pop((req.namespace, req.name), None)
            event = self.client.get_or_none(events.EVENT_KIND, req.namespace,
                                            req.name)
            if event is not None:
                self._reemit_event(req.namespace, event)
            return None
        if k8s.is_deleting(notebook):
            # upstream reconciler no-ops on deletion (reference :138-140);
            # owner-reference GC reaps STS/Service
            return None
        self._stamp_trace_context(notebook)

        # fleet-scheduler admission (controllers/scheduler.py): a
        # gang-annotated notebook rolls nothing until the scheduler
        # admits its gang — the hold that makes multi-slice acquisition
        # atomic fleet-wide. Bounded by a grace timeout, so a down
        # scheduler degrades to unscheduled creation instead of
        # stranding it.
        gate = self._sched_admission_gate(notebook)
        if gate is not None:
            return gate

        slice_spec = parse_slice_request(
            k8s.get_in(notebook, "metadata", "annotations", default={}))

        # warm-pool bind mode (controllers/slicepool.py): a bound notebook
        # is served by a pool-owned slice — the core repoints the Service
        # and mirrors status off the BOUND slice instead of rolling its own
        # StatefulSet (the CR→Ready collapse the pool exists for)
        if slice_spec is not None:
            bound = pool_api.bound_slice_ref(notebook)
            if bound is not None:
                self._reconcile_bound(notebook, slice_spec, bound)
                return None
            gate = self._pool_bind_gate(notebook, slice_spec)
            if gate is not None:
                # a warm slice is (or will shortly be) available: hold the
                # cold roll — the pool controller's bind patch re-enqueues
                # us; the requeue is only the belt-and-braces fallback.
                # No status write while waiting: the bind is one reconcile
                # away and a transient 0/N status would double the bind
                # path's write cost for no operator signal.
                return gate

        self._reconcile_statefulset(notebook, slice_spec)
        self._reconcile_service(notebook, slice_spec)
        if slice_spec is not None and slice_spec.multi_host:
            self._reconcile_headless_service(notebook, slice_spec)
        if self.config.use_istio:
            self._reconcile_virtual_service(notebook)
        self._handle_restart_annotation(notebook, slice_spec)
        self._update_status(notebook, slice_spec)
        return None

    def _reemit_event(self, namespace: str, event: dict) -> None:
        """Re-emit a Pod/StatefulSet event on the owning Notebook CR
        (reference notebook_controller.go:103-121): the re-issued event's
        involvedObject is the Notebook, so it does not re-trigger the Event
        watch (predicate only passes Pod/STS events)."""
        if not events.is_sts_or_pod_event(event):
            return
        reader = self._read_cache or self.client
        nb_name = events.nb_name_from_involved_object(
            reader, event, names.NOTEBOOK_NAME_LABEL)
        if nb_name is None:
            return
        notebook = reader.get_or_none(api.KIND, namespace, nb_name)
        if notebook is None:
            return
        involved = event.get("involvedObject", {})
        self.recorder.eventf(
            notebook, event.get("type", events.TYPE_NORMAL),
            event.get("reason", ""),
            "Reissued from %s/%s: %s" % (
                str(involved.get("kind", "")).lower(),
                involved.get("name", ""), event.get("message", "")))

    def _stamp_trace_context(self, notebook: dict) -> None:
        """Anchor the notebook's lifecycle trace: while a recording
        provider is installed, write the reconcile root's traceparent onto
        the CR (TRACE_CONTEXT_ANNOTATION) the first time the notebook is
        reconciled without one. Every later actor (this reconciler's next
        pass, the pool's bind, the repairer's migration) parents its spans
        on the carried context, so CR→Ready is one trace. Telemetry only:
        nothing when tracing is off, and a failed stamp never fails the
        reconcile."""
        if not tracing.is_recording():
            return
        if k8s.get_annotation(notebook,
                              names.TRACE_CONTEXT_ANNOTATION) is not None:
            return
        key = (k8s.namespace(notebook), k8s.name(notebook))
        if key in self._stamped_traces:
            # stamped by an earlier pass whose watch echo has not reached
            # the cache yet: stamping again would fork the trace
            return
        ctx = tracing.current_context()
        if ctx is None:
            return  # no root span (a reconciler driven outside a manager)
        header = tracing.format_traceparent(ctx)
        self._stamped_traces[key] = header
        try:
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.TRACE_CONTEXT_ANNOTATION: header}}})
        except errors.ApiError as exc:
            self._stamped_traces.pop(key, None)
            log.debug("trace-context stamp for %s/%s failed: %s",
                      key[0], key[1], exc)

    # ----------------------------------------------------- warm-pool seams
    def _pool_bind_gate(self, notebook: dict,
                        slice_spec: SliceSpec) -> Result | None:
        """Decide whether to hold the cold roll for a warm-pool bind.
        Returns a Result to wait (the bind/release/migrate seam the pool
        controller drives through annotations), or None → cold-roll now.
        The gate times out after pool_bind_grace_s with a BindTimeout
        miss, so a down pool controller can never strand creation."""
        if not self.config.enable_slice_pool:
            return None
        if k8s.get_annotation(notebook,
                              names.POOL_BIND_MISS_ANNOTATION) is not None:
            return None  # fair-share loser / timed out: cold path owns it
        if self._find_owned_sts(notebook) is not None:
            return None  # already cold-rolled (pool appeared later)
        key = (k8s.namespace(notebook), k8s.name(notebook))
        if k8s.get_annotation(notebook,
                              names.MIGRATION_STATE_ANNOTATION) is not None:
            # mid-migration re-bind: the repair controller owns the
            # outcome and its (longer) timeout — the cold roll waits even
            # if the pool momentarily shows no capacity (or was deleted:
            # the repair's bounded timeout stamps the miss that releases
            # this hold). The Service is repointed to the endpoint-less
            # cold shape for the window (the released OLD slice may
            # already serve another tenant — same cross-tenant hazard as
            # the stop branch) and status renders PoolBound=Migrating.
            self._pool_pending_since.pop(key, None)
            self._reconcile_service(notebook, slice_spec)
            self._update_status(notebook, slice_spec)
            return Result(requeue_after=self.config.pool_poll_s)
        reader = self._read_cache or self.client
        if not any(k8s.get_in(p, "spec", "accelerator")
                   == slice_spec.short_name
                   for p in reader.list(pool_api.KIND)):
            return None  # no pool serves this topology
        if k8s.get_annotation(notebook, names.STOP_ANNOTATION) is not None:
            # stopped + poolable: no StatefulSet at all — resume re-enters
            # this gate and binds a warm slice instead of cold-scaling 0→N.
            # The Service MUST be repointed back to the (endpoint-less)
            # cold selector shape and status re-rendered: a released slice
            # is re-bound to OTHER tenants, and a leftover ExternalName
            # Service would route this notebook's URL into their slice.
            self._pool_pending_since.pop(key, None)
            self._reconcile_service(notebook, slice_spec)
            self._update_status(notebook, slice_spec)
            return Result()
        heartbeat = k8s.get_annotation(notebook,
                                       names.POOL_BIND_PENDING_ANNOTATION)
        if heartbeat is not None:
            try:
                fresh = self.wall_clock() - float(heartbeat) < \
                    self.config.pool_bind_grace_s
            except (TypeError, ValueError):
                fresh = False
            if fresh:
                # the pool controller is ALIVE and has admitted this
                # notebook (slice warming, or waiting for a sibling
                # pool's spill): the grace timeout only guards against a
                # dead pool controller — keep waiting; real slice
                # provisioning legitimately outlives any fixed grace
                self._pool_pending_since.pop(key, None)
                return Result(requeue_after=self.config.pool_bind_grace_s)
        now = time.monotonic()
        first = self._pool_pending_since.setdefault(key, now)
        if now - first > self.config.pool_bind_grace_s:
            self._pool_pending_since.pop(key, None)
            self.client.patch(api.KIND, key[0], key[1], {
                "metadata": {"annotations": {
                    names.POOL_BIND_MISS_ANNOTATION: "BindTimeout"}}})
            self.recorder.eventf(
                notebook, events.TYPE_WARNING, "PoolBindMiss",
                f"no warm-slice bind within "
                f"{self.config.pool_bind_grace_s:.0f}s; cold-rolling")
            return None
        return Result(requeue_after=self.config.pool_poll_s)

    def _sched_admission_gate(self, notebook: dict) -> Result | None:
        """Hold the roll of a gang-annotated notebook until the fleet
        scheduler admits its gang. Returns a Result to wait, or None →
        proceed. Two regimes:

        * scheduler has made progress (any sched-state present): the
          admission queue owns the wait — a gang legitimately queued
          behind capacity or a preemption drain must NOT cold-roll out
          from under its own atomicity guarantee, however long it takes
          (withdrawing the gang annotation is the operator's exit).
        * scheduler silent (no state ever stamped): after
          sched_admission_grace_s the notebook proceeds unscheduled with
          a warning event — a down scheduler must never strand creation
          (the same degrade rule as the pool's BindTimeout)."""
        if not getattr(self.config, "enable_scheduler", True):
            return None
        key = (k8s.namespace(notebook), k8s.name(notebook))
        if k8s.get_annotation(notebook,
                              names.SCHED_GANG_ANNOTATION) is None:
            self._sched_pending_since.pop(key, None)
            return None
        state = k8s.get_annotation(notebook, names.SCHED_STATE_ANNOTATION)
        if state == "Admitted":
            self._sched_pending_since.pop(key, None)
            return None
        if self._find_owned_sts(notebook) is not None:
            # already rolled (grace expired earlier, or the gang
            # annotation arrived after creation): admission now only
            # gates NEW rolls, it never tears down a running notebook
            return None
        if state is not None:
            # the scheduler is alive and has this gang queued
            self._sched_pending_since.pop(key, None)
            return Result(requeue_after=self.config.sched_poll_s)
        now = time.monotonic()
        first = self._sched_pending_since.setdefault(key, now)
        if now - first > self.config.sched_admission_grace_s:
            self._sched_pending_since.pop(key, None)
            self.recorder.eventf(
                notebook, events.TYPE_WARNING, "SchedulerAdmissionTimeout",
                f"no scheduler verdict within "
                f"{self.config.sched_admission_grace_s:.0f}s; proceeding "
                f"unscheduled")
            return None
        return Result(requeue_after=self.config.sched_poll_s)

    def _reconcile_bound(self, notebook: dict, slice_spec: SliceSpec,
                         bound: tuple[str, str]) -> None:
        """Bound mode: Service repointed at the pool slice, restart bounces
        the BOUND workers, status mirrors the BOUND slice's pods. No owned
        StatefulSet exists (releasing must hand the slice back intact —
        an ownerReference would let notebook deletion GC warm capacity)."""
        self._pool_pending_since.pop(
            (k8s.namespace(notebook), k8s.name(notebook)), None)
        self._reconcile_service(notebook, slice_spec, bound=bound)
        if self.config.use_istio:
            self._reconcile_virtual_service(notebook)
        self._handle_restart_annotation(notebook, slice_spec, bound=bound)
        self._update_status(notebook, slice_spec, bound=bound)

    # --------------------------------------------------------- generation
    def desired_replicas(self, notebook: dict, slice_spec: SliceSpec | None) -> int:
        """Stop annotation → 0, else the slice worker count (reference
        :434-437 is the 0/1 version). NEVER a partial count — slice atomicity
        invariant (SURVEY §7 stage 5). The repair controller's scale-down
        hold (controllers/slicerepair.py) rides the same single-writer
        seam: repairs roll the slice 0 → N through THIS function, so
        replicas can only ever be 0 or full, never partial. Pool-BOUND
        notebooks never reach the StatefulSet path at all (the bind seam
        in reconcile()); this function then only sizes the status
        expectation for the bound slice."""
        if k8s.get_annotation(notebook, names.STOP_ANNOTATION) is not None:
            return 0
        if k8s.get_annotation(notebook,
                              names.REPAIR_SCALE_DOWN_ANNOTATION) is not None:
            return 0
        return slice_spec.num_workers if slice_spec else 1

    def _propagated_labels(self, notebook: dict) -> dict:
        labels = {
            "statefulset": k8s.name(notebook),
            names.NOTEBOOK_NAME_LABEL: k8s.name(notebook),
        }
        for key, val in (k8s.get_in(notebook, "metadata", "labels", default={}) or {}).items():
            labels[key] = val
        return labels

    def _propagated_annotations(self, notebook: dict) -> dict:
        out = {}
        for key, val in (k8s.get_in(notebook, "metadata", "annotations",
                                    default={}) or {}).items():
            if any(s in key for s in _EXCLUDED_ANNOTATION_SUBSTRINGS):
                continue
            if key in (names.TPU_ACCELERATOR_ANNOTATION,
                       names.TPU_TOPOLOGY_ANNOTATION):
                continue  # slice identity lives in labels/env, not pod annotations
            if key in names.SLICE_REPAIR_ANNOTATIONS or \
                    key in names.POOL_ANNOTATIONS or \
                    key in names.ELASTIC_ANNOTATIONS or \
                    key in names.SCHED_ANNOTATIONS or \
                    key == names.TRACE_CONTEXT_ANNOTATION:
                # repair/pool/elastic/sched/trace bookkeeping would churn
                # the pod template (every health, bind, resize-handshake,
                # or admission transition a spurious template drift →
                # rolling restart) — it describes the slice's lifecycle,
                # not the pods
                continue
            out[key] = val
        return out

    def generate_statefulset(self, notebook: dict,
                             slice_spec: SliceSpec | None,
                             actual_sts_name: str | None = None) -> dict:
        """Build the desired StatefulSet (reference generateStatefulSet,
        notebook_controller.go:433-523, extended with the H100 layer).

        ``actual_sts_name`` is the apiserver-materialized name when the
        52-char rule forced GenerateName — worker DNS (TPU_WORKER_HOSTNAMES)
        must be derived from the real pod names ``<sts>-<i>``, not the CR
        name (SURVEY §7 hard part 'TPU_WORKER_HOSTNAMES correctness')."""
        nb_name = k8s.name(notebook)
        ns = k8s.namespace(notebook)
        sts_name, use_generate = names.sts_name_for_notebook(nb_name)
        pod_spec = k8s.deepcopy(api.notebook_pod_spec(notebook))

        # the notebook container is the one named after the CR, falling back
        # to containers[0] (same convention as the webhook/reference); the
        # H100 layer below targets the same container
        container = _notebook_container(pod_spec, nb_name)
        if container is not None:
            container.setdefault("workingDir", DEFAULT_WORKDIR)
            if not container.get("ports"):
                container["ports"] = [{
                    "containerPort": DEFAULT_CONTAINER_PORT,
                    "name": "notebook-port",
                    "protocol": "TCP",
                }]
            k8s.upsert_env(container, "NB_PREFIX", names.nb_prefix(ns, nb_name))

        if self.config.add_fsgroup:
            pod_spec.setdefault("securityContext", {}).setdefault(
                "fsGroup", DEFAULT_FSGROUP)

        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "namespace": ns,
                "labels": self._propagated_labels(notebook),
                "annotations": self._propagated_annotations(notebook),
            },
            "spec": {
                "replicas": self.desired_replicas(notebook, slice_spec),
                "selector": {"matchLabels": {"statefulset": nb_name}},
                "serviceName": nb_name,
                "podManagementPolicy": "Parallel",
                "template": {
                    # CR labels/filtered annotations propagate into the pod
                    # template too (reference :479-491 — poddefault labels,
                    # istio annotations etc. must reach the pods)
                    "metadata": {
                        "labels": self._propagated_labels(notebook),
                        "annotations": self._propagated_annotations(notebook),
                    },
                    "spec": pod_spec,
                },
            },
        }
        if use_generate:
            sts["metadata"]["generateName"] = names.STS_GENERATE_PREFIX
        else:
            sts["metadata"]["name"] = sts_name

        if slice_spec is not None:
            apply_gpu_spec(sts, notebook, slice_spec,
                           actual_sts_name or (None if use_generate
                                               else sts_name))
        k8s.set_controller_reference(notebook, sts)
        return sts

    def generate_service(self, notebook: dict,
                         bound: tuple[str, str] | None = None) -> dict:
        """ClusterIP Service, port name "http-notebook" (Istio-compatible),
        80 → container port (reference generateService, :525-552).

        ``bound`` repoints the Service at a pool-owned warm slice in the
        pool namespace: ExternalName to the slice's headless Service —
        the cross-namespace route flip that makes a bind take effect
        without touching any pod (and release/rebind is just another
        flip)."""
        nb_name = k8s.name(notebook)
        container = api.notebook_container(notebook) or {}
        ports = container.get("ports") or [{"containerPort": DEFAULT_CONTAINER_PORT}]
        target_port = ports[0].get("containerPort", DEFAULT_CONTAINER_PORT)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": nb_name,
                "namespace": k8s.namespace(notebook),
                "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
            },
            "spec": {
                "type": "ClusterIP",
                "selector": {"statefulset": nb_name},
                "ports": [{
                    "name": "http-notebook",
                    "port": DEFAULT_SERVICE_PORT,
                    "targetPort": target_port,
                    "protocol": "TCP",
                }],
            },
        }
        if bound is not None:
            svc["spec"] = {
                "type": "ExternalName",
                "externalName": f"{bound[1]}.{bound[0]}.svc."
                                f"{self.config.cluster_domain}",
                "ports": svc["spec"]["ports"],
            }
        # serving-aware culling: the annotated model-serving endpoint
        # (runtime/server.py) must be reachable THROUGH the Service or the
        # culler's activity probe (controllers/culling.py
        # serving_requests_prober) would get connection-refused and cull
        # an actively-serving slice
        serving_port = k8s.get_annotation(notebook,
                                          names.SERVING_PORT_ANNOTATION)
        if serving_port:
            port_n = k8s.parse_port(serving_port)
            if port_n is not None:
                svc["spec"]["ports"].append({
                    "name": "http-serving",
                    "port": port_n,
                    "targetPort": port_n,
                    "protocol": "TCP",
                })
        k8s.set_controller_reference(notebook, svc)
        return svc

    def generate_headless_service(self, notebook: dict,
                                  slice_spec: SliceSpec) -> dict:
        """Headless Service for worker DNS, the communication-backend
        bootstrap of a multi-node slice: every worker resolves
        ``<sts>-<i>.<svc>.<ns>.svc`` (runtime/bootstrap.py forms its world
        on worker 0's name)."""
        nb_name = k8s.name(notebook)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": headless_service_name(nb_name),
                "namespace": k8s.namespace(notebook),
                "labels": {
                    names.NOTEBOOK_NAME_LABEL: nb_name,
                    names.TPU_SLICE_LABEL: slice_spec.short_name,
                },
            },
            "spec": {
                "clusterIP": "None",
                "publishNotReadyAddresses": True,
                "selector": {"statefulset": nb_name},
                "ports": [{"name": "tpu-dcn", "port": 8471, "protocol": "TCP"}],
            },
        }
        k8s.set_controller_reference(notebook, svc)
        return svc

    # --------------------------------------------------- create-or-update
    def _apply_drift(self, desired: dict, found: dict, copy_fields) -> bool:
        """Minimal-write path (utils/drift.py): run the Copy*Fields
        contract against a scratch copy of the live object; NO drift means
        NO request at all, and a real drift ships as a JSON merge patch of
        only the drifted paths. Merge patches carry no resourceVersion
        precondition, so a concurrent writer (the culler's annotation
        patches, the other reconciler) can no longer 409 this write — the
        old conflict-retry loop and its live re-GETs are gone from the
        steady-state wire. Returns whether a write was issued."""
        patch = drift.minimal_update_patch(desired, found, copy_fields)
        if patch is None:
            return False
        self.client.patch(k8s.kind(found), k8s.namespace(found),
                          k8s.name(found), patch)
        return True

    def _find_owned_sts(self, notebook: dict) -> dict | None:
        """Find the STS for a notebook, robust to GenerateName: the
        by-owner index when the client carries one, else a namespace LIST
        filtered by owner uid (ownership is the one filter on both)."""
        for sts in owned_objects(self.client, "StatefulSet", notebook):
            return sts
        return None

    def _reconcile_statefulset(self, notebook: dict,
                               slice_spec: SliceSpec | None) -> None:
        found = self._find_owned_sts(notebook)
        desired = self.generate_statefulset(
            notebook, slice_spec,
            actual_sts_name=k8s.name(found) if found else None)
        if found is None:
            try:
                created = self.client.create(desired)
                self.metrics.notebook_create_total.inc()
            except errors.AlreadyExistsError:
                return
            except Exception:
                self.metrics.notebook_create_failed_total.inc()
                raise
            if desired["metadata"].get("generateName"):
                # name now materialized — re-render so worker DNS env matches
                # the real pod names (before any pod has started)
                fixed = self.generate_statefulset(
                    notebook, slice_spec, actual_sts_name=k8s.name(created))
                self._apply_drift(fixed, created, copy_statefulset_fields)
            return
        self._apply_drift(desired, found, copy_statefulset_fields)

    def _create_or_update(self, desired: dict, copy_fields) -> None:
        """Create-or-idempotent-update for a named desired object: swallow
        the create race (another worker got there first; the watch
        re-enqueues); an existing object takes the drift-aware minimal-
        patch path (zero requests in steady state)."""
        found = self.client.get_or_none(k8s.kind(desired),
                                        k8s.namespace(desired),
                                        k8s.name(desired))
        if found is None:
            try:
                self.client.create(desired)
            except errors.AlreadyExistsError:
                pass
            return
        self._apply_drift(desired, found, copy_fields)

    def _reconcile_service(self, notebook: dict,
                           slice_spec: SliceSpec | None,
                           bound: tuple[str, str] | None = None) -> None:
        self._create_or_update(self.generate_service(notebook, bound=bound),
                               copy_service_fields)

    def _reconcile_headless_service(self, notebook: dict,
                                    slice_spec: SliceSpec) -> None:
        self._create_or_update(
            self.generate_headless_service(notebook, slice_spec),
            copy_service_fields)

    def generate_virtual_service(self, notebook: dict) -> dict:
        """Istio VirtualService routing ``/notebook/<ns>/<name>/`` through the
        cluster gateway to the notebook Service (reference
        generateVirtualService, notebook_controller.go:558-658): host/gateway
        from ISTIO_HOST/ISTIO_GATEWAY, rewrite to the same prefix, destination
        ``<name>.<ns>.svc.<cluster-domain>`` port 80."""
        nb_name = k8s.name(notebook)
        ns = k8s.namespace(notebook)
        prefix = names.nb_prefix(ns, nb_name) + "/"
        vs = {
            "apiVersion": "networking.istio.io/v1alpha3",
            "kind": "VirtualService",
            "metadata": {
                "name": virtual_service_name(nb_name, ns),
                "namespace": ns,
                "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
            },
            "spec": {
                "hosts": [self.config.istio_host],
                "gateways": [self.config.istio_gateway],
                "http": [{
                    "match": [{"uri": {"prefix": prefix}}],
                    "rewrite": {"uri": prefix},
                    "route": [{"destination": {
                        "host": f"{nb_name}.{ns}.svc.{self.config.cluster_domain}",
                        "port": {"number": DEFAULT_SERVICE_PORT},
                    }}],
                    "timeout": "300s",
                }],
            },
        }
        k8s.set_controller_reference(notebook, vs)
        return vs

    def _reconcile_virtual_service(self, notebook: dict) -> None:
        self._create_or_update(self.generate_virtual_service(notebook),
                               copy_virtual_service_fields)

    # ------------------------------------------------------------ restart
    def _handle_restart_annotation(self, notebook: dict,
                                   slice_spec: SliceSpec | None,
                                   bound: tuple[str, str] | None = None) \
            -> None:
        """Restart path (reference :259-294): annotation → delete pod(s) →
        strip annotation. Slice extension: ALL slice workers are bounced
        together (partial restarts would wedge the mesh); a pool-BOUND
        notebook bounces the bound slice's workers in the pool namespace."""
        if k8s.get_annotation(notebook, names.RESTART_ANNOTATION) != "true":
            return
        ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        pods = pool_api.bound_slice_pods(self.client, bound) if bound \
            else self.client.list("Pod", ns,
                                  {names.NOTEBOOK_NAME_LABEL: nb_name})
        for pod in pods:
            try:
                self.client.delete("Pod", k8s.namespace(pod), k8s.name(pod))
            except errors.NotFoundError:
                pass
        self.client.patch(api.KIND, ns, nb_name, {
            "metadata": {"annotations": {names.RESTART_ANNOTATION: None}}})

    # ------------------------------------------------------------- status
    def _update_status(self, notebook: dict,
                       slice_spec: SliceSpec | None,
                       bound: tuple[str, str] | None = None) -> None:
        """Mirror pod state into Notebook status (reference
        updateNotebookStatus, :299-374) + aggregate SliceReady condition.
        In bound mode the mirrored StatefulSet/pods are the POOL slice's
        (they live in the pool namespace)."""
        ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        if bound is not None:
            sts = self.client.get_or_none("StatefulSet", bound[0], bound[1])
            pods = sorted(pool_api.bound_slice_pods(self.client, bound),
                          key=k8s.name)
        else:
            sts = self._find_owned_sts(notebook)
            pods = sorted(self.client.list(
                "Pod", ns, {names.NOTEBOOK_NAME_LABEL: nb_name}),
                key=k8s.name)
        status: dict = {
            "readyReplicas": k8s.get_in(sts, "status", "readyReplicas",
                                        default=0) if sts else 0,
            "conditions": [],
            "containerState": {},
        }
        expected = self.desired_replicas(notebook, slice_spec)
        if pods:
            pod0 = pods[0]
            # mirror pod-0's conditions, newest first (reference :322-345)
            status["conditions"] = list(reversed(
                k8s.get_in(pod0, "status", "conditions", default=[]) or []))
            for cs in k8s.get_in(pod0, "status", "containerStatuses",
                                 default=[]) or []:
                if cs.get("name") == nb_name:
                    status["containerState"] = cs.get("state", {})
                    break
        ready_uids = {k8s.name(p): k8s.uid(p) for p in pods
                      if k8s.condition_true(p, "Ready")}
        ready_pods = len(ready_uids)
        slice_ready = expected > 0 and ready_pods >= expected
        # status.workerUIDs = the pod UIDs at MESH FORMATION, stamped in the
        # same status write that publishes SliceReady=True (race-free: one
        # writer, one write). A later PARTIAL difference between these and
        # the live pods means a worker was silently replaced — the restarted
        # worker's runtime (its NCCL communicator) is orphaned even though every pod shows Ready,
        # so the repair controller (slicerepair.py) must roll the slice. A
        # COMPLETE replacement (restart annotation, cull/resume, the repair
        # roll itself) is a consistent new mesh: refresh the baseline.
        prev_uids = k8s.get_in(notebook, "status", "workerUIDs") or {}
        if slice_ready:
            stale = (not prev_uids or set(prev_uids) != set(ready_uids)
                     or all(prev_uids[n] != ready_uids[n] for n in prev_uids))
            status["workerUIDs"] = dict(ready_uids) if stale \
                else dict(prev_uids)
        elif prev_uids:
            status["workerUIDs"] = dict(prev_uids)  # keep through degradation
        status["conditions"].insert(0, {
            "type": api.CONDITION_SLICE_READY,
            "status": "True" if slice_ready else "False",
            "reason": "AllWorkersReady" if slice_ready else "WaitingForWorkers",
            "message": f"{ready_pods}/{expected} workers ready",
        })
        # slice health & repair state (controllers/slicerepair.py) rides the
        # slice-health annotation; while it is set, mirror it as the
        # Slice{Degraded,Repairing,Quarantined} condition triple (healthy
        # slices and CPU notebooks keep the lean SliceReady-only set)
        health = k8s.get_annotation(notebook, names.SLICE_HEALTH_ANNOTATION)
        if health is not None:
            reason = k8s.get_annotation(
                notebook, names.SLICE_HEALTH_REASON_ANNOTATION) or health
            for pos, state in enumerate(api.SLICE_HEALTH_STATES, start=1):
                active = health == state
                status["conditions"].insert(pos, {
                    "type": f"Slice{state}",
                    "status": "True" if active else "False",
                    "reason": reason if active else "SliceHealthy",
                    "message": (f"slice {state.lower()} ({reason})"
                                if active else ""),
                })
        # warm-pool bind state, mirrored alongside SliceReady: True while a
        # pool slice backs this notebook, False (reason Migrating) while a
        # checkpoint migration is between slices; lean set otherwise
        migrating = k8s.get_annotation(notebook,
                                       names.MIGRATION_STATE_ANNOTATION)
        if bound is not None or migrating is not None:
            status["conditions"].insert(1, {
                "type": api.CONDITION_POOL_BOUND,
                "status": "True" if bound is not None else "False",
                "reason": "Bound" if bound is not None else "Migrating",
                "message": (f"bound to pool slice {bound[0]}/{bound[1]}"
                            if bound is not None else
                            f"migration in flight ({migrating})"),
            })
        if k8s.get_in(notebook, "status") != status:
            notebook = k8s.deepcopy(notebook)
            notebook["status"] = status
            try:
                self.client.update_status(notebook)
            except errors.ConflictError:
                pass  # next event re-enqueues


_notebook_container = api.pod_spec_notebook_container


def virtual_service_name(notebook_name: str, namespace: str) -> str:
    """``notebook-<ns>-<name>`` (reference virtualServiceName helper). No
    truncation: VirtualService is not a DNS label, so the 253-char object-name
    limit applies and truncating at 63 could collide two notebooks."""
    return f"notebook-{namespace}-{notebook_name}"


# -------------------------------------------------------------- copy-fields
def _copy_meta_maps(desired: dict, found: dict) -> bool:
    """Copy labels/annotations when they MATERIALLY differ. An absent map
    and an empty map are the same state — comparing them unequal made
    every notebook burn one spurious Service PUT per fan-out (the desired
    Service carries no annotations key; the stored object returns None)."""
    changed = False
    for field in ("labels", "annotations"):
        want = desired["metadata"].get(field) or {}
        have = found["metadata"].get(field) or {}
        if have != want:
            found["metadata"][field] = k8s.deepcopy(want)
            changed = True
    return changed


def copy_statefulset_fields(desired: dict, found: dict) -> bool:
    """Idempotent-update semantics of reconcilehelper.CopyStatefulSetFields
    (components/common/reconcilehelper/util.go:107-143): copy labels,
    annotations, replicas and pod template; leave everything else (incl.
    selector, serviceName on an existing object) untouched. Returns whether
    an update is required."""
    changed = _copy_meta_maps(desired, found)
    if found["spec"].get("replicas") != desired["spec"].get("replicas"):
        found["spec"]["replicas"] = desired["spec"]["replicas"]
        changed = True
    if found["spec"].get("template") != desired["spec"].get("template"):
        found["spec"]["template"] = k8s.deepcopy(desired["spec"]["template"])
        changed = True
    return changed


def copy_virtual_service_fields(desired: dict, found: dict) -> bool:
    """reconcilehelper.CopyVirtualService (util.go:197-219): labels,
    annotations, and the whole (unstructured) spec."""
    changed = _copy_meta_maps(desired, found)
    if found.get("spec") != desired.get("spec"):
        found["spec"] = k8s.deepcopy(desired["spec"])
        changed = True
    return changed


def copy_service_fields(desired: dict, found: dict) -> bool:
    """reconcilehelper.CopyServiceFields (util.go:170-195): labels,
    annotations, selector and ports only — NEVER clusterIP (util.go:182).
    Extended with type/externalName so a warm-pool bind can flip a
    ClusterIP Service to an ExternalName repoint (and back on release)
    through the same drift-gated path."""
    changed = _copy_meta_maps(desired, found)
    for fld in ("selector", "type", "externalName"):
        if found["spec"].get(fld) != desired["spec"].get(fld):
            found["spec"][fld] = k8s.deepcopy(desired["spec"].get(fld))
            changed = True
    if found["spec"].get("ports") != desired["spec"].get("ports"):
        found["spec"]["ports"] = k8s.deepcopy(desired["spec"]["ports"])
        changed = True
    return changed
