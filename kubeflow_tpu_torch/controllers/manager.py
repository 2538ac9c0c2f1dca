"""Controller manager: workqueue, watch wiring, requeue semantics.

The port's copy of ``kubeflow_tpu/controllers/manager.py``. It plays the
role of sigs.k8s.io/controller-runtime's manager + per-controller
workqueues (reference main.go:58-148 registers reconcilers on one
manager; SetupWithManager wires watches, notebook_controller.go:778-826):

- a reconcile Request is (namespace, name); events are coalesced per key;
- reconcilers return a ``Result`` (requeue_after seconds) or raise → error
  backoff requeue;
- watches map secondary objects (Pods, Events, owned resources) back to
  the owning Notebook key;
- with a ``read_cache`` (the reference's manager cache, a
  ``cluster/cache.py`` ``CachingClient``), every watch feeds the cache
  before its tee and predicate run and backfills the kind once the
  stream is live, so reconcilers read watch-fed copies.

Two drive modes:
- ``run_until_idle()``: deterministic draining on the calling thread, for
  tests and benchmarks;
- ``start()/stop()``: a pool of ``max_concurrent_reconciles`` daemon
  worker threads with timed requeues, the production shape.

Dispatch state machine (client-go workqueue parity)
---------------------------------------------------

Each key is in at most one of three states:

- **queued**: an immediate item waits in the heap; further immediate adds
  for the key coalesce (dropped).
- **processing**: a worker is reconciling the key. A key being processed
  is never handed to a second worker.
- **dirty**: an event arrived for a key that was processing; when the
  worker finishes, the key is re-enqueued exactly once. A timed requeue
  that fires while its key is processing converts to dirty the same way.

Timed requeues (AddAfter) dedup per key on the earliest pending deadline;
superseded heap entries become ghosts discarded lazily at pop. Error
backoff is max(per-key exponential, a 10 qps / 100 burst token bucket),
client-go's DefaultControllerRateLimiter (``controllers/resilience.py``
``TokenBucket``; ``rate_limiter=False`` turns it off).

The binaries' seams (each optional, each wired by ``setup_controllers``):

- ``leader_elector`` (``controllers/election.py``): workers park while
  this replica does not hold the lease (watches keep enqueueing); an item
  popped after the lease moved goes back to the queue untouched
  (``_release_undispatched``); ``stop()`` joins the pool before it
  releases the lease, so a standby never runs beside our workers;
- ``breaker`` (``controllers/resilience.py`` ``CircuitBreaker``): workers
  park while the apiserver circuit is open, offering the half-open
  probe; its close runs ``resync_all``, which lists every watched kind
  and re-enqueues through each watch's predicate and mapper;
- ``sharding`` (``controllers/sharding.py`` ``ShardCoordinator``, through
  ``set_sharding``): every enqueue and dispatch is filtered by the
  namespace's shard, and acquiring shards replays exactly their keys
  (``resync_shards``);
- ``health_server`` (``utils/health.py``) and ``webhook_server``
  (``webhook/server.py``), started and stopped with the manager (the
  webhook server by ``main.main``).

Workqueue metrics (``attach_metrics``; label ``name`` = controller):
``workqueue_adds_total``, ``workqueue_retries_total``, ``workqueue_depth``
(live queued keys, not ghosts or in-flight items),
``workqueue_queue_duration_seconds``, ``workqueue_work_duration_seconds``,
``workqueue_unfinished_work_seconds``,
``workqueue_longest_running_processor_seconds``, and
``controller_runtime_reconcile_total{controller,result}``; and
``reconcile_read_seconds`` / ``reconcile_write_seconds{controller}``,
each reconcile's wall time in client reads and writes as the echo
client (``cluster/echo.py``) records it through the phase collector of
``utils/metrics.py``.

Tracing (only while ``tracing.is_recording()``; the untraced call
shapes stay as they are): a watch callback hands ``enqueue`` the
object's carried ``TRACE_CONTEXT_ANNOTATION``, its kind, the event type
and the delivery time (``trace_info``); ``_process`` opens each
reconcile's ``reconcile`` root (controller, namespace, name and the
``reconcile.key`` the flight recorder binds by), parented on that
context and backdated over the queue wait, with ``workqueue.enqueue``
and ``workqueue.wait`` children and, after the reconcile, the phase
collector's ``reconcile.read``/``reconcile.write`` legs. The queue,
work and phase histograms take the trace as an exemplar, and a failed
reconcile is recorded on its root. ``_process`` sets
``utils/logging.py``'s ``reconcile_key_var`` around every reconcile,
traced or not.

The port's locks are plain ``threading`` locks: the reference's lock
sanitizer (``kubeflow_tpu/utils/sanitizer.py``) is a test tool of the
reference and is not copied, so nothing here reads ``KFTPU_SANITIZE``.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Protocol

from ..cluster.store import WatchEvent
from ..utils import k8s, names, tracing
from ..utils import logging as logging_mod
from ..utils import metrics as metrics_mod
from .resilience import TokenBucket

log = logging.getLogger("kubeflow_tpu_torch.manager")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.manager")


@dataclass(frozen=True)
class Request:
    namespace: str
    name: str


@dataclass
class Result:
    requeue_after: float | None = None  # seconds


class Reconciler(Protocol):
    name: str

    def reconcile(self, req: Request) -> Result | None: ...


@dataclass(order=True)
class _QueueItem:
    ready_at: float
    seq: int
    controller: str = field(compare=False)
    req: Request = field(compare=False)
    timed: bool = field(compare=False, default=False)


class Manager:
    ERROR_BACKOFF_BASE = 0.005   # the 5 ms base of client-go's item limiter
    ERROR_BACKOFF_MAX = 2.0
    # how long a parked worker sleeps between breaker checks while the
    # apiserver circuit is open (each check also offers the probe)
    BREAKER_PARK_POLL_S = 0.05

    def __init__(self, client, read_cache=None,
                 max_concurrent_reconciles: int = 4,
                 rate_limiter=None) -> None:
        self.client = client
        # the shared informer layer: when set, every watch this manager
        # registers feeds its events into the cache and backfills the
        # kind, so reconciler reads through it are watch-fed
        self.read_cache = read_cache
        # pool size AND the default per-controller in-flight cap
        # (controller-runtime's MaxConcurrentReconciles; register() can
        # lower it per controller)
        self.max_concurrent_reconciles = max(1, int(max_concurrent_reconciles))
        self._reconcilers: dict[str, Reconciler] = {}
        self._max_concurrent: dict[str, int] = {}
        self._queue: list[_QueueItem] = []
        self._queued: set[tuple[str, Request]] = set()
        # earliest pending timed requeue per key (AddAfter dedup)
        self._timed_pending: dict[tuple[str, Request], float] = {}
        # keys being reconciled right now → monotonic start time
        self._processing: dict[tuple[str, Request], float] = {}
        # keys that received an immediate add (or a firing timed requeue)
        # while processing; re-enqueued exactly once when the worker is done
        self._dirty: set[tuple[str, Request]] = set()
        # in-flight count per controller (enforces the per-controller cap)
        self._active: dict[str, int] = {}
        # ready items parked while their controller is at its cap, spliced
        # back one at a time as slots free
        self._capped: dict[str, list[_QueueItem]] = {}
        self._failures: dict[tuple[str, Request], int] = {}
        # trace carry, filled only while a recording provider is
        # installed: key → (SpanContext | None, kind, event type, wall
        # time of the watch delivery), written by watch callbacks and
        # popped when the key dispatches, so its reconcile root joins the
        # trace that caused it; coalesced events overwrite (the reconcile
        # observes the last cause)
        self._key_trace: dict[tuple[str, Request], tuple] = {}
        self._cv = threading.Condition()
        self._seq = 0
        self._running = False
        self._threads: list[threading.Thread] = []
        # optional active/passive HA: workers park until this replica
        # holds the lease
        self.leader_elector = None
        # optional healthz/readyz/metrics endpoints and admission server
        self.health_server = None
        self.webhook_server = None
        # the overall error-requeue limiter (10 qps / 100 burst composed
        # with the per-key exponential by max); False turns it off
        if rate_limiter is None:
            rate_limiter = TokenBucket(qps=10.0, burst=100)
        self.rate_limiter = rate_limiter or None
        # optional apiserver circuit breaker: workers park while it is open
        self.breaker = None
        # (kind, controller, mapper, predicate) per watch: what
        # resync_all() replays
        self._watch_specs: list[tuple[str, str, Callable | None,
                                      Callable | None]] = []
        # optional sharded ownership (set_sharding); None owns everything
        self.sharding = None
        # the registry attach_metrics registered the workqueue family on
        self.metrics = None
        self._reconcile_metric = None
        self._wq_adds = None
        self._wq_retries = None
        self._wq_queue_duration = None
        self._wq_work_duration = None
        self._read_seconds = None
        self._write_seconds = None

    def attach_metrics(self, registry) -> None:
        self.metrics = registry
        self._reconcile_metric = registry.counter(
            "controller_runtime_reconcile_total",
            "Total reconciliations per controller, by result.")
        self._wq_adds = registry.counter(
            "workqueue_adds_total",
            "Total adds handled by the workqueue (every enqueue call, "
            "coalesced or not).")
        self._wq_retries = registry.counter(
            "workqueue_retries_total",
            "Total retries handled by the workqueue (error-backoff "
            "requeues + reconciler conflict fast-retries).")
        self._wq_queue_duration = registry.histogram(
            "workqueue_queue_duration_seconds",
            "How long an item stays ready in the workqueue before a "
            "worker picks it up.")
        self._wq_work_duration = registry.histogram(
            "workqueue_work_duration_seconds",
            "How long processing an item takes.")
        self._read_seconds = registry.histogram(
            "reconcile_read_seconds",
            "Per-reconcile wall spent in client READS (get/list/"
            "get_owned), by controller. Cached reads keep this in "
            "microseconds; a regression to wire reads shows here first.")
        self._write_seconds = registry.histogram(
            "reconcile_write_seconds",
            "Per-reconcile wall spent in client WRITES (create/update/"
            "patch/delete), by controller. Drift-gated patches keep the "
            "steady state at zero.")
        depth = registry.gauge(
            "workqueue_depth", "Current depth of the reconcile workqueue.")
        unfinished = registry.gauge(
            "workqueue_unfinished_work_seconds",
            "Sum of in-flight (processing) item ages.")
        longest = registry.gauge(
            "workqueue_longest_running_processor_seconds",
            "Age of the oldest in-flight item.")

        def scrape() -> None:
            # depth counts live queued work only: immediate keys + the
            # earliest timed requeue per key, never ghosts or in-flight items
            with self._cv:
                now = time.monotonic()
                per_controller: dict[str, int] = {}
                for controller, _req in list(self._queued) + \
                        list(self._timed_pending):
                    per_controller[controller] = \
                        per_controller.get(controller, 0) + 1
                unfinished_per: dict[str, float] = {}
                longest_per: dict[str, float] = {}
                for (controller, _req), started in self._processing.items():
                    age = max(now - started, 0.0)
                    unfinished_per[controller] = \
                        unfinished_per.get(controller, 0.0) + age
                    longest_per[controller] = \
                        max(longest_per.get(controller, 0.0), age)
            for name in self._reconcilers:
                depth.set(per_controller.get(name, 0), {"name": name})
                unfinished.set(unfinished_per.get(name, 0.0), {"name": name})
                longest.set(longest_per.get(name, 0.0), {"name": name})
        registry.on_scrape(scrape)

    def _count_reconcile(self, controller: str, result: str) -> None:
        if self._reconcile_metric is not None:
            self._reconcile_metric.inc({"controller": controller,
                                        "result": result})

    # ---------------------------------------------------------------- wiring
    def register(self, reconciler: Reconciler,
                 max_concurrent_reconciles: int | None = None) -> None:
        """Register a reconciler; ``max_concurrent_reconciles`` caps this
        controller's in-flight reconciles (default: the manager-wide
        value)."""
        self._reconcilers[reconciler.name] = reconciler
        if max_concurrent_reconciles is not None:
            self._max_concurrent[reconciler.name] = \
                max(1, int(max_concurrent_reconciles))

    def watch(self, kind: str, controller: str,
              mapper: Callable[[dict], list[Request]] | None = None,
              predicate: Callable[[WatchEvent], bool] | None = None,
              tee: Callable[[WatchEvent], None] | None = None) -> None:
        """Wire a store watch into a controller's queue. ``mapper`` converts
        the observed object into reconcile requests (default: the object's
        own key; ``owner_mapper`` below is the Owns()-style mapping).
        ``tee`` observes every event before the predicate and mapper run,
        after the manager's read cache (if any) has ingested it."""
        cache = self.read_cache

        def cb(event: WatchEvent) -> None:
            if cache is not None:
                try:
                    cache.feed(event)
                except Exception:  # cache feeding must never break dispatch
                    log.exception("cache feed failed for %s", kind)
            if tee is not None:
                try:
                    tee(event)
                except Exception:  # a tee must never break dispatch
                    log.exception("watch tee failed for %s", kind)
            if predicate is not None and not predicate(event):
                return
            reqs = (mapper(event.obj) if mapper is not None
                    else [Request(k8s.namespace(event.obj),
                                  k8s.name(event.obj))])
            trace_info = None
            if tracing.is_recording():
                # the object's carried trace context and what caused this
                # enqueue: the workqueue.enqueue/wait spans when the key
                # dispatches
                ann = (event.obj.get("metadata") or {}) \
                    .get("annotations") or {}
                trace_info = (
                    tracing.parse_traceparent(
                        ann.get(names.TRACE_CONTEXT_ANNOTATION)),
                    kind, event.type, time.time())
            for req in reqs:
                # the keyword only while tracing: the untraced call shape
                # stays what it was
                if trace_info is not None:
                    self.enqueue(controller, req, trace_info=trace_info)
                else:
                    self.enqueue(controller, req)
        self._watch_specs.append((kind, controller, mapper, predicate))
        self.client.watch(kind, cb)
        if cache is not None:
            try:
                cache.backfill(kind)  # idempotent; after the stream is live
            except Exception:  # noqa: BLE001 — a failed LIST at set-up
                # leaves this kind's reads live (correct, just slower)
                log.warning("read-cache backfill for %s failed; reads stay "
                            "live", kind, exc_info=True)

    def set_sharding(self, coordinator) -> None:
        """Install sharded ownership: the coordinator's shard map filters
        every enqueue (watch mappers included) and every dispatch;
        acquiring shards replays exactly the moved namespaces' keys
        through ``resync_shards``. The coordinator starts and stops with
        the manager."""
        self.sharding = coordinator
        coordinator.on_acquired = self.resync_shards

    def resync_shards(self, shards) -> int:
        """Re-enqueue every watched key whose namespace hashes into
        ``shards``: the handoff resync after acquiring ownership."""
        coordinator = self.sharding
        if coordinator is None:
            return 0
        shards = set(shards)
        shard_map = coordinator.shard_map
        return self.resync_all(
            namespace_filter=lambda ns: shard_map.shard_for(ns) in shards)

    def enqueue(self, controller: str, req: Request, after: float = 0.0,
                trace_info: tuple | None = None) -> None:
        if self.sharding is not None and \
                not self.sharding.owns_namespace(req.namespace):
            return  # a foreign shard's key: its owner's watches queue it
        with self._cv:
            if self._wq_adds is not None:
                self._wq_adds.inc({"name": controller})
            key = (controller, req)
            if trace_info is not None:
                self._key_trace[key] = trace_info
            if after == 0.0:
                if key in self._processing:
                    # in-flight: mark dirty; _finish re-enqueues exactly once
                    self._dirty.add(key)
                    return
                if key in self._queued:
                    return
                self._queued.add(key)
                self._seq += 1
                heapq.heappush(self._queue,
                               _QueueItem(time.monotonic(), self._seq,
                                          controller, req))
            else:
                ready_at = time.monotonic() + after
                pending = self._timed_pending.get(key)
                if pending is not None and pending <= ready_at:
                    self._cv.notify_all()
                    return  # an earlier (or equal) timed requeue exists
                self._timed_pending[key] = ready_at
                self._seq += 1
                heapq.heappush(self._queue,
                               _QueueItem(ready_at, self._seq, controller,
                                          req, timed=True))
            self._cv.notify_all()

    def resync_all(self, namespace_filter: Callable[[str], bool] | None
                   = None) -> int:
        """Full resync: list every watched kind and re-enqueue through the
        registered predicates and mappers, the recovery the circuit
        breaker runs on close. Each re-enqueue counts in
        ``workqueue_retries_total`` (a resync is a retry of the world).
        The LISTs ride ``list_cached`` when the client offers it (the
        apiserver's rv=0 cache-served form), so managers re-listing at
        once cannot stampede the store's write path.
        ``namespace_filter`` scopes the resync to matching request
        namespaces (``resync_shards``). Returns the requests enqueued."""
        count = 0
        lister = getattr(self.client, "list_cached", None) or \
            self.client.list
        for kind, controller, mapper, predicate in list(self._watch_specs):
            try:
                objs = lister(kind)
            except Exception as exc:  # noqa: BLE001 — one kind failing to
                # list must not abort the rest of the resync
                log.warning("resync list %s failed: %s", kind, exc)
                continue
            for obj in objs:
                if predicate is not None:
                    # replayed through the watch's own filter as a
                    # synthetic MODIFIED, the informer-resync shape
                    try:
                        if not predicate(WatchEvent("MODIFIED", obj)):
                            continue
                    except Exception:  # noqa: BLE001 — skip, as the live
                        # watch path drops a raising predicate too
                        log.exception("resync predicate failed for %s",
                                      kind)
                        continue
                reqs = (mapper(obj) if mapper is not None
                        else [Request(k8s.namespace(obj), k8s.name(obj))])
                for req in reqs:
                    if namespace_filter is not None and \
                            not namespace_filter(req.namespace):
                        continue
                    if self._wq_retries is not None:
                        self._wq_retries.inc({"name": controller})
                    self.enqueue(controller, req)
                    count += 1
        return count

    # --------------------------------------------------------------- driving
    def _cap(self, controller: str) -> int:
        return self._max_concurrent.get(controller,
                                        self.max_concurrent_reconciles)

    def _consume_locked(self, item: _QueueItem,
                        key: tuple[str, Request]) -> None:
        """Remove a popped item's live-state marker (caller holds _cv)."""
        if item.timed:
            del self._timed_pending[key]
        else:
            self._queued.discard(key)

    def _requeue_immediate_locked(self, controller: str, req: Request,
                                  ready_at: float) -> None:
        """Queue an immediate item unless one is already queued (caller
        holds _cv): an internal state transition, not a new add."""
        key = (controller, req)
        if key not in self._queued:
            self._queued.add(key)
            self._seq += 1
            heapq.heappush(self._queue,
                           _QueueItem(ready_at, self._seq, controller, req))

    def _unblock_locked(self, controller: str) -> None:
        """A slot freed for ``controller``: return one of its cap-blocked
        items to the heap (caller holds _cv), discarding ghosts."""
        blocked = self._capped.get(controller)
        while blocked:
            item = blocked.pop(0)
            key = (item.controller, item.req)
            if (item.timed and
                    self._timed_pending.get(key) != item.ready_at) or \
                    (not item.timed and key not in self._queued):
                continue  # superseded while parked; discard the ghost
            heapq.heappush(self._queue, item)
            break
        if not blocked:
            self._capped.pop(controller, None)

    def _dispatch_one(self, block: bool) -> _QueueItem | None:
        """Pop the next dispatchable ready item and mark it processing.

        Skips (a) superseded timed ghosts, (b) items whose key is already
        processing (they convert to dirty, the entry is consumed) and (c)
        items whose controller is at its in-flight cap (parked in
        _capped until a slot frees)."""
        with self._cv:
            while True:
                now = time.monotonic()
                found: _QueueItem | None = None
                while self._queue and self._queue[0].ready_at <= now:
                    item = heapq.heappop(self._queue)
                    key = (item.controller, item.req)
                    if item.timed:
                        if self._timed_pending.get(key) != item.ready_at:
                            continue  # superseded by an earlier requeue
                    elif key not in self._queued:
                        continue  # stale entry (defensive)
                    if key in self._processing:
                        self._consume_locked(item, key)
                        self._dirty.add(key)
                        continue
                    if self._active.get(item.controller, 0) >= \
                            self._cap(item.controller):
                        self._capped.setdefault(item.controller,
                                                []).append(item)
                        continue
                    self._consume_locked(item, key)
                    found = item
                    break
                if found is not None:
                    started = time.monotonic()
                    self._processing[(found.controller, found.req)] = started
                    self._active[found.controller] = \
                        self._active.get(found.controller, 0) + 1
                    queue_wait = max(started - found.ready_at, 0.0)
                    found.queue_wait = queue_wait  # read by _process
                    if self._wq_queue_duration is not None:
                        exemplar = None
                        if tracing.is_recording():
                            carried = self._key_trace.get(
                                (found.controller, found.req))
                            ctx = carried[0] if carried else None
                            if ctx is not None:
                                exemplar = {
                                    "trace_id": f"{ctx.trace_id:032x}"}
                        self._wq_queue_duration.observe(
                            queue_wait, {"name": found.controller},
                            exemplar=exemplar)
                    return found
                if not block or not self._running:
                    return None
                # the heap head is the earliest future deadline
                next_future = self._queue[0].ready_at if self._queue else None
                self._cv.wait(timeout=None if next_future is None
                              else max(next_future - now, 0))

    def _finish(self, item: _QueueItem) -> None:
        """Worker is done with ``item``: clear processing state, return a
        cap-blocked sibling to the heap, and re-enqueue the key iff it went
        dirty while in flight."""
        key = (item.controller, item.req)
        with self._cv:
            self._processing.pop(key, None)
            self._active[item.controller] = \
                max(0, self._active.get(item.controller, 1) - 1)
            self._unblock_locked(item.controller)
            if key in self._dirty:
                self._dirty.discard(key)
                self._requeue_immediate_locked(item.controller, item.req,
                                               time.monotonic())
            self._cv.notify_all()

    def _release_undispatched(self, item: _QueueItem) -> None:
        """Return a popped but unprocessed item to the queue untouched
        (the lease moved between pop and process): clear the processing
        state without counting a reconcile, restore the item in its lane
        (a timed requeue keeps its deadline and AddAfter bookkeeping, an
        immediate item stays immediate), and turn a dirty mark picked up
        meanwhile into the immediate re-run it stands for."""
        key = (item.controller, item.req)
        with self._cv:
            self._processing.pop(key, None)
            self._active[item.controller] = \
                max(0, self._active.get(item.controller, 1) - 1)
            self._unblock_locked(item.controller)
            if item.timed:
                pending = self._timed_pending.get(key)
                if pending is None or pending > item.ready_at:
                    self._timed_pending[key] = item.ready_at
                    self._seq += 1
                    heapq.heappush(self._queue,
                                   _QueueItem(item.ready_at, self._seq,
                                              item.controller, item.req,
                                              timed=True))
            else:
                self._requeue_immediate_locked(item.controller, item.req,
                                               item.ready_at)
            if key in self._dirty:
                self._dirty.discard(key)
                self._requeue_immediate_locked(item.controller, item.req,
                                               time.monotonic())
            self._cv.notify_all()

    def _process(self, item: _QueueItem) -> None:
        """Reconcile one dispatched item. Untraced, straight to
        ``_reconcile_item``; with a recording provider, inside the
        ``reconcile`` root span (parented on the context the triggering
        watch event carried, backdated over the queue wait) with its
        ``workqueue.enqueue``/``workqueue.wait`` children."""
        key_token = logging_mod.reconcile_key_var.set(
            f"{item.req.namespace}/{item.req.name}")
        try:
            if not tracing.is_recording():
                self._reconcile_item(item)
                return
            with self._cv:
                carried = self._key_trace.pop((item.controller, item.req),
                                              None)
            parent, kind, event_type, delivered_at = \
                carried if carried is not None else (None, None, None, None)
            now = time.time()
            queue_wait = getattr(item, "queue_wait", 0.0)
            wait_start = now - queue_wait
            with _TRACER.start_span(
                    "reconcile",
                    {"controller": item.controller,
                     "k8s.namespace": item.req.namespace,
                     "k8s.name": item.req.name,
                     tracing.KEY_ATTRIBUTE:
                         f"{item.req.namespace}/{item.req.name}"},
                    parent=parent) as span:
                # the root covers the whole dispatch cycle: backdated to
                # the watch delivery (or the queue-ready time), the queue
                # wait is inside the trace, not a gap before it
                span.start_time = min(delivered_at or wait_start, wait_start)
                if delivered_at is not None:
                    _TRACER.emit_span(
                        "workqueue.enqueue", delivered_at, wait_start,
                        {"k8s.kind": kind, "event": event_type,
                         "controller": item.controller})
                _TRACER.emit_span(
                    "workqueue.wait", wait_start, now,
                    {"controller": item.controller})
                self._reconcile_item(item)
        finally:
            logging_mod.reconcile_key_var.reset(key_token)

    def _reconcile_item(self, item: _QueueItem) -> None:
        rec = self._reconcilers.get(item.controller)
        if rec is None:
            return
        if self.sharding is not None and \
                not self.sharding.owns_namespace(item.req.namespace):
            # ownership moved between enqueue and dispatch: drop; the new
            # owner's handoff resync replays the key
            return
        key = (item.controller, item.req)
        started = time.monotonic()
        metrics_mod.phase_collect_start()
        try:
            result = rec.reconcile(item.req)
        except Exception as exc:  # noqa: BLE001 — error→requeue, never crash
            with self._cv:
                failures = self._failures.get(key, 0) + 1
                self._failures[key] = failures
            backoff = min(self.ERROR_BACKOFF_BASE * (2 ** failures),
                          self.ERROR_BACKOFF_MAX)
            if self.rate_limiter is not None:
                # MaxOfRateLimiter: the bucket stretches the delay only
                # once the aggregate error rate spends its burst
                backoff = max(backoff, self.rate_limiter.next_delay())
            log.warning("reconcile %s %s failed (%s); requeue in %.3fs",
                        item.controller, item.req, exc, backoff)
            tracing.current_span().record_exception(exc)
            self._count_reconcile(item.controller, "error")
            if self._wq_retries is not None:
                self._wq_retries.inc({"name": item.controller})
            if self._wq_work_duration is not None:
                self._wq_work_duration.observe(
                    time.monotonic() - started, {"name": item.controller},
                    exemplar=tracing.current_exemplar())
            self._observe_phases(item.controller)
            self.enqueue(item.controller, item.req, after=backoff)
            return
        with self._cv:
            self._failures.pop(key, None)
        if result is not None and result.requeue_after is not None:
            self._count_reconcile(item.controller, "requeue_after")
            self.enqueue(item.controller, item.req,
                         after=result.requeue_after)
        else:
            self._count_reconcile(item.controller, "success")
        if self._wq_work_duration is not None:
            self._wq_work_duration.observe(
                time.monotonic() - started, {"name": item.controller},
                exemplar=tracing.current_exemplar())
        self._observe_phases(item.controller)

    def _observe_phases(self, controller: str) -> None:
        phases = metrics_mod.phase_collect_finish()
        if self._read_seconds is not None:
            exemplar = tracing.current_exemplar()
            self._read_seconds.observe(phases.get("read", 0.0),
                                       {"controller": controller},
                                       exemplar=exemplar)
            self._write_seconds.observe(phases.get("write", 0.0),
                                        {"controller": controller},
                                        exemplar=exemplar)
        if tracing.is_recording():
            # the phase collector's legs: the read and write totals are
            # exact, their placement (write ending now, read just before)
            # approximate: the collector sums interleaved verb durations,
            # it records no intervals
            now = time.time()
            read_s = phases.get("read", 0.0)
            write_s = phases.get("write", 0.0)
            if write_s > 0.0:
                _TRACER.emit_span("reconcile.write", now - write_s, now,
                                  {"controller": controller})
            if read_s > 0.0:
                _TRACER.emit_span("reconcile.read", now - write_s - read_s,
                                  now - write_s,
                                  {"controller": controller})

    def run_until_idle(self, timeout: float = 30.0,
                       include_delayed_under: float = 0.0) -> int:
        """Drain the queue on the calling thread; returns the number of
        reconciles this call ran. Timed requeues further than
        ``include_delayed_under`` seconds out are left pending.

        Idle means: no live queued item within the window and nothing
        processing. With background workers running, this call drains
        alongside them and does not return while their items are in
        flight. Waits ride the condition variable; there is no polling."""
        deadline = time.monotonic() + timeout
        count = 0
        while time.monotonic() < deadline:
            item = self._dispatch_one(block=False)
            if item is not None:
                try:
                    self._process(item)
                finally:
                    self._finish(item)
                count += 1
                continue
            with self._cv:
                now = time.monotonic()
                live = [q.ready_at for q in self._queue
                        if (q.ready_at - now <= include_delayed_under)
                        and (self._timed_pending.get(
                                (q.controller, q.req)) == q.ready_at
                             if q.timed
                             else (q.controller, q.req) in self._queued)]
                if not live and not self._processing:
                    return count
                ready_now = any(t <= now for t in live)
                if ready_now and not self._processing:
                    continue  # dispatchable again (e.g. a dirty re-add raced)
                wait = deadline - now
                next_future = min((t for t in live if t > now), default=None)
                if next_future is not None and not self._processing:
                    wait = min(wait, next_future - now)
                if wait > 0:
                    self._cv.wait(wait)
        return count

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        if self.leader_elector is not None:
            self.leader_elector.start()
        if self.sharding is not None:
            self.sharding.start()
        if self.health_server is not None:
            self.health_server.start()
        # the pool is raised to the highest per-controller cap
        n = max(self.max_concurrent_reconciles,
                *(self._max_concurrent.values() or (1,)))
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"kubeflow-tpu-torch-manager-{i}")
            for i in range(n)]
        for t in self._threads:
            t.start()

    def is_alive(self) -> bool:
        """The full pool is running (the healthz hook)."""
        return bool(self._threads) and all(t.is_alive()
                                           for t in self._threads)

    def _worker(self) -> None:
        while True:  # exits on _running=False
            with self._cv:
                if not self._running:
                    return
            item: _QueueItem | None = None
            try:
                if self.leader_elector is not None and \
                        not self.leader_elector.is_leader():
                    # a parked standby; watches still enqueue. Leadership
                    # changes no faster than the renew loop: pace on it
                    time.sleep(min(self.leader_elector.renew_period / 4,
                                   0.5))
                    continue
                if self.breaker is not None and \
                        not self.breaker.allow_dispatch():
                    # the apiserver circuit is open: park and offer the
                    # half-open probe; its close resyncs
                    self.breaker.maybe_probe()
                    time.sleep(self.BREAKER_PARK_POLL_S)
                    continue
                item = self._dispatch_one(block=True)
                if item is None:
                    continue
                # the lease may have moved during the blocking pop
                if self.leader_elector is not None and \
                        not self.leader_elector.is_leader():
                    self._release_undispatched(item)
                    continue
                try:
                    self._process(item)
                finally:
                    self._finish(item)
            except Exception:  # noqa: BLE001 — a worker must never die
                log.exception("manager worker iteration failed; continuing")
                if item is not None:
                    with self._cv:
                        held = (item.controller, item.req) in self._processing
                    if held:
                        self._finish(item)

    def stop(self) -> None:
        """Stop the pool (in-flight reconciles finish; each join waits at
        most 5 s), then release the leader lease and every shard lease
        and stop the health server: the pool quiesces while we still
        hold the lease, so a standby never runs beside our workers."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        if self.leader_elector is not None:
            self.leader_elector.stop()
        if self.sharding is not None:
            self.sharding.stop()
        if self.health_server is not None:
            self.health_server.stop()


def owner_mapper(owner_kind: str) -> Callable[[dict], list[Request]]:
    """Owns()-style mapping: enqueue the controller owner of the observed
    object."""
    def mapper(obj: dict) -> list[Request]:
        for ref in k8s.get_in(obj, "metadata", "ownerReferences",
                              default=[]) or []:
            if ref.get("kind") == owner_kind and ref.get("controller"):
                return [Request(k8s.namespace(obj), ref["name"])]
        return []
    return mapper
