"""API Priority & Fairness for the apiserver (kube APF shape).

The port's copy of ``kubeflow_tpu/cluster/apf.py``. Every request is
classified into a FlowSchema, which maps it to a PriorityLevel with a
share of the server's seats; excess demand waits in shuffle-sharded
per-flow queues drained fairly, so one tenant's LIST storm fills its own
level's queues while the controllers keep their seats.

- ``FlowSchema``: ordered match rules over (user-agent, verb, kind); the
  first match wins and its ``distinguisher`` names the request's flow
  (by default the user agent).
- ``PriorityLevel``: a share of the seats and its queue discipline
  (queue count, per-queue bound, shuffle-shard hand size). ``exempt``
  levels bypass queuing; the apiserver exempts watch streams itself (a
  seat held for a stream's life would leak concurrency).
- ``APFDispatcher``:

  * admits at once while the level is below its limit with no backlog;
  * borrows: when every other level's queues are empty, an over-limit
    level takes idle seats up to the server total;
  * otherwise queues the request in the shortest of ``hand_size``
    queues its flow hashes to (shuffle sharding);
  * hands freed seats to levels below their limit first (round-robin),
    then to borrowers; within a level, queues drain round-robin;
  * rejects a full queue or an over-deadline wait with 429 and a
    Retry-After.

Metrics (attach_metrics): ``apf_dispatched_total{priority_level}``,
``apf_rejected_total{priority_level}``,
``apf_current_inqueue{priority_level}``.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from ..controllers.sharding import fnv1a

#: default seat count: concurrency the facade will execute simultaneously.
#: Sized well above a healthy control plane's in-flight request count (a
#: 4-worker manager keeps ≤ ~6 requests in flight) so APF only engages
#: under genuine overload — exactly when it should.
DEFAULT_TOTAL_SEATS = 16
#: how long a queued request may wait for a seat before 429
DEFAULT_QUEUE_WAIT_S = 5.0
#: Retry-After hint on rejections — long enough to shed load, short enough
#: that a healthy retry lands inside the same reconcile attempt
REJECT_RETRY_AFTER_S = 0.5


class RejectedError(Exception):
    """Request rejected by priority & fairness (queue full or wait
    deadline exceeded) — surfaces as 429 + Retry-After on the wire."""

    def __init__(self, level: str, reason: str,
                 retry_after_s: float = REJECT_RETRY_AFTER_S) -> None:
        super().__init__(f"APF rejected ({level}): {reason}")
        self.level = level
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class PriorityLevel:
    name: str
    shares: int                 # nominal fraction of total seats
    queues: int = 16            # shuffle-sharded queue count
    queue_length: int = 128     # per-queue bound; full → 429
    hand_size: int = 2          # candidate queues per flow
    exempt: bool = False        # bypass seats/queues entirely


@dataclass(frozen=True)
class FlowSchema:
    """First-match-wins classification rule. ``match`` sees a request meta
    dict ({user_agent, verb, kind}); ``distinguisher`` buckets matching
    requests into flows (fairness is per flow within a level)."""

    name: str
    priority_level: str
    match: Callable[[dict], bool]
    distinguisher: Callable[[dict], str] = \
        field(default=lambda meta: meta.get("user_agent") or "anonymous")


#: our manager transport identifies itself with this prefix (HttpApiClient
#: user_agent default); anything else is tenant/tooling traffic
CONTROLLER_UA_PREFIX = "kubeflow-tpu"

DEFAULT_LEVELS: tuple[PriorityLevel, ...] = (
    # election heartbeats: starving Lease renewals collapses shard/leader
    # ownership fleet-wide, so they get their own guaranteed seats
    PriorityLevel("leader-election", shares=10, queues=8, queue_length=64),
    # controller reconcile traffic (the repair/culling/pool hot path)
    PriorityLevel("workload-high", shares=40),
    # everything else: tenants, dashboards, kubectl-ish tooling
    PriorityLevel("global-default", shares=20),
)

DEFAULT_SCHEMAS: tuple[FlowSchema, ...] = (
    FlowSchema("system-leases", "leader-election",
               match=lambda meta: meta.get("kind") == "Lease"),
    FlowSchema("kubeflow-controllers", "workload-high",
               match=lambda meta: (meta.get("user_agent") or "").startswith(
                   CONTROLLER_UA_PREFIX)),
    FlowSchema("catch-all", "global-default", match=lambda meta: True),
)


class _Level:
    """Runtime state for one priority level (guarded by the dispatcher
    lock): in-flight seat count + the shuffle-sharded wait queues."""

    __slots__ = ("config", "limit", "in_flight", "queues", "queued",
                 "rr_next")

    def __init__(self, config: PriorityLevel, limit: int) -> None:
        self.config = config
        self.limit = limit
        self.in_flight = 0
        self.queues: list[deque] = [deque() for _ in range(config.queues)]
        self.queued = 0          # total waiters across queues
        self.rr_next = 0         # round-robin drain cursor


class _Waiter:
    __slots__ = ("event", "admitted", "abandoned")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.admitted = False
        self.abandoned = False


class APFDispatcher:
    def __init__(self,
                 levels: tuple[PriorityLevel, ...] = DEFAULT_LEVELS,
                 schemas: tuple[FlowSchema, ...] = DEFAULT_SCHEMAS,
                 total_seats: int = DEFAULT_TOTAL_SEATS,
                 queue_wait_s: float = DEFAULT_QUEUE_WAIT_S) -> None:
        self.total_seats = max(1, int(total_seats))
        self.queue_wait_s = queue_wait_s
        self.schemas = tuple(schemas)
        self._lock = threading.Lock()
        active = [lv for lv in levels if not lv.exempt]
        total_shares = sum(lv.shares for lv in active) or 1
        self._levels: dict[str, _Level] = {}
        for lv in levels:
            limit = max(1, round(self.total_seats * lv.shares /
                                 total_shares)) if not lv.exempt else 0
            self._levels[lv.name] = _Level(lv, limit)
        self._total_in_flight = 0
        # classification fallback for a schema naming an unknown level
        # (or no schema matching): global-default when configured, else
        # the first non-exempt level — never a KeyError mid-request
        self._fallback_level = self._levels.get("global-default") or \
            next((lv for lv in self._levels.values()
                  if not lv.config.exempt),
                 next(iter(self._levels.values())))
        self._rr_levels = itertools.cycle(
            [lv.name for lv in levels if not lv.exempt])
        self._dispatched = None
        self._rejected = None
        self._inqueue = None

    # ------------------------------------------------------------- metrics
    def attach_metrics(self, registry) -> None:
        self._dispatched = registry.counter(
            "apf_dispatched_total",
            "Requests that got a seat, by priority level (borrowed seats "
            "included).")
        self._rejected = registry.counter(
            "apf_rejected_total",
            "Requests rejected with 429 by priority & fairness (queue "
            "full or wait deadline), by priority level.")
        self._inqueue = registry.gauge(
            "apf_current_inqueue",
            "Requests currently waiting in this priority level's queues.")

    def _set_inqueue(self, level: _Level) -> None:
        if self._inqueue is not None:
            self._inqueue.set(level.queued,
                              {"priority_level": level.config.name})

    # -------------------------------------------------------------- policy
    def classify(self, meta: dict) -> tuple[str, str]:
        """(priority level name, flow key) for a request meta dict."""
        for schema in self.schemas:
            try:
                if schema.match(meta):
                    return schema.priority_level, schema.distinguisher(meta)
            except Exception:  # noqa: BLE001 — a broken rule must not 500
                continue       # every request; fall through to the next
        return "global-default", meta.get("user_agent") or "anonymous"

    def _others_idle_locked(self, name: str) -> bool:
        return all(lv.queued == 0 for n, lv in self._levels.items()
                   if n != name and not lv.config.exempt)

    def _admit_locked(self, level: _Level) -> bool:
        """Seat available for a NEW arrival at this level right now? The
        server-wide seat total binds BOTH branches: a level below its
        nominal limit still queues while borrowers hold the last seats —
        the dispatch loop prefers under-limit levels as completions
        reclaim the borrowed seats, so the guarantee is restored one
        completion at a time rather than by over-admitting past the cap."""
        if self._total_in_flight >= self.total_seats:
            return False
        if level.in_flight < level.limit and level.queued == 0:
            return True
        # borrowing: idle seats serve an over-limit level only while no
        # other level has backlog those seats should serve first
        return (level.queued == 0
                and self._others_idle_locked(level.config.name))

    def _shuffle_queue_locked(self, level: _Level, flow: str) -> deque:
        """Shuffle sharding: hash the flow onto ``hand_size`` candidate
        queues, take the shortest — an elephant flow fills its hand while
        other flows almost surely have an uncontended candidate."""
        cfg = level.config
        hand = [fnv1a(f"{flow}\x00{i}") % cfg.queues
                for i in range(max(1, cfg.hand_size))]
        return min((level.queues[i] for i in hand), key=len)

    # ------------------------------------------------------------ lifecycle
    def acquire(self, meta: dict) -> str:
        """Block until the request holds a seat; returns the level name
        (the ticket for release()). Raises RejectedError → 429."""
        return self.acquire_info(meta)[0]

    def acquire_info(self, meta: dict) -> tuple[str, bool]:
        """``acquire`` plus dispatch provenance: ``(ticket, queued)`` where
        ``queued`` is True when the request sat in a priority-level queue
        before getting its seat (what the server's ``apf.wait`` span
        records) rather than being admitted immediately."""
        name, flow = self.classify(meta)
        level = self._levels.get(name) or self._fallback_level
        name = level.config.name  # the release ticket must name a REAL level
        if level.config.exempt:
            return name, False
        waiter = None
        with self._lock:
            if self._admit_locked(level):
                level.in_flight += 1
                self._total_in_flight += 1
                if self._dispatched is not None:
                    self._dispatched.inc({"priority_level": name})
                return name, False
            queue = self._shuffle_queue_locked(level, flow)
            if len(queue) >= level.config.queue_length:
                if self._rejected is not None:
                    self._rejected.inc({"priority_level": name})
                raise RejectedError(name, "queue full")
            waiter = _Waiter()
            queue.append(waiter)
            level.queued += 1
            self._set_inqueue(level)
        if waiter.event.wait(self.queue_wait_s):
            return name, True  # dispatched by a releasing request
        with self._lock:
            if waiter.admitted:
                # the dispatch raced our timeout and won: we hold a seat
                return name, True
            waiter.abandoned = True  # lazily skipped at dispatch
            level.queued -= 1
            self._set_inqueue(level)
            if self._rejected is not None:
                self._rejected.inc({"priority_level": name})
        raise RejectedError(name, "queue wait deadline exceeded")

    def release(self, ticket: str) -> None:
        level = self._levels.get(ticket)
        if level is None or level.config.exempt:
            return
        with self._lock:
            level.in_flight = max(0, level.in_flight - 1)
            self._total_in_flight = max(0, self._total_in_flight - 1)
            self._dispatch_locked()

    def _pop_waiter_locked(self, level: _Level) -> _Waiter | None:
        """Next live waiter from the level's queues, round-robin across
        queues (per-queue FIFO = per-flow FIFO after shuffle sharding)."""
        cfg = level.config
        for off in range(cfg.queues):
            queue = level.queues[(level.rr_next + off) % cfg.queues]
            while queue:
                waiter = queue.popleft()
                if waiter.abandoned:
                    continue  # timed out while queued; already uncounted
                level.rr_next = (level.rr_next + off + 1) % cfg.queues
                return waiter
        return None

    def _dispatch_locked(self) -> None:
        """Hand freed seats to queued work: levels below their nominal
        limit first, then borrowing levels while seats stay idle."""
        while self._total_in_flight < self.total_seats:
            candidate = None
            # one full rotation over levels below their limit with backlog
            for _ in range(len(self._levels)):
                name = next(self._rr_levels)
                lv = self._levels[name]
                if lv.queued > 0 and lv.in_flight < lv.limit:
                    candidate = lv
                    break
            if candidate is None:
                # no under-limit backlog: borrow for any backlog at all
                for _ in range(len(self._levels)):
                    name = next(self._rr_levels)
                    lv = self._levels[name]
                    if lv.queued > 0:
                        candidate = lv
                        break
            if candidate is None:
                return
            waiter = self._pop_waiter_locked(candidate)
            if waiter is None:
                candidate.queued = 0  # defensive: queues were all ghosts
                self._set_inqueue(candidate)
                continue
            candidate.queued -= 1
            candidate.in_flight += 1
            self._total_in_flight += 1
            waiter.admitted = True
            self._set_inqueue(candidate)
            if self._dispatched is not None:
                self._dispatched.inc(
                    {"priority_level": candidate.config.name})
            waiter.event.set()

    # --------------------------------------------------------- introspection
    def snapshot(self) -> dict:
        """{level: {in_flight, queued, limit}} — test/debug introspection."""
        with self._lock:
            return {name: {"in_flight": lv.in_flight, "queued": lv.queued,
                           "limit": lv.limit}
                    for name, lv in self._levels.items()}

