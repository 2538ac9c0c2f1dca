"""Sharded reconcile ownership: namespace-hash shard map + per-shard leases.

The port's copy of ``kubeflow_tpu/controllers/sharding.py``. The control
plane scales horizontally the way Podracer scales RL actors: homogeneous
workers own disjoint partitions of the key space, and throughput grows by
adding workers without touching any worker's hot path. The partition key
is the namespace: every reconcile Request is (namespace, name), and all of
one notebook's secondary objects live in its namespace, so
namespace-granular ownership keeps each key's whole object graph on one
manager.

Three layers, each testable on its own:

- ``ShardMap``: namespace → shard via FNV-1a and Lamport's jump
  consistent hash. Deterministic across processes (no PYTHONHASHSEED
  dependence) and minimal-movement on resize: growing ``shards`` N→N+1
  moves only ~1/(N+1) of namespaces, all of them into the new shard.

- ``assign_shards``: shard → desired manager via capacity-capped
  rendezvous (highest random weight, bounded at ceil(shards/members))
  over the live member set: deterministic, balanced to within one shard,
  and near-minimal-movement: removing a member redistributes mostly that
  member's shards.

- ``ShardCoordinator``: the distributed protocol. Each manager renews a
  membership Lease (its liveness beacon) and, for every shard whose
  rendezvous owner it is, acquires or renews that shard's Lease, the
  same optimistic-concurrency Lease protocol as ``controllers/election.py``,
  one lease per shard. A shard lease held by a dead member goes stale
  after ``lease_duration`` and the new rendezvous owner takes it over; a
  graceful rebalance releases the lease at once, so the handoff is one
  renew period. Ownership changes fire ``on_acquired``/``on_lost``: the
  Manager re-enqueues only the acquired shards' keys (``resync_shards``).

The apiserver's priority and fairness (``cluster/apf.py``) hashes flows
with ``fnv1a`` for shuffle sharding. Metrics: ``shard_ownership{shard,
manager}`` (1 while held, 0 after losing it) and
``shard_rebalance_total{manager}`` (ownership transitions this manager
observed).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid

from ..cluster.errors import (AlreadyExistsError, ApiError, ConflictError,
                              NotFoundError)
from ..cluster.http_client import TRANSPORT_ERRORS

log = logging.getLogger("kubeflow_tpu_torch.sharding")

SHARD_LEASE_PREFIX = "kubeflow-tpu-shard-"
MEMBER_LEASE_PREFIX = "kubeflow-tpu-shard-member-"
LEASE_KIND = "Lease"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: str) -> int:
    """64-bit FNV-1a over the UTF-8 bytes, finished with the murmur3
    fmix64 avalanche — stable and process-independent (Python's builtin
    ``hash`` is salted per process and would give every manager a
    different shard map). Raw FNV-1a of short near-identical keys barely
    diffuses (``a\\x001`` vs ``b\\x001`` differ in a few low bytes), which
    skews both rendezvous weights and the jump-hash input; the finalizer
    restores full-width avalanche."""
    h = _FNV_OFFSET
    for byte in data.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def jump_hash(key: int, buckets: int) -> int:
    """Lamport/Veach jump consistent hash: maps ``key`` to a bucket in
    [0, buckets) such that growing the bucket count moves only ~1/(n+1)
    of keys, every one of them into the NEW bucket."""
    if buckets <= 1:
        return 0
    b, j = -1, 0
    while j < buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * (1 << 31) / ((key >> 33) + 1))
    return b


class ShardMap:
    """Namespace → shard assignment. Pure and deterministic: every manager
    configured with the same ``shards`` computes the same map."""

    def __init__(self, shards: int) -> None:
        self.shards = max(1, int(shards))

    def shard_for(self, namespace: str) -> int:
        return jump_hash(fnv1a(namespace or ""), self.shards)


def assign_shards(num_shards: int, members: list[str]) -> dict[int, str]:
    """Deterministic BALANCED assignment of every shard to a member:
    capacity-capped rendezvous. Each shard goes to its highest-weight
    member that still has room (cap = ceil(shards/members)), so no member
    ever owns more than one shard above its fair share — plain rendezvous
    is balanced only in expectation, and at small shard counts (the
    2-manager × 4-shard smoke) routinely lands 7/1 splits. Still
    near-minimal-movement: a leaving member's shards redistribute while
    survivors keep their top-choice shards except where the larger cap
    shifts an overflow assignment."""
    if not members:
        return {}
    members = sorted(set(members))
    cap = -(-num_shards // len(members))  # ceil
    counts = dict.fromkeys(members, 0)
    out: dict[int, str] = {}
    for shard in range(num_shards):
        ranked = sorted(members, reverse=True,
                        key=lambda m: (fnv1a(f"{m}\x00{shard}"), m))
        for member in ranked:
            if counts[member] < cap:
                out[shard] = member
                counts[member] += 1
                break
    return out


class ShardCoordinator:
    """Per-shard lease ownership for one manager replica.

    ``owns_namespace`` is the hot-path filter the Manager consults on
    every enqueue/dispatch — a read of an immutable frozenset swapped
    atomically by the election thread, no lock."""

    def __init__(self, client, namespace: str, shard_map: ShardMap,
                 identity: str | None = None,
                 lease_duration: float = 15.0,
                 renew_period: float = 2.0,
                 on_acquired=None, on_lost=None) -> None:
        self.client = client
        self.namespace = namespace
        self.shard_map = shard_map
        self.identity = identity or f"mgr-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        #: fired OUTSIDE the election round's client calls with the set of
        #: shards gained/lost this round; the Manager wires on_acquired to
        #: resync_shards so a handoff re-enqueues the moved keys
        self.on_acquired = on_acquired
        self.on_lost = on_lost
        self._owned: frozenset[int] = frozenset()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ownership_metric = None
        self._rebalance_metric = None

    # ------------------------------------------------------------- metrics
    def attach_metrics(self, registry) -> None:
        self._ownership_metric = registry.gauge(
            "shard_ownership",
            "1 while this manager holds the shard's lease, 0 after losing "
            "it — by shard and manager identity.")
        self._rebalance_metric = registry.counter(
            "shard_rebalance_total",
            "Shard ownership transitions (acquired + lost) observed by "
            "this manager — a membership change re-enqueues only the "
            "moved shards' namespaces.")

    # ------------------------------------------------------------ hot path
    def owns_namespace(self, namespace: str) -> bool:
        return self.shard_map.shard_for(namespace) in self._owned

    def owned_shards(self) -> frozenset[int]:
        return self._owned

    # ------------------------------------------------------------ protocol
    def _lease(self, name: str, holder: str) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": LEASE_KIND,
            "metadata": {"name": name, "namespace": self.namespace},
            "spec": {"holderIdentity": holder,
                     "leaseDurationSeconds": self.lease_duration,
                     "renewTime": time.time()},
        }

    def _list_leases(self) -> dict[str, dict] | None:
        """One LIST of the namespace's Leases per election round — the
        shared snapshot the membership check AND every shard acquisition
        work from (per-lease GETs would put N managers × shards requests
        per renew period at the back of a contended write queue). Rides
        the rv=0 cache-served form when the transport offers it; the
        per-object resourceVersions in the snapshot keep every update
        optimistic, so a raced write surfaces as Conflict and the next
        round retries.

        Returns None when the LIST fails — the caller SKIPS the round,
        keeping current ownership: treating a transient failure as an
        empty snapshot would demote every owned shard (the leases exist
        but look absent), flap ownership, and trigger a full owned-shard
        resync one round later. The lease-staleness clock still bounds a
        genuinely dead manager; persistent LIST failure demotes via the
        loop's exception path once writes start failing too."""
        lister = getattr(self.client, "list_cached", None) or \
            self.client.list
        try:
            leases = lister(LEASE_KIND, self.namespace)
        except (ApiError, *TRANSPORT_ERRORS):
            return None
        return {(lease.get("metadata") or {}).get("name", ""): lease
                for lease in leases}

    @staticmethod
    def _lease_fresh(lease: dict | None, now: float,
                     default_duration: float) -> str | None:
        """The holder identity iff the lease was renewed within its
        duration, else None."""
        if lease is None:
            return None
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        try:
            renew = float(spec.get("renewTime", 0.0))
            duration = float(spec.get("leaseDurationSeconds",
                                      default_duration))
        except (TypeError, ValueError):
            return None
        return holder if holder and now - renew < duration else None

    def _renew_membership(self, lease: dict | None) -> None:
        name = MEMBER_LEASE_PREFIX + self.identity
        try:
            if lease is None:
                self.client.create(self._lease(name, self.identity))
                return
            lease["spec"]["holderIdentity"] = self.identity
            lease["spec"]["renewTime"] = time.time()
            lease["spec"]["leaseDurationSeconds"] = self.lease_duration
            self.client.update(lease)
        except (ConflictError, AlreadyExistsError, NotFoundError):
            pass  # racing our own retry; next round renews

    def _live_members(self, leases: dict[str, dict]) -> list[str]:
        """Identities whose membership lease was renewed within the lease
        duration. Always includes self (we just renewed)."""
        now = time.time()
        members = {self.identity}
        for name, lease in leases.items():
            if not name.startswith(MEMBER_LEASE_PREFIX):
                continue
            holder = self._lease_fresh(lease, now, self.lease_duration)
            if holder:
                members.add(holder)
        return sorted(members)

    def _try_acquire_shard(self, shard: int,
                           lease: dict | None) -> bool:
        """One election round for one shard's lease (the election.py
        protocol) against the round's shared snapshot: acquire when
        unheld or stale, renew when ours; the snapshot's rv keeps the
        write optimistic."""
        name = f"{SHARD_LEASE_PREFIX}{shard}"
        try:
            if lease is None:
                self.client.create(self._lease(name, self.identity))
                return True
            holder = self._lease_fresh(lease, time.time(),
                                       self.lease_duration)
            if holder and holder != self.identity:
                return False  # held by a live peer; bounded wait (duration)
            spec = lease.get("spec") or {}
            spec.update(holderIdentity=self.identity,
                        renewTime=time.time(),
                        leaseDurationSeconds=self.lease_duration)
            lease["spec"] = spec
            self.client.update(lease)
            return True
        except (ConflictError, AlreadyExistsError, NotFoundError):
            return False  # lost the race this round

    def _release_shard(self, shard: int) -> None:
        """Voluntary release (graceful rebalance / shutdown): zero the
        renewTime so the desired owner takes over on its next round
        instead of waiting out the lease duration. Best-effort by
        design: a release failing (conflict, apiserver gone, transport
        already closed at shutdown) must never raise — peers then adopt
        by lease staleness instead, the crash path's bound."""
        name = f"{SHARD_LEASE_PREFIX}{shard}"
        try:
            lease = self.client.get_or_none(LEASE_KIND, self.namespace, name)
            if lease and lease.get("spec", {}).get("holderIdentity") == \
                    self.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = 0.0
                self.client.update(lease)
        except Exception as exc:  # noqa: BLE001
            log.debug("shard %d lease release failed (%s); peers adopt "
                      "by staleness", shard, exc)

    def run_once(self) -> frozenset[int]:
        """One full election round: renew membership, compute the desired
        assignment over live members, acquire/renew our shards, release
        foreign ones. Returns the owned set after the round."""
        leases = self._list_leases()
        if leases is None:
            return self._owned  # transient LIST failure: skip the round
        self._renew_membership(leases.get(MEMBER_LEASE_PREFIX +
                                          self.identity))
        members = self._live_members(leases)
        assignment = assign_shards(self.shard_map.shards, members)
        desired = {shard for shard, owner in assignment.items()
                   if owner == self.identity}
        owned = set()
        for shard in range(self.shard_map.shards):
            if shard in desired:
                if self._try_acquire_shard(
                        shard, leases.get(f"{SHARD_LEASE_PREFIX}{shard}")):
                    owned.add(shard)
            elif shard in self._owned:
                # graceful handoff: the desired owner is live — hand the
                # lease over now rather than making it wait out staleness
                self._release_shard(shard)
        self._apply_ownership(frozenset(owned))
        return self._owned

    def _apply_ownership(self, owned: frozenset[int]) -> None:
        previous = self._owned
        if owned == previous:
            return
        gained = owned - previous
        lost = previous - owned
        # swap BEFORE the callbacks: resync_shards enqueues through the
        # Manager's ownership filter, which must already accept the new keys
        self._owned = owned
        if self._ownership_metric is not None:
            for shard in gained:
                self._ownership_metric.set(1, {"shard": str(shard),
                                               "manager": self.identity})
            for shard in lost:
                self._ownership_metric.set(0, {"shard": str(shard),
                                               "manager": self.identity})
        if self._rebalance_metric is not None:
            self._rebalance_metric.inc({"manager": self.identity},
                                       by=len(gained) + len(lost))
        log.info("shard ownership for %s: +%s -%s (now %s)", self.identity,
                 sorted(gained), sorted(lost), sorted(owned))
        if gained and self.on_acquired is not None:
            try:
                self.on_acquired(gained)
            except Exception:  # noqa: BLE001 — a failed resync must not
                # kill the election loop; the keys re-deliver via watches
                log.exception("on_acquired callback failed")
        if lost and self.on_lost is not None:
            try:
                self.on_lost(lost)
            except Exception:  # noqa: BLE001
                log.exception("on_lost callback failed")

    # ------------------------------------------------------------- driving
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"shard-coord-{self.identity}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — an election round
                # that dies must DEMOTE: holding shards with no renew
                # thread is split-brain once peers take the stale leases
                log.warning("shard election round failed: %s; demoting", exc)
                self._apply_ownership(frozenset())
            self._stop.wait(self.renew_period)

    def stop(self, release: bool = True) -> None:
        """Stop electing. ``release=True`` (graceful shutdown) hands every
        owned shard lease + the membership lease back immediately;
        ``release=False`` simulates a CRASH — peers take over only after
        the leases go stale (the failover-bound chaos shape). Idempotent:
        a crash-stop followed by the manager's graceful stop() must not
        retroactively release the leases the crash left dangling."""
        if self._stop.is_set() and self._thread is None:
            return  # already stopped (possibly as a simulated crash)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if release:
            for shard in self._owned:
                self._release_shard(shard)
            name = MEMBER_LEASE_PREFIX + self.identity
            try:
                lease = self.client.get_or_none(LEASE_KIND, self.namespace,
                                                name)
                if lease is not None:
                    lease["spec"]["renewTime"] = 0.0
                    self.client.update(lease)
            except Exception as exc:  # noqa: BLE001 — best-effort, like
                # _release_shard: shutdown must never crash on a dead wire
                log.debug("membership lease release failed (%s)", exc)
        self._apply_ownership(frozenset())
