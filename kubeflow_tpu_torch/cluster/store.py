"""In-process Kubernetes API server.

The port's copy of ``ClusterStore`` in ``kubeflow_tpu/cluster/store.py``
(the port imports nothing of the JAX package): the API semantics the
controllers rely on, which the parity harness
(tests/test_torch_store.py, tests/test_torch_store_sharding.py) holds
against the reference's store:

- optimistic concurrency via metadata.resourceVersion (ConflictError on
  stale updates, what retry.RetryOnConflict loops on in the reference);
- GenerateName materialization, with the reference's seeded suffix
  (``names.generate_suffix`` over a counter shared with the uids), so the
  same writes name the same objects in both stores;
- generation bumped on a spec change only;
- RFC 7386 merge patches (``null`` removes) re-merged on a concurrent
  write;
- the status subresource (``update_status`` applies ``.status`` only);
- finalizers + deletionTimestamp two-phase delete, and ownerReference
  cascade GC honouring dependents' finalizers;
- watch fan-out with ADDED/MODIFIED/DELETED events feeding controller
  workqueues, delivered in write order outside the store's locks (a
  callback may re-enter the store);
- admission plugins run before a create or update is persisted, then
  remote admission, then the CRD schema: creating a
  Mutating/ValidatingWebhookConfiguration indexes it, and every later
  create, update or delete of a kind its rules match POSTs an
  AdmissionReview to its ``url`` (``cluster/remote_admission.py``;
  mutating before validating, outside every lock); creating a
  CustomResourceDefinition registers its served versions' structural
  schemas, and every later write of that kind is validated against them
  (the apiserver's order: mutating admission, validating admission,
  schema, persistence);
- the wire half the HTTP apiserver (``cluster/apiserver.py``) serves
  from: one shared ``EventFrame`` per event (its JSON and binary
  encodings each computed at most once), a bounded per-kind resume ring
  (``watch_frames`` replays after a resourceVersion, or raises
  ``GoneError`` past the window), paginated LISTs with continue tokens
  (``list_page``), and the snapshot handshake of a server-side watch
  cache (``snapshot_with_frames``).

Sharded as etcd splits its state: objects live in per-(kind, namespace)
shards chosen by FNV-1a (``_shard_index``), each under its own lock,
while one small lock (the rv allocator) issues resourceVersions, appends
to the resume rings and feeds the frame relays. A writer takes its
shard's lock, then the rv lock: watch order is rv order because an rv is
issued and its frame appended in one hold. Cascade GC and the cache
snapshot take every shard lock in index order first, the rv lock last.
A stored object is never mutated after it is published: every write
replaces its slot with a fresh dict, so frames, serve caches and LIST
walks share it without a copy.
"""

from __future__ import annotations

import base64
import bisect
import contextlib
import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator

from ..utils import k8s
from ..utils.names import generate_suffix
from . import codec, remote_admission
from .errors import (AlreadyExistsError, ConflictError, GoneError,
                     InvalidError, NotFoundError)

CLUSTER_SCOPED_KINDS = {
    "Namespace", "ClusterRole", "ClusterRoleBinding", "OAuthClient",
    "CustomResourceDefinition", "PriorityClass", "Node", "APIServer",
    "MutatingWebhookConfiguration", "ValidatingWebhookConfiguration",
}

#: default shard count: kinds x namespaces spread well past 8, and taking
#: every shard lock for a cascade stays cheap
DEFAULT_SHARDS = 8

#: per-kind resume ring capacity: how many recent events a dropped
#: watcher can resume across without a full re-LIST
WATCH_CACHE_CAPACITY = 4096


@dataclass(frozen=True)
class ObjectKey:
    kind: str
    namespace: str
    name: str


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    obj: dict


class EventFrame:
    """One watch event, shared by every consumer: ``obj`` is the stored
    object itself (immutable once published), and each wire encoding is
    computed at most once however many watchers fan it out. ``rv`` is
    the event's resourceVersion as an int, the resume cursor."""

    __slots__ = ("rv", "type", "obj", "_obj_bytes", "_obj_bytes_binary")

    def __init__(self, rv: int, type_: str, obj: dict) -> None:
        self.rv = rv
        self.type = type_
        self.obj = obj
        self._obj_bytes: bytes | None = None
        self._obj_bytes_binary: bytes | None = None

    def obj_bytes(self) -> bytes:
        """The object's compact JSON, encoded once and cached (two
        threads racing may both encode; either result is the same)."""
        encoded = self._obj_bytes
        if encoded is None:
            encoded = json.dumps(self.obj, separators=(",", ":")).encode()
            self._obj_bytes = encoded
        return encoded

    def obj_bytes_binary(self) -> bytes:
        """The object's binary-codec encoding, cached like obj_bytes()."""
        encoded = self._obj_bytes_binary
        if encoded is None:
            encoded = codec.encode(self.obj)
            self._obj_bytes_binary = encoded
        return encoded


class _WatchRing:
    """Bounded per-kind ring of recent EventFrames in rv order.
    ``evicted_rv`` is the rv of the newest frame pushed out: a resume
    from N is servable iff N >= evicted_rv."""

    __slots__ = ("frames", "evicted_rv", "capacity")

    def __init__(self, capacity: int) -> None:
        self.frames: deque[EventFrame] = deque()
        self.evicted_rv = 0
        self.capacity = capacity

    def append(self, frame: EventFrame) -> int:
        """Add a frame; returns how many old frames were evicted."""
        self.frames.append(frame)
        evicted = 0
        while len(self.frames) > self.capacity:
            self.evicted_rv = self.frames.popleft().rv
            evicted += 1
        return evicted

    def since(self, rv: int) -> list[EventFrame]:
        """Frames with rv > ``rv`` (the caller checked servability)."""
        return [f for f in self.frames if f.rv > rv]


@dataclass
class _Watch:
    kind: str
    callback: Callable
    namespace: str | None = None
    label_selector: dict[str, str] | None = None
    #: frame relays (the HTTP apiserver, its serve caches) receive the
    #: shared EventFrame under the rv lock; plain watches receive a
    #: WatchEvent outside every lock
    frames: bool = False


class _Shard:
    """One slice of the object state under its own lock."""

    __slots__ = ("lock", "objects")

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.objects: dict[ObjectKey, dict] = {}


def _encode_continue(namespace: str, name: str) -> str:
    """Opaque continue token naming the last key a page served (base64
    JSON of the cursor, as the real apiserver's token is)."""
    raw = json.dumps([namespace, name]).encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def _decode_continue(token: str) -> tuple[str, str]:
    pad = "=" * (-len(token) % 4)
    try:
        ns, nm = json.loads(base64.urlsafe_b64decode(token + pad))
        return (str(ns), str(nm))
    except (ValueError, TypeError):
        raise InvalidError(f"malformed continue token {token!r}") from None


def _shard_index(kind: str, namespace: str, nshards: int) -> int:
    """FNV-1a (32-bit) over ``kind/namespace``: the same shard in every
    process, so a namespaced LIST takes exactly one shard lock."""
    h = 0x811C9DC5
    for byte in f"{kind}/{namespace}".encode():
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h % nshards


class ClusterStore:
    """The in-process apiserver + etcd. All mutating verbs return a deep copy
    of the stored object (as the real apiserver returns the canonical form)."""

    # bounds the patch re-merge loop: a hot object backs off and eventually
    # surfaces the conflict rather than livelock
    PATCH_MAX_RETRIES = 20

    def __init__(self, shards: int = DEFAULT_SHARDS) -> None:
        self._nshards = max(int(shards), 1)
        self._shards = [_Shard() for _ in range(self._nshards)]
        # the rv allocator: issue, ring append and relay feed, always
        # taken after any shard lock
        self._rv_lock = threading.RLock()
        # the CRD schema and webhook-configuration indexes: written under
        # a shard lock, read alone
        self._config_lock = threading.RLock()
        self._rv_counter = itertools.count(1)
        self._last_rv = 0  # latest issued resourceVersion
        # one sorted-key snapshot for paginated LISTs, keyed on
        # (kind, namespace, _last_rv) so any write invalidates it
        self._page_snapshot: tuple | None = None
        self._uid_counter = itertools.count(1)
        self._watches: list[_Watch] = []
        self._watch_rings: dict[str, _WatchRing] = {}
        self.watch_cache_capacity = WATCH_CACHE_CAPACITY
        self._evictions_metric = None  # watch_cache_evictions_total
        self._list_lock_metric = None  # store_list_lock_seconds
        self._write_lock_metric = None  # store_write_lock_seconds
        # admission hooks: (kind, fn(operation, obj, old) -> obj | raise)
        self._admission: list[tuple[str, Callable]] = []
        # CRD structural schemas: kind → {version: openAPIV3Schema}, kept
        # in step with the CustomResourceDefinition objects
        self._crd_schemas: dict[str, dict[str, dict]] = {}
        # Mutating/ValidatingWebhookConfiguration objects, kind → {key:
        # config}: writes of matching kinds call out over AdmissionReview
        self._webhook_configs: dict[str, dict[ObjectKey, dict]] = {}

    def _next_rv(self) -> str:
        """Issue the next resourceVersion (caller holds the rv lock)."""
        self._last_rv = next(self._rv_counter)
        return str(self._last_rv)

    # ------------------------------------------------------------------ keys
    def _key(self, kind: str, namespace: str, name: str) -> ObjectKey:
        if kind in CLUSTER_SCOPED_KINDS:
            namespace = ""
        return ObjectKey(kind, namespace, name)

    def _key_of(self, obj: dict) -> ObjectKey:
        return self._key(k8s.kind(obj), k8s.namespace(obj), k8s.name(obj))

    def _shard_of(self, key: ObjectKey) -> _Shard:
        return self._shards[_shard_index(key.kind, key.namespace,
                                         self._nshards)]

    def _shards_for(self, kind: str, namespace: str | None) -> list[_Shard]:
        """The shards a LIST visits: one for a namespaced LIST, all of
        them across namespaces."""
        if namespace is None:
            return self._shards
        return [self._shard_of(self._key(kind, namespace, ""))]

    @contextlib.contextmanager
    def _all_shards_locked(self):
        """Every shard lock in ascending index order (cascade GC, the
        cache snapshot); the rv lock is taken after, never before."""
        with contextlib.ExitStack() as stack:
            for shard in self._shards:
                stack.enter_context(shard.lock)
            yield

    def _observe_write(self, kind: str, started: float) -> None:
        if self._write_lock_metric is not None:
            self._write_lock_metric.observe(time.monotonic() - started,
                                            {"kind": kind})

    # ------------------------------------------------------------- admission
    def register_admission(self, kind: str, fn: Callable) -> None:
        """Register an admission plugin invoked before create/update/patch
        is persisted: the seam the mutating/validating webhooks plug into."""
        self._admission.append((kind, fn))

    def _admit(self, operation: str, obj: dict, old: dict | None) -> dict:
        for kind, fn in self._admission:
            if kind == k8s.kind(obj):
                obj = fn(operation, obj, old)
        obj = self._run_remote_admission(operation, obj, old)
        # the schema holds what will be persisted, after the webhooks
        self._validate_against_crd(obj)
        return obj

    def _run_remote_admission(self, operation: str, obj: dict,
                              old: dict | None) -> dict:
        """AdmissionReview against the indexed webhook configurations
        (mutating, then validating: the apiserver's order). The index is
        copied under its lock; the HTTP calls run outside every lock."""
        ra = remote_admission
        if k8s.kind(obj) in ra.CONFIG_KINDS:
            return obj  # configurations themselves are not gated
        with self._config_lock:
            mutating = [k8s.deepcopy(c) for c in
                        self._webhook_configs.get(ra.MUTATING_KIND,
                                                  {}).values()]
            validating = [k8s.deepcopy(c) for c in
                          self._webhook_configs.get(ra.VALIDATING_KIND,
                                                    {}).values()]
        if mutating:
            obj = ra.run_webhooks(mutating, operation, obj, old,
                                  mutating=True)
        if validating:
            ra.run_webhooks(validating, operation, obj, old, mutating=False)
        return obj

    def _index_webhook_config(self, key: ObjectKey, obj: dict) -> None:
        with self._config_lock:
            self._webhook_configs.setdefault(key.kind, {})[key] = \
                k8s.deepcopy(obj)

    def _unindex_webhook_config(self, key: ObjectKey) -> None:
        with self._config_lock:
            self._webhook_configs.get(key.kind, {}).pop(key, None)

    # ----------------------------------------------------------- CRD schemas
    def _index_crd(self, crd: dict) -> None:
        kind = k8s.get_in(crd, "spec", "names", "kind")
        if not kind:
            return
        versions = {}
        for v in k8s.get_in(crd, "spec", "versions", default=[]) or []:
            s = k8s.get_in(v, "schema", "openAPIV3Schema")
            if v.get("served") and s:
                versions[v["name"]] = s
        if versions:
            with self._config_lock:
                self._crd_schemas[kind] = versions

    def _unindex_crd(self, crd: dict) -> None:
        with self._config_lock:
            self._crd_schemas.pop(k8s.get_in(crd, "spec", "names", "kind"),
                                  None)

    def _validate_against_crd(self, obj: dict) -> None:
        with self._config_lock:
            versions = self._crd_schemas.get(k8s.kind(obj))
        if not versions:
            return
        version = (obj.get("apiVersion") or "").rpartition("/")[2]
        schema = versions.get(version)
        if schema is None:
            return  # an unserved version: the typed admission denies it
        from ..api.schema import validate_schema
        errors = validate_schema(obj, schema)
        if errors:
            shown = "; ".join(errors[:5])
            if len(errors) > 5:
                shown += f" (+{len(errors) - 5} more)"
            raise InvalidError(
                f"{k8s.kind(obj)} {k8s.namespace(obj)}/{k8s.name(obj)} "
                f"is invalid: {shown}")

    # ----------------------------------------------------------------- watch
    def _emit_locked(self, etype: str, obj: dict) -> tuple:
        """Build the shared frame of one event, append it to the kind's
        ring, hand it to the frame relays (pure queue work that never
        re-enters the store, so in rv order) and snapshot the plain
        watchers. Caller holds the rv lock and stamped ``obj``'s rv in
        the same hold; returns ``(frame, targets)`` for _dispatch_all."""
        kind = k8s.kind(obj)
        ns = k8s.namespace(obj)
        try:
            rv = int(k8s.get_in(obj, "metadata", "resourceVersion") or 0)
        except (TypeError, ValueError):
            rv = 0
        frame = EventFrame(rv, etype, obj)
        ring = self._watch_rings.get(kind)
        if ring is None:
            ring = self._watch_rings[kind] = \
                _WatchRing(self.watch_cache_capacity)
        evicted = ring.append(frame)
        if evicted and self._evictions_metric is not None:
            self._evictions_metric.inc({"kind": kind}, by=evicted)
        targets = []
        for w in self._watches:
            if w.kind != kind \
                    or (w.namespace is not None and w.namespace != ns) \
                    or not k8s.matches_labels(obj, w.label_selector):
                continue
            if w.frames:
                w.callback(frame)
            else:
                targets.append(w)
        return frame, targets

    @staticmethod
    def _dispatch_all(emitted: list) -> None:
        """Deliver emitted events to the plain watchers outside the
        locks, in write order. The object is the stored one, shared by
        every consumer: callbacks treat it as immutable."""
        for frame, targets in emitted:
            for w in targets:
                w.callback(WatchEvent(frame.type, frame.obj))

    def attach_metrics(self, registry) -> None:
        """Register the ring's eviction counter and the LIST and write
        lock-hold histograms, eagerly, so an idle store exposes them."""
        self._evictions_metric = registry.counter(
            "watch_cache_evictions_total",
            "Watch-cache ring frames evicted, by kind — each eviction "
            "narrows the window a reconnecting watcher can resume across "
            "without a full re-LIST.")
        self._list_lock_metric = registry.histogram(
            "store_list_lock_seconds",
            "Wall time a LIST spent acquiring plus holding the store's "
            "shard locks, by kind. "
            "Cache-served (rv=0) LISTs never appear here — this series "
            "growing with manager count means resyncs are stampeding the "
            "write path again.")
        self._write_lock_metric = registry.histogram(
            "store_write_lock_seconds",
            "Wall time a write verb spent acquiring plus holding its "
            "shard's write lock (and the rv allocator nested under it), "
            "by kind — the sibling of store_list_lock_seconds that the "
            "shard split is measured by: per-frontend write rates stay "
            "flat when shards spread contention.")

    # ----------------------------------------------------------------- verbs
    def create(self, obj: dict) -> dict:
        obj = k8s.deepcopy(obj)
        # admission runs outside the locks; a race it let through is
        # caught at persist (AlreadyExists)
        obj = self._admit("CREATE", obj, None)
        md = k8s.meta(obj)
        if not md.get("name") and md.get("generateName"):
            md["name"] = md["generateName"] + generate_suffix(
                f'{md["generateName"]}{next(self._uid_counter)}', 5)
        if not md.get("name"):
            raise InvalidError("metadata.name or generateName required")
        key = self._key_of(obj)
        shard = self._shard_of(key)
        md.setdefault("creationTimestamp", k8s.now_iso())
        started = time.monotonic()
        with shard.lock:
            if key in shard.objects:
                raise AlreadyExistsError(
                    f"{key.kind} {key.namespace}/{key.name}")
            md["uid"] = f"uid-{next(self._uid_counter)}"
            md["generation"] = 1
            with self._rv_lock:
                md["resourceVersion"] = self._next_rv()
                shard.objects[key] = obj
                emitted = [self._emit_locked("ADDED", obj)]
            if key.kind == "CustomResourceDefinition":
                self._index_crd(obj)
            elif key.kind in remote_admission.CONFIG_KINDS:
                self._index_webhook_config(key, obj)
        self._observe_write(key.kind, started)
        self._dispatch_all(emitted)
        return k8s.deepcopy(obj)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        key = self._key(kind, namespace, name)
        shard = self._shard_of(key)
        with shard.lock:
            obj = shard.objects.get(key)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name}")
        # the stored object is immutable: copy outside the lock
        return k8s.deepcopy(obj)

    def get_or_none(self, kind: str, namespace: str,
                    name: str) -> dict | None:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[dict]:
        """Objects of ``kind`` (in ``namespace``, or in all namespaces when
        None) matching the label selector, in (namespace, name) order."""
        items, _, _ = self.list_page(kind, namespace, label_selector)
        return items

    def list_page(self, kind: str, namespace: str | None = None,
                  label_selector: dict[str, str] | None = None,
                  limit: int | None = None,
                  continue_token: str | None = None,
                  resource_version: str | None = None,
                  ) -> tuple[list[dict], str | None, str]:
        """LIST with the apiserver's chunking (``limit``/``continue``).
        Returns ``(items, next_continue, list_rv)``; ``next_continue`` is
        None on the last page.

        Keys come in ``(namespace, name)`` order and the token names the
        last key a page served, so on a quiet store the pages compose
        into the unpaginated LIST for every page size; an object written
        between pages may be missed or seen once, as on the real chunked
        LIST. ``resource_version`` (``"0"`` or any other form) is served
        from current state: this store is the state of record. ``list_rv``
        is the latest issued rv, read before the shard walk, so a write
        racing the walk has a larger rv and a watch from ``list_rv``
        replays it."""
        start_after = (_decode_continue(continue_token)
                       if continue_token else None)
        if limit is not None and limit <= 0:
            limit = None  # limit=0 means no limit, as on the wire
        lock_started = time.monotonic()
        with self._rv_lock:
            list_rv_int = self._last_rv
            snap = self._page_snapshot
        # refs under brief per-shard locks; sort, walk and copies outside
        refs: dict[tuple[str, str], dict] = {}
        for shard in self._shards_for(kind, namespace):
            with shard.lock:
                for okey, oobj in shard.objects.items():
                    if okey.kind == kind and (namespace is None
                                              or okey.namespace == namespace):
                        refs[(okey.namespace, okey.name)] = oobj
        lock_elapsed = time.monotonic() - lock_started
        token = (kind, namespace, list_rv_int)
        if limit is not None and snap is not None and snap[:3] == token:
            pairs = snap[3]
        else:
            pairs = sorted(refs)
            if limit is not None:
                with self._rv_lock:
                    self._page_snapshot = (*token, pairs)
        start = (bisect.bisect_right(pairs, start_after)
                 if start_after is not None else 0)
        out: list[dict] = []
        last_pair: tuple[str, str] | None = None
        next_token: str | None = None
        for pair in pairs[start:]:
            obj = refs.get(pair)  # deleted since the snapshot: skip
            if obj is None or not k8s.matches_labels(obj, label_selector):
                continue
            if limit is not None and len(out) >= limit:
                # a full page with a candidate left: cursor at the last
                # key served
                next_token = _encode_continue(*last_pair)
                break
            out.append(k8s.deepcopy(obj))
            last_pair = pair
        if self._list_lock_metric is not None:
            self._list_lock_metric.observe(lock_elapsed, {"kind": kind})
        return out, next_token, str(list_rv_int)

    def list_cached(self, kind: str, namespace: str | None = None,
                    label_selector: dict[str, str] | None = None,
                    min_resource_version: int | None = None) -> list[dict]:
        """The rv=0 read-from-cache LIST of an HTTP client: this store is
        the state of record, so it serves current state (which meets any
        ``min_resource_version``)."""
        return self.list(kind, namespace, label_selector)

    def update(self, obj: dict) -> dict:
        obj = k8s.deepcopy(obj)
        key = self._key_of(obj)
        shard = self._shard_of(key)
        with shard.lock:
            old_snapshot = shard.objects.get(key)
        if old_snapshot is None:
            raise NotFoundError(f"{key.kind} {key.namespace}/{key.name}")
        snapshot_rv = old_snapshot["metadata"]["resourceVersion"]
        new_rv = k8s.get_in(obj, "metadata", "resourceVersion")
        if new_rv is not None and new_rv != snapshot_rv:
            raise ConflictError(
                f"{key.kind} {key.namespace}/{key.name}: stale resourceVersion")
        # admission runs outside the locks; the locked pass re-checks that
        # the state it admitted against is still the state being replaced
        obj = self._admit("UPDATE", obj, k8s.deepcopy(old_snapshot))
        # stripping the last finalizer of a deleting object removes it
        # and cascades, which takes every shard lock; a single-shard pass
        # that finds the cascade anyway retries once with all of them
        take_all = bool(
            (k8s.get_in(obj, "metadata", "deletionTimestamp")
             or k8s.get_in(old_snapshot, "metadata", "deletionTimestamp"))
            and not k8s.get_in(obj, "metadata", "finalizers"))
        started = time.monotonic()
        emitted: list | None = None
        for all_shards in ([True] if take_all else [False, True]):
            emitted = self._apply_update_locked(key, shard, obj, new_rv,
                                                snapshot_rv, all_shards)
            if emitted is not None:
                break
        self._observe_write(key.kind, started)
        self._dispatch_all(emitted)
        return k8s.deepcopy(obj)

    def _apply_update_locked(self, key: ObjectKey, shard: _Shard, obj: dict,
                             new_rv, snapshot_rv,
                             take_all: bool) -> list | None:
        """One locked attempt at an update; returns the emissions, or None
        when the cascade was reached without every shard lock held."""
        with contextlib.ExitStack() as stack:
            if take_all:
                stack.enter_context(self._all_shards_locked())
            else:
                stack.enter_context(shard.lock)
            old = shard.objects.get(key)
            if old is None:
                raise NotFoundError(f"{key.kind} {key.namespace}/{key.name}")
            # only optimistic writers re-check: a no-RV update keeps the
            # apiserver's unconditional last-write-wins semantics
            if new_rv is not None and \
                    old["metadata"]["resourceVersion"] != snapshot_rv:
                raise ConflictError(
                    f"{key.kind} {key.namespace}/{key.name}: object changed "
                    f"during admission")
            md = k8s.meta(obj)
            md["uid"] = old["metadata"]["uid"]
            md["creationTimestamp"] = old["metadata"]["creationTimestamp"]
            if k8s.get_in(old, "metadata", "deletionTimestamp"):
                md["deletionTimestamp"] = old["metadata"]["deletionTimestamp"]
            if obj.get("spec") != old.get("spec"):
                md["generation"] = old["metadata"].get("generation", 1) + 1
            else:
                md["generation"] = old["metadata"].get("generation", 1)
            if (k8s.get_in(obj, "metadata", "deletionTimestamp")
                    and not k8s.get_in(obj, "metadata", "finalizers")):
                # last finalizer stripped → actually remove (two-phase
                # delete), cascading to dependents on any shard
                if not take_all:
                    return None
                with self._rv_lock:
                    md["resourceVersion"] = self._next_rv()
                return self._remove_and_gc(key, replacement=obj)
            with self._rv_lock:
                md["resourceVersion"] = self._next_rv()
                shard.objects[key] = obj
                emitted = [self._emit_locked("MODIFIED", obj)]
            if key.kind == "CustomResourceDefinition":
                self._index_crd(obj)
            elif key.kind in remote_admission.CONFIG_KINDS:
                self._index_webhook_config(key, obj)
            return emitted

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        """RFC 7386 JSON merge patch (client.MergeFrom semantics). Unlike
        update(), it re-merges against the current version on a concurrent
        write, with bounded backoff."""
        key = self._key(kind, namespace, name)
        shard = self._shard_of(key)
        for attempt in range(self.PATCH_MAX_RETRIES):
            with shard.lock:
                old = shard.objects.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {namespace}/{name}")
            merged = k8s.json_merge_patch(old, patch)
            # fresh metadata dict: json_merge_patch shares untouched
            # subtrees with the (immutable) stored object
            merged["metadata"] = {**(merged.get("metadata") or {}),
                                  "resourceVersion":
                                      old["metadata"]["resourceVersion"]}
            try:
                return self.update(merged)
            except ConflictError:
                time.sleep(min(0.001 * (2 ** attempt), 0.1))
        raise ConflictError(f"{kind} {namespace}/{name}: patch kept "
                            f"conflicting after {self.PATCH_MAX_RETRIES} "
                            f"attempts")

    def update_status(self, obj: dict) -> dict:
        """Status subresource semantics: only .status is applied. The
        replacement shares the old object's spec/metadata subtrees."""
        key = self._key_of(obj)
        shard = self._shard_of(key)
        new_status = k8s.deepcopy(obj.get("status", {}))
        new_rv = k8s.get_in(obj, "metadata", "resourceVersion")
        started = time.monotonic()
        with shard.lock:
            old = shard.objects.get(key)
            if old is None:
                raise NotFoundError(f"{key.kind} {key.namespace}/{key.name}")
            if new_rv is not None and \
                    new_rv != old["metadata"]["resourceVersion"]:
                raise ConflictError(f"{key.kind} {key.namespace}/{key.name}")
            with self._rv_lock:
                stored = {**old, "status": new_status,
                          "metadata": {**old["metadata"],
                                       "resourceVersion": self._next_rv()}}
                shard.objects[key] = stored
                emitted = [self._emit_locked("MODIFIED", stored)]
        self._observe_write(key.kind, started)
        self._dispatch_all(emitted)
        return k8s.deepcopy(stored)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Two-phase delete: finalizers present → set deletionTimestamp and
        wait for controllers to strip them; else remove + cascade to owned
        objects (background GC)."""
        key = self._key(kind, namespace, name)
        shard = self._shard_of(key)
        with shard.lock:
            snapshot = shard.objects.get(key)
        if snapshot is None:
            raise NotFoundError(f"{kind} {namespace}/{name}")
        snap = k8s.deepcopy(snapshot)
        # DELETE-gating webhooks (operations: ["DELETE"]) fire as the
        # apiserver's do, outside the locks
        self._run_remote_admission("DELETE", snap, snap)
        # removal cascades across shards (every shard lock); the finalizer
        # mark stays on the object's own shard, retried with every lock if
        # the object lost its finalizers meanwhile
        take_all = not k8s.get_in(snapshot, "metadata", "finalizers")
        started = time.monotonic()
        emitted: list | None = None
        for all_shards in ([True] if take_all else [False, True]):
            emitted = self._apply_delete_locked(key, shard, all_shards)
            if emitted is not None:
                break
        self._observe_write(key.kind, started)
        self._dispatch_all(emitted)

    def _apply_delete_locked(self, key: ObjectKey, shard: _Shard,
                             take_all: bool) -> list | None:
        """One locked attempt at a delete; returns the emissions, or None
        when removal was reached without every shard lock held."""
        with contextlib.ExitStack() as stack:
            if take_all:
                stack.enter_context(self._all_shards_locked())
            else:
                stack.enter_context(shard.lock)
            obj = shard.objects.get(key)
            if obj is None:
                raise NotFoundError(f"{key.kind} {key.namespace}/{key.name}")
            if k8s.get_in(obj, "metadata", "finalizers"):
                if k8s.get_in(obj, "metadata", "deletionTimestamp"):
                    return []
                return [self._mark_deleting_locked(key, shard, obj)]
            if not take_all:
                return None
            return self._remove_and_gc(key)

    # ------------------------------------------------------- delete plumbing
    def _mark_deleting_locked(self, key: ObjectKey, shard: _Shard,
                              obj: dict) -> tuple:
        """Copy-on-write delete mark (the stored object is immutable);
        caller holds the object's shard lock."""
        ts = k8s.now_iso()
        with self._rv_lock:
            marked = {**obj, "metadata": {**obj["metadata"],
                                          "deletionTimestamp": ts,
                                          "resourceVersion":
                                              self._next_rv()}}
            shard.objects[key] = marked
            return self._emit_locked("MODIFIED", marked)

    def _remove_and_gc(self, key: ObjectKey,
                       replacement: dict | None = None) -> list:
        """Remove an object and cascade-delete its dependents through
        ownerReferences, honouring the dependents' own finalizers (caller
        holds every shard lock). The DELETED event carries a fresh
        resourceVersion, as the real apiserver's does: one reusing the
        object's last rv would sort before newer events and be skipped by
        a resume past it."""
        shard = self._shard_of(key)
        obj = replacement if replacement is not None \
            else shard.objects.get(key)
        shard.objects.pop(key, None)
        emitted: list = []
        if obj is None:
            return emitted
        if key.kind == "CustomResourceDefinition":
            self._unindex_crd(obj)
        elif key.kind in remote_admission.CONFIG_KINDS:
            self._unindex_webhook_config(key)
        with self._rv_lock:
            final = {**obj, "metadata": {**obj["metadata"],
                                         "resourceVersion": self._next_rv()}}
            emitted.append(self._emit_locked("DELETED", final))
        owner_uid = k8s.uid(obj)
        if not owner_uid:
            return emitted
        dependents = [dk for s in self._shards
                      for dk, dobj in s.objects.items()
                      if k8s.is_owned_by(dobj, owner_uid)]
        for dk in dependents:
            dshard = self._shard_of(dk)
            dobj = dshard.objects.get(dk)
            if dobj is None:
                continue
            if k8s.get_in(dobj, "metadata", "finalizers"):
                if not k8s.get_in(dobj, "metadata", "deletionTimestamp"):
                    emitted.append(self._mark_deleting_locked(dk, dshard,
                                                              dobj))
            else:
                emitted.extend(self._remove_and_gc(dk))
        return emitted

    # ---------------------------------------------------- watch registration
    def watch(self, kind: str, callback: Callable[[WatchEvent], None],
              namespace: str | None = None,
              label_selector: dict[str, str] | None = None) -> None:
        with self._rv_lock:
            self._watches.append(_Watch(kind, callback, namespace,
                                        label_selector))

    def watch_frames(self, kind: str, relay: Callable,
                     namespace: str | None = None,
                     label_selector: dict[str, str] | None = None,
                     since_rv: int | None = None) -> tuple[list, int]:
        """Register a frame relay and, when ``since_rv`` is given, hand
        back in the same hold every retained event after it: the
        resourceVersion resume that spares a reconnecting client its
        LIST. Returns ``(replay, anchor_rv)``, the anchor being the rv the
        stream is complete through at registration. Raises GoneError when
        ``since_rv`` predates the retained window or names an rv this
        store never issued (a resume against another store must relist)."""
        with self._rv_lock:
            replay: list[EventFrame] = []
            if since_rv is not None:
                ring = self._watch_rings.get(kind)
                evicted_rv = ring.evicted_rv if ring is not None else 0
                if since_rv < evicted_rv or since_rv > self._last_rv:
                    raise GoneError(
                        f"too old resource version: {since_rv} (the watch "
                        f"cache window for {kind} starts at {evicted_rv})")
                if ring is not None:
                    replay = [f for f in ring.since(since_rv)
                              if (namespace is None
                                  or k8s.namespace(f.obj) == namespace)
                              and k8s.matches_labels(f.obj, label_selector)]
            self._watches.append(_Watch(kind, relay, namespace,
                                        label_selector, frames=True))
            return replay, self._last_rv

    def snapshot_with_frames(self, kind: str, relay: Callable,
                             ) -> tuple[list[dict], int]:
        """Register a frame relay for ``kind`` and return a copy of its
        current objects and the anchor rv, atomically (every shard lock
        and the rv lock exclude all writers): a serve cache built from it
        is consistent from birth."""
        with self._all_shards_locked():
            with self._rv_lock:
                refs = [obj for s in self._shards
                        for okey, obj in s.objects.items()
                        if okey.kind == kind]
                self._watches.append(_Watch(kind, relay, None, None,
                                            frames=True))
                anchor = self._last_rv
        return [k8s.deepcopy(o) for o in refs], anchor

    def unwatch(self, callback: Callable) -> None:
        """Deregister a watch callback or frame relay (equality, so a
        bound method handed in again matches)."""
        with self._rv_lock:
            self._watches[:] = [w for w in self._watches
                                if w.callback != callback]

    # ----------------------------------------------------------- conveniences
    def all_objects(self) -> Iterator[dict]:
        refs: list[dict] = []
        for shard in self._shards:
            with shard.lock:
                refs.extend(shard.objects.values())
        return iter([k8s.deepcopy(o) for o in refs])
