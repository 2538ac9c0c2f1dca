"""Read-cache client layer: data-stripping transforms + indexed stores.

The port's copy of ``kubeflow_tpu/cluster/cache.py``. The reference's
manager cache (odh main.go:95-125, :248-268) strips ``data`` /
``binaryData`` / ``stringData`` from every cached Secret and ConfigMap
and sends payload reads of those kinds to the apiserver.
``CachingClient`` wraps a store with that split:

- a watch-fed local cache for every kind, transforms applied on ingest
  (payloads, managedFields and the kubectl last-applied annotation
  dropped);
- ``get``/``list`` served from the cache except for the ``disable_for``
  kinds, which read the live store (fresh, untransformed);
- writes pass through, and their responses feed the cache
  (read-your-writes for the author).

Reads are served from per-kind stores carrying client-go-style indexes,
maintained on ingest and delete, so ``list``, ``get_owned`` and
``list_by_field`` are O(result):

- ``by-namespace``: every namespaced list;
- ``by-label``: one index per hot label key (``DEFAULT_LABEL_INDEXES``),
  equality and existence form;
- ``by-owner``: ownerReferences UID (``get_owned``);
- ``by-field``: ``spec.nodeName`` (``pods_on_node``).

A resourceVersion guard keeps an older copy from replacing a newer one,
tombstones keep a snapshot racing a DELETED event out of the cache, and
``mark_watch_gap``/``mark_watch_recovered`` send a kind's reads live
while a stream feeding it is down. ``cache_index_lookups_total`` and
``cache_full_scans_total`` (``attach_metrics``) show the hot path stays
scan-free. The lock guards only the index lookups; label predicates and
deep copies run outside it. A plain ``threading.Lock`` stands in for the
reference's tracked lock. Paginated LISTs with continue tokens stay with
the store's wire parts (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from ..utils import k8s, names
from .errors import NotFoundError
from .store import WatchEvent

DEFAULT_DISABLE_FOR = ("Secret", "ConfigMap")

#: label keys indexed by default — the selectors the controllers actually
#: use on hot paths: the notebook-name fleet label (``_find_owned_sts``,
#: culling's pod scrape, the notebook_running metrics scrape), the STS pod
#: selector, the runtime-image inventory, and the k8s part-of grouping
DEFAULT_LABEL_INDEXES = (
    names.NOTEBOOK_NAME_LABEL,
    "statefulset",
    names.POOL_LABEL,
    names.RUNTIME_IMAGE_LABEL,
    names.PART_OF_LABEL,
)

#: object-field paths indexed by default (controller-runtime's
#: FieldIndexer analog): ``spec.nodeName`` serves the node-event fan-in
#: (slice repair + kubelet sim map a Node to the pods bound to it) in
#: O(pods on that node) instead of O(fleet pods) per node event
DEFAULT_FIELD_INDEXES = ("spec.nodeName",)

LAST_APPLIED_ANNOTATION = names.LAST_APPLIED_ANNOTATION


def _strip_metadata_bulk(obj: dict) -> dict:
    """Drop managedFields and the kubectl last-applied-configuration
    annotation (which duplicates the whole payload) while preserving every
    other label/annotation — the reference's cache transforms do the same
    (main_test.go:33-45,70-86); tolerates absent/None metadata maps."""
    meta = obj.get("metadata")
    if not isinstance(meta, dict):
        return obj
    meta = dict(meta)
    meta.pop("managedFields", None)
    anns = meta.get("annotations")
    if isinstance(anns, dict) and LAST_APPLIED_ANNOTATION in anns:
        anns = dict(anns)
        anns.pop(LAST_APPLIED_ANNOTATION)
        meta["annotations"] = anns
    obj = dict(obj)
    obj["metadata"] = meta
    return obj


def strip_secret_data(obj: dict) -> dict:
    """Transform analog of stripSecretData (main.go:95-109): drops data/
    stringData/managedFields/last-applied, preserves type, labels, and
    other annotations; non-Secret objects pass through unchanged."""
    if obj.get("kind") == "Secret":
        obj = dict(obj)
        obj.pop("data", None)
        obj.pop("stringData", None)
        obj = _strip_metadata_bulk(obj)
    return obj


def strip_configmap_data(obj: dict) -> dict:
    """Transform analog of stripConfigMapData (main.go:111-125): drops
    data/binaryData/managedFields/last-applied, preserves labels and other
    annotations; non-ConfigMap objects pass through unchanged."""
    if obj.get("kind") == "ConfigMap":
        obj = dict(obj)
        obj.pop("data", None)
        obj.pop("binaryData", None)
        obj = _strip_metadata_bulk(obj)
    return obj


DEFAULT_TRANSFORMS = (strip_secret_data, strip_configmap_data)


def live_reader(client):
    """The live (uncached) client behind a reconciler's wrapper chain —
    EchoTrackingClient delegates ``store`` to the CachingClient, whose
    ``store`` is the real apiserver client; a bare store has no ``store``
    attribute and IS the live client. Conflict-retry paths re-read through
    this: after a 409 the foreign write's watch event may not have reached
    the cache yet, and a cached re-read would resend the same stale
    resourceVersion (RetryOnConflict re-reads from the apiserver for the
    same reason)."""
    return getattr(client, "store", None) or client


def owned_objects(client, kind: str, owner: dict) -> list[dict]:
    """``get_owned`` through ANY client: the indexed lookup when the client
    carries the informer index (CachingClient behind the usual wrapper
    chain), else a namespace LIST filtered by ownerReferences — the SAME
    result set either way (ownership is the one filter; a label selector
    here would silently drop an owned-but-mislabeled object on one path
    and adopt it on the other)."""
    fn = getattr(client, "get_owned", None)
    if fn is not None:
        return fn(kind, owner)
    return [o for o in client.list(kind, k8s.namespace(owner))
            if k8s.is_owned_by(o, k8s.uid(owner))]


def pods_on_node(client, node_name: str) -> list[dict]:
    """Pods bound to ``node_name`` through ANY client — the by-field
    ``spec.nodeName`` index when the client carries one (O(pods on this
    node)), else a label-existence LIST filtered in Python. The one
    node→pods fan-in both the slice-repair Node mapper and the kubelet
    simulator use, so their fallbacks cannot drift apart."""
    fn = getattr(client, "list_by_field", None)
    if fn is not None:
        return fn("Pod", "spec.nodeName", node_name)
    return [p for p in client.list("Pod", None, {"statefulset": None})
            if k8s.get_in(p, "spec", "nodeName") == node_name]


def _owner_uids(obj: dict) -> list[str]:
    return [r.get("uid") for r in
            (k8s.get_in(obj, "metadata", "ownerReferences",
                        default=[]) or [])
            if r.get("uid")]


class _KindStore:
    """One kind's objects plus its incrementally-maintained indexers (the
    client-go Indexer shape: ``by-namespace``, ``by-label`` per registered
    key, ``by-owner`` on ownerReferences UID). All mutation happens under
    the CachingClient lock; object dicts are replaced, never mutated, so
    references handed out under the lock are safe to read outside it."""

    __slots__ = ("label_keys", "field_paths", "objects", "by_namespace",
                 "by_owner", "by_label", "by_field")

    def __init__(self, label_keys: tuple[str, ...],
                 field_paths: tuple[str, ...] = ()):
        self.label_keys = label_keys
        # dot-paths into the object (e.g. "spec.nodeName"), pre-split once
        self.field_paths = {p: tuple(p.split(".")) for p in field_paths}
        self.objects: dict[tuple[str, str], dict] = {}  # (ns, name) → obj
        self.by_namespace: dict[str, set] = {}
        self.by_owner: dict[str, set] = {}
        self.by_label: dict[str, dict[str, set]] = {k: {} for k in label_keys}
        self.by_field: dict[str, dict[str, set]] = {p: {} for p in field_paths}

    # --------------------------------------------------------- maintenance
    def replace(self, key: tuple[str, str], obj: dict) -> None:
        old = self.objects.get(key)
        if old is not None:
            self._unindex(key, old)
        self.objects[key] = obj
        self._index(key, obj)

    def remove(self, key: tuple[str, str]) -> None:
        old = self.objects.pop(key, None)
        if old is not None:
            self._unindex(key, old)

    def _index(self, key: tuple[str, str], obj: dict) -> None:
        self.by_namespace.setdefault(key[0], set()).add(key)
        for uid in _owner_uids(obj):
            self.by_owner.setdefault(uid, set()).add(key)
        labels = k8s.get_in(obj, "metadata", "labels", default=None) or {}
        for lk in self.label_keys:
            if lk in labels:
                self.by_label[lk].setdefault(labels[lk], set()).add(key)
        for path, parts in self.field_paths.items():
            value = k8s.get_in(obj, *parts)
            if isinstance(value, str) and value:
                self.by_field[path].setdefault(value, set()).add(key)

    def _unindex(self, key: tuple[str, str], obj: dict) -> None:
        self._drop(self.by_namespace, key[0], key)
        for uid in _owner_uids(obj):
            self._drop(self.by_owner, uid, key)
        labels = k8s.get_in(obj, "metadata", "labels", default=None) or {}
        for lk in self.label_keys:
            if lk in labels:
                self._drop(self.by_label[lk], labels[lk], key)
        for path, parts in self.field_paths.items():
            value = k8s.get_in(obj, *parts)
            if isinstance(value, str) and value:
                self._drop(self.by_field[path], value, key)

    @staticmethod
    def _drop(index: dict, value, key) -> None:
        bucket = index.get(value)
        if bucket is not None:
            bucket.discard(key)
            if not bucket:  # empty buckets would leak one set per old value
                del index[value]

    # -------------------------------------------------------------- lookup
    def select(self, namespace: str | None,
               selector: dict | None) -> tuple[list[dict], str]:
        """Candidate objects via the narrowest applicable index. Returns
        (object refs, access path); the caller re-applies the FULL
        namespace+selector predicate outside the lock, so over-selection
        here is a perf concern only, never a correctness one."""
        if selector:
            for lk in self.label_keys:
                if lk in selector:
                    idx = self.by_label[lk]
                    val = selector[lk]
                    if val is None:  # existence term: every indexed value
                        keys = [k for bucket in idx.values() for k in bucket]
                    else:
                        keys = list(idx.get(val, ()))
                    return [self.objects[k] for k in keys], "by-label"
        if namespace is not None:
            return [self.objects[k]
                    for k in self.by_namespace.get(namespace, ())], \
                "by-namespace"
        if not selector:
            # unfiltered list-all IS the result set: O(result) by definition
            return list(self.objects.values()), "all"
        # selector carries no indexed key and no namespace bound: the one
        # shape that still walks the whole kind (cache_full_scans_total)
        return list(self.objects.values()), "scan"

    def owned(self, owner_uid: str) -> list[dict]:
        return [self.objects[k] for k in self.by_owner.get(owner_uid, ())]

    def field(self, path: str, value: str) -> tuple[list[dict], bool]:
        """Objects whose indexed field ``path`` equals ``value``; second
        element False when the path carries no index (caller must scan)."""
        idx = self.by_field.get(path)
        if idx is None:
            return [], False
        return [self.objects[k] for k in idx.get(value, ())], True


class CachingClient:
    """Same client surface as ClusterStore for reads/writes/watches, with the
    manager-cache semantics described above.

    ``disable_for`` kinds are payload kinds: their ``get``/``list`` payload
    reads go to the live store. They are still INGESTED (transforms strip
    the payload first, so a cached Secret/ConfigMap is metadata-sized —
    exactly the reference's stripped manager cache) so that a warm cache
    can answer EXISTENCE authoritatively: a miss on a warm payload kind is
    NotFound without a wire GET. Controllers probing optional ConfigMaps
    (CA bundles, runtime-images) every reconcile otherwise turn a big
    fan-out into a GET-404 storm. ``Event`` is the exception (never cached,
    never warm): the stream is high-churn and Events are read rarely."""

    NEVER_CACHE = frozenset(("Event",))

    def __init__(self, store,
                 transforms: Iterable[Callable[[dict], dict]] =
                 DEFAULT_TRANSFORMS,
                 disable_for: Iterable[str] = DEFAULT_DISABLE_FOR,
                 auto_informer: bool = True,
                 label_indexes: Iterable[str] = DEFAULT_LABEL_INDEXES,
                 field_indexes: Iterable[str] = DEFAULT_FIELD_INDEXES) -> None:
        self.store = store
        self.transforms = tuple(transforms)
        self.disable_for = frozenset(disable_for)
        self.label_indexes = tuple(label_indexes)
        self.field_indexes = tuple(field_indexes)
        # auto_informer=False: the cache opens NO watch streams of its own —
        # it is fed from watches its owner already holds (``feed``) plus an
        # explicit ``backfill`` per kind. This is how a reconciler shares
        # its manager watch streams with its read cache instead of
        # duplicating every stream + LIST (the reference likewise has ONE
        # informer layer serving both dispatch and cached reads).
        self.auto_informer = auto_informer
        # cache tier: taken for index/bucket bookkeeping only — live wire
        # reads (the miss fall-through, backfill LISTs) happen outside it
        self._lock = threading.Lock()
        self._kinds: dict[str, _KindStore] = {}
        # key → deletion time for keys DELETED by the watch stream; guards
        # the backfill (and the cache-miss fall-through) against resurrecting
        # an object whose DELETED event raced the list/get. The race window
        # is milliseconds, so entries expire after TOMBSTONE_TTL_S — without
        # the TTL this set would grow with every deletion for the process
        # lifetime
        self._tombstones: dict[tuple[str, str, str], float] = {}
        self._watched: set[str] = set()
        # kinds whose backfill LIST has completed: for these a cache miss is
        # an authoritative NotFound (informer semantics) — falling through
        # to a live GET would re-create the per-frame GET storm for every
        # lookup of a deleted object (e.g. Events outliving their Pod)
        self._warm: set[str] = set()
        # kind → count of currently-broken watch streams (mark_watch_gap/
        # mark_watch_recovered, fed by the transport's stream health): while
        # any stream for a kind is down, cached reads of it fall back LIVE —
        # the informer can be arbitrarily stale until the reconnect resync
        # lands, and an authoritative NotFound from a stale cache is wrong
        self._gapped: dict[str, int] = {}
        self._index_lookups = None  # cache_index_lookups_total
        self._full_scans = None     # cache_full_scans_total

    # ------------------------------------------------------------- ingest
    def _transform(self, obj: dict) -> dict:
        for t in self.transforms:
            obj = t(obj)
        return obj

    def _live_list(self, kind: str, namespace: str | None = None,
                   label_selector: dict | None = None) -> list[dict]:
        """A LIST that must leave this cache (gap/unfed/payload
        fallbacks, backfills, resyncs): prefer the backing client's
        rv-gated ``list_cached`` — over the wire that's the
        consistent-read-from-cache form served lock-free from the
        apiserver's watch cache (never stale: the facade's cache is fed
        synchronously under the store lock), so N managers' fallback
        LISTs can't stampede the store's write path. A backing store
        without the method (bare ClusterStore behind another wrapper)
        keeps the plain LIST."""
        lister = getattr(self.store, "list_cached", None)
        if lister is not None:
            return lister(kind, namespace, label_selector)
        return self.store.list(kind, namespace, label_selector)

    def _ensure_informer(self, kind: str) -> None:
        if not self.auto_informer:
            return  # externally fed: owner registers watches + backfills
        with self._lock:
            if kind in self._watched:
                return
            self._watched.add(kind)
        # register the watch BEFORE backfilling: an update landing between a
        # list snapshot and watch registration would otherwise never be
        # delivered, leaving the cache stale forever. The overlap is made
        # safe by (a) the resourceVersion guard in _ingest (a newer watched
        # copy is never overwritten by the older snapshot) and (b) the
        # tombstone set (a DELETED racing the snapshot is not resurrected).
        self.store.watch(kind, self._on_event)
        for obj in self._live_list(kind):
            self._ingest(obj)
        with self._lock:
            self._warm.add(kind)

    # ---------------------------------------------------- external feeding
    def feed(self, event: WatchEvent) -> None:
        """Ingest one watch event from a stream the OWNER holds (tee from a
        manager watch). Only meaningful with auto_informer=False.
        Payload (disable_for) kinds are ingested STRIPPED — the transforms
        drop data/binaryData/stringData — so the cache can answer existence
        without ever holding payloads; Event is dropped at the door (high
        churn, never served from cache).

        The event object may be SHARED with every other watcher of the
        store (serialize-once fan-out deepcopies once per event, not per
        consumer): this cache honors that by never mutating what it
        ingests — transforms copy-on-write, stores replace whole objects,
        reads deepcopy on the way out. A DELETED synthesized after an
        outage may carry only a skeleton (rv + routing metadata, the
        transport's slim ``seen`` record); removal needs only its key."""
        if event.obj.get("kind") in self.NEVER_CACHE:
            return
        self._on_event(event)

    def backfill(self, kind: str) -> None:
        """Snapshot-list ``kind`` into the cache and mark it warm. Call
        AFTER the external watch feeding this cache is registered (same
        watch-then-list ordering _ensure_informer uses, same staleness
        guards). Idempotent: a kind already warm (a second controller
        watching it) skips the redundant LIST.

        The LIST always runs on first backfill, even for clients whose
        watch streams resync initial state on connect (HttpApiClient):
        warm means "a complete snapshot has landed", and the resync is
        delivered asynchronously AFTER watch() returns — marking warm on
        the promise of a resync would turn existing objects into
        authoritative NotFounds for the gap (and for the whole outage if
        the stream never connected). The overlap with a delivered resync
        is idempotent ingestion.

        Payload (disable_for) kinds backfill too — stripped — so their
        existence checks turn authoritative; Event never does."""
        if kind in self.NEVER_CACHE:
            return  # never cached, never warm
        with self._lock:
            if kind in self._warm:
                return
        for obj in self._live_list(kind):
            self._ingest(obj)
        with self._lock:
            self._watched.add(kind)
            self._warm.add(kind)

    # -------------------------------------------------- watch-gap fallback
    def mark_watch_gap(self, kind: str) -> None:
        """A watch stream feeding ``kind`` dropped (transport stream-health
        callback): until it recovers, cached reads of the kind serve LIVE —
        the satellite contract for periodic scrapes (serve from the
        informer index while the watch is healthy, fall back to a real
        LIST only across a gap)."""
        with self._lock:
            self._gapped[kind] = self._gapped.get(kind, 0) + 1

    def mark_watch_recovered(self, kind: str) -> None:
        """The dropped stream reconnected AND its resync diff was delivered
        (the cache is converged again): resume serving from the index."""
        with self._lock:
            n = self._gapped.get(kind, 0) - 1
            if n > 0:
                self._gapped[kind] = n
            else:
                self._gapped.pop(kind, None)

    def _is_gapped(self, kind: str) -> bool:
        with self._lock:
            return kind in self._gapped

    # -------------------------------------------------------------- metrics
    def attach_metrics(self, registry) -> None:
        """Register the index-vs-scan counter pair (and pass the registry
        down to the backing store). ``cache_full_scans_total`` staying at 0
        is the loadtest/smoke proof that no reconcile-hot read walks the
        whole cache."""
        self._index_lookups = registry.counter(
            "cache_index_lookups_total",
            "Cached reads served via an informer index, by kind and "
            "index (by-label / by-namespace / by-owner / all).")
        self._full_scans = registry.counter(
            "cache_full_scans_total",
            "Cached LISTs that had to walk a whole kind store because no "
            "index covered the query. Must be 0 on the reconcile hot path.")
        if hasattr(self.store, "attach_metrics"):
            self.store.attach_metrics(registry)

    def _count_access(self, kind: str, via: str) -> None:
        if via == "scan":
            if self._full_scans is not None:
                self._full_scans.inc({"kind": kind})
        elif self._index_lookups is not None:
            self._index_lookups.inc({"kind": kind, "index": via})

    TOMBSTONE_TTL_S = 10.0

    def _prune_tombstones_locked(self) -> None:
        cutoff = time.monotonic() - self.TOMBSTONE_TTL_S
        stale = [k for k, t in self._tombstones.items() if t < cutoff]
        for k in stale:
            del self._tombstones[k]

    def _on_event(self, event: WatchEvent) -> None:
        key = self._key(event.obj)
        if event.type == "DELETED":
            with self._lock:
                ks = self._kinds.get(key[0])
                if ks is not None:
                    ks.remove((key[1], key[2]))
                self._prune_tombstones_locked()
                self._tombstones[key] = time.monotonic()
        else:
            self._ingest(event.obj, from_watch=True)

    @staticmethod
    def _rv(obj: dict) -> int:
        try:
            return int((obj.get("metadata") or {})
                       .get("resourceVersion", 0))
        except (TypeError, ValueError):
            return 0

    def _ingest(self, obj: dict, from_watch: bool = False) -> None:
        key = self._key(obj)
        with self._lock:
            if from_watch:
                # an ADDED after DELETED is a genuine recreate
                self._tombstones.pop(key, None)
            elif self._tombstones.get(key, 0) > \
                    time.monotonic() - self.TOMBSTONE_TTL_S:
                return  # stale snapshot of a deleted object
            ks = self._kinds.get(key[0])
            if ks is None:
                ks = self._kinds[key[0]] = _KindStore(self.label_indexes,
                                                      self.field_indexes)
            cached = ks.objects.get((key[1], key[2]))
            if cached is not None:
                cached_rv, new_rv = self._rv(cached), self._rv(obj)
                # never replace a newer watched copy with older state — an
                # rv-less snapshot (rv 0) must NOT clobber a versioned one
                if cached_rv > new_rv:
                    return
                # and skip EQUAL-rv re-ingestion (both versioned): several
                # controllers watching one kind deliver the same frame once
                # per stream; re-transform/re-store under the lock is waste
                if new_rv and cached_rv == new_rv:
                    return
            ks.replace((key[1], key[2]), self._transform(obj))

    @staticmethod
    def _key(obj: dict) -> tuple[str, str, str]:
        return (obj.get("kind", ""), k8s.namespace(obj), k8s.name(obj))

    # -------------------------------------------------------------- reads
    def cached_object(self, kind: str, namespace: str,
                      name: str) -> dict | None:
        """Introspection: the cache's current copy (deepcopy) or None —
        what a cache consumer WOULD see, without live fall-through. Tests
        assert payload-stripping and tombstone behavior through this."""
        with self._lock:
            ks = self._kinds.get(kind)
            obj = ks.objects.get((namespace, name)) if ks else None
        return k8s.deepcopy(obj) if obj is not None else None

    def get(self, kind: str, namespace: str, name: str) -> dict:
        if self._is_gapped(kind):
            # watch gap: the cache may be missing foreign writes until the
            # resync lands — neither a cached copy nor an authoritative
            # NotFound is trustworthy, so read live (no ingest: event
            # ordering during the gap is unknown; the resync repairs)
            return self.store.get(kind, namespace, name)
        if kind in self.disable_for:
            # payload kind: a HIT still reads live (the caller wants the
            # data the cache deliberately strips), but a MISS on a warm,
            # watch-fed kind is an authoritative NotFound — no wire GET
            # for every optional ConfigMap probed per reconcile
            with self._lock:
                warm = kind in self._warm
                ks = self._kinds.get(kind)
                present = ks is not None and (namespace, name) in ks.objects
            if warm and not present:
                raise NotFoundError(f"{kind} {namespace}/{name}")
            return self.store.get(kind, namespace, name)  # live read
        with self._lock:
            unfed = kind not in self._watched
        if unfed and not self.auto_informer:
            # nobody feeds this kind: live read WITHOUT ingest — a cached
            # copy no watch updates would be served stale forever
            return self.store.get(kind, namespace, name)
        self._ensure_informer(kind)
        with self._lock:
            ks = self._kinds.get(kind)
            obj = ks.objects.get((namespace, name)) if ks else None
            warm = kind in self._warm
        if obj is not None:
            return k8s.deepcopy(obj)
        if warm:
            # informer-authoritative miss: the kind is fully backfilled and
            # watch-fed, so absence from the cache IS NotFound. Falling
            # through live would issue one GET per lookup of every deleted
            # object — the teardown-storm case (Events outlive their Pod).
            raise NotFoundError(f"{kind} {namespace}/{name}")
        # not yet warm (external-feed kind before backfill): live, ingest
        obj = self.store.get(kind, namespace, name)
        self._ingest(obj)
        return self._transform(k8s.deepcopy(obj))

    def get_or_none(self, kind: str, namespace: str, name: str) -> dict | None:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict | None = None) -> list[dict]:
        with self._lock:
            unfed = kind not in self._watched
        if kind in self.disable_for or (unfed and not self.auto_informer) \
                or self._is_gapped(kind):
            # external-feed mode never auto-opens informers, so a LIST of a
            # kind nobody backfilled must go live, not return an empty
            # cache; a watch gap likewise bypasses the (possibly stale)
            # index until the reconnect resync converges it
            return self._live_list(kind, namespace, label_selector)
        self._ensure_informer(kind)
        # index lookup under the lock is O(result); the label predicate and
        # the deepcopying run OUTSIDE it — object dicts are replaced (never
        # mutated) on ingest, so the refs stay safe to read, and list() on
        # a big fleet never stalls ingestion on per-object predicate work
        with self._lock:
            ks = self._kinds.get(kind)
            candidates, via = (ks.select(namespace, label_selector)
                               if ks is not None else ([], "all"))
        self._count_access(kind, via)
        matched = [o for o in candidates
                   if (namespace is None or k8s.namespace(o) == namespace)
                   and k8s.matches_labels(o, label_selector)]
        return [k8s.deepcopy(o) for o in matched]

    def list_cached(self, kind: str, namespace: str | None = None,
                    label_selector: dict | None = None,
                    min_resource_version: int | None = None) -> list[dict]:
        """Interface parity with HttpApiClient.list_cached: this cache's
        index IS the consistent-read store (watch-fed, rv-guarded), and
        every fallback inside list() already rides the backing client's
        rv=0 form — so the resync path can ask any client for a
        cache-acceptable LIST without caring about the wrapper chain."""
        return self.list(kind, namespace, label_selector)

    def list_by_field(self, kind: str, path: str, value: str,
                      namespace: str | None = None) -> list[dict]:
        """Objects of ``kind`` whose field ``path`` (dot-path, e.g.
        "spec.nodeName") equals ``value`` — the FieldIndexer lookup,
        O(result) when the path is indexed (``field_indexes``). Falls back
        to a filtered live LIST for payload/unfed/gapped kinds and to a
        counted full scan when the path carries no index, so the result
        set is identical regardless of wiring."""
        parts = tuple(path.split("."))
        with self._lock:
            unfed = kind not in self._watched
        if kind in self.disable_for or (unfed and not self.auto_informer) \
                or self._is_gapped(kind):
            return [o for o in self._live_list(kind, namespace)
                    if k8s.get_in(o, *parts) == value]
        self._ensure_informer(kind)
        with self._lock:
            ks = self._kinds.get(kind)
            if ks is None:
                candidates, indexed = [], True
            else:
                candidates, indexed = ks.field(path, value)
                if not indexed:
                    candidates = list(ks.objects.values())
        self._count_access(kind, "by-field" if indexed else "scan")
        # the full predicate re-applies OUTSIDE the lock on both paths
        # (same over-selection contract as select())
        matched = [o for o in candidates
                   if k8s.get_in(o, *parts) == value
                   and (namespace is None or k8s.namespace(o) == namespace)]
        return [k8s.deepcopy(o) for o in matched]

    def get_owned(self, kind: str, owner: dict | str) -> list[dict]:
        """Objects of ``kind`` whose ownerReferences carry the owner's UID —
        the by-owner index lookup (client-go's cache.OwnerIndex shape), the
        O(result) replacement for list-by-label + Python ownership filter.
        ``owner`` is the owner object (preferred: its namespace scopes the
        live fallback) or a bare UID string. Ownership is the ONLY filter,
        on the index path and the live fallback alike — identical result
        sets regardless of wiring."""
        owner_uid = k8s.uid(owner) if isinstance(owner, dict) else owner
        owner_ns = k8s.namespace(owner) if isinstance(owner, dict) else None
        with self._lock:
            unfed = kind not in self._watched
        if kind in self.disable_for or (unfed and not self.auto_informer) \
                or self._is_gapped(kind):
            return [o for o in self._live_list(kind, owner_ns)
                    if k8s.is_owned_by(o, owner_uid)]
        self._ensure_informer(kind)
        with self._lock:
            ks = self._kinds.get(kind)
            candidates = ks.owned(owner_uid) if ks is not None else []
        self._count_access(kind, "by-owner")
        return [k8s.deepcopy(o) for o in candidates]

    # ---------------------------------------- writes + watches: passthrough
    def _ingest_write(self, obj, recreate: bool = False):
        """Feed a write's RESPONSE (fresh rv) straight into the cache for
        kinds this cache tracks — read-your-writes for the author. Over a
        real wire the watch event confirming our own write arrives
        milliseconds later; without this, a warm payload kind would report
        a just-created object as authoritative NotFound for that window,
        and any re-read would serve the pre-write copy. The rv guard in
        _ingest keeps the overlap with the eventual watch event idempotent.

        ``recreate`` (create responses only) clears a DELETE tombstone — a
        create after delete is a genuine recreate. Update/patch responses
        must NOT: an update racing a delete would pop the tombstone and
        resurrect the deleted object in the cache forever (no later watch
        event would ever evict it)."""
        if isinstance(obj, dict):
            kind = obj.get("kind")
            if kind and kind not in self.NEVER_CACHE:
                with self._lock:
                    tracked = kind in self._watched or kind in self._warm
                if tracked:
                    # deepcopy: the same response dict goes back to the
                    # caller, who may mutate it (copy-fields helpers do) —
                    # the cache must hold its own copy
                    self._ingest(k8s.deepcopy(obj), from_watch=recreate)
        return obj

    def create(self, obj: dict) -> dict:
        return self._ingest_write(self.store.create(obj), recreate=True)

    def update(self, obj: dict) -> dict:
        return self._ingest_write(self.store.update(obj))

    def update_status(self, obj: dict) -> dict:
        return self._ingest_write(self.store.update_status(obj))

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        return self._ingest_write(self.store.patch(kind, namespace, name,
                                                   patch))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        return self.store.delete(kind, namespace, name)

    def watch(self, kind: str, callback, **kw) -> None:
        return self.store.watch(kind, callback, **kw)

    def register_admission(self, kind: str, fn) -> None:
        return self.store.register_admission(kind, fn)

    @property
    def supports_inprocess_admission(self) -> bool:
        return getattr(self.store, "supports_inprocess_admission", True)
