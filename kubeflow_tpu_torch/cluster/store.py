"""In-process Kubernetes API server.

The port's copy of ``ClusterStore`` in ``kubeflow_tpu/cluster/store.py``
(the port imports nothing of the JAX package): the API semantics the
controllers rely on, which the parity harness
(tests/test_torch_store.py) holds against the reference's store:

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
  workqueues, delivered in write order outside the store's lock (a
  callback may re-enter the store);
- admission plugins run before a create or update is persisted, then
  the CRD schema: creating a CustomResourceDefinition registers its
  served versions' structural schemas, and every later write of that
  kind is validated against them (the apiserver's order: mutating
  admission, validating admission, schema, persistence).

One ``threading.RLock`` guards the objects, the resourceVersion counter
and the watch list. Objects are kept per (kind, namespace), so a
namespaced LIST walks that namespace's objects of the kind only. A stored
object is never mutated after it is published: every write replaces its
slot with a fresh dict, so watch events share it without a copy.

Left out, with the HTTP apiserver they serve: the shared wire frames and
their per-kind resume ring, paginated LISTs with continue tokens, frame
relays, the watch-cache snapshot handshake, the binary codec, remote
(HTTPS) admission and the store's shards.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

from ..utils import k8s
from ..utils.names import generate_suffix
from .errors import AlreadyExistsError, ConflictError, InvalidError, NotFoundError

CLUSTER_SCOPED_KINDS = {
    "Namespace", "ClusterRole", "ClusterRoleBinding", "OAuthClient",
    "CustomResourceDefinition", "PriorityClass", "Node", "APIServer",
    "MutatingWebhookConfiguration", "ValidatingWebhookConfiguration",
}


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    obj: dict


@dataclass
class _Watch:
    kind: str
    callback: Callable[[WatchEvent], None]
    namespace: str | None = None
    label_selector: dict[str, str] | None = None


class ClusterStore:
    """The in-process apiserver + etcd. All mutating verbs return a deep copy
    of the stored object (as the real apiserver returns the canonical form)."""

    # bounds the patch re-merge loop: a hot object backs off and eventually
    # surfaces the conflict rather than livelock
    PATCH_MAX_RETRIES = 20

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # (kind, namespace) → name → stored object
        self._objects: dict[tuple[str, str], dict[str, dict]] = {}
        self._rv_counter = itertools.count(1)
        self._last_rv = 0  # latest issued resourceVersion
        self._uid_counter = itertools.count(1)
        self._watches: list[_Watch] = []
        # admission hooks: (kind, fn(operation, obj, old) -> obj | raise)
        self._admission: list[tuple[str, Callable]] = []
        # CRD structural schemas: kind → {version: openAPIV3Schema}, kept
        # in step with the CustomResourceDefinition objects
        self._crd_schemas: dict[str, dict[str, dict]] = {}

    def _next_rv(self) -> str:
        """Issue the next resourceVersion (caller holds the lock)."""
        self._last_rv = next(self._rv_counter)
        return str(self._last_rv)

    # ------------------------------------------------------------------ keys
    @staticmethod
    def _bucket_key(kind: str, namespace: str) -> tuple[str, str]:
        return (kind, "" if kind in CLUSTER_SCOPED_KINDS else namespace)

    def _bucket_of(self, obj: dict) -> tuple[tuple[str, str], str]:
        return (self._bucket_key(k8s.kind(obj), k8s.namespace(obj)),
                k8s.name(obj))

    def _stored(self, bucket: tuple[str, str], name: str) -> dict | None:
        return self._objects.get(bucket, {}).get(name)

    # ------------------------------------------------------------- admission
    def register_admission(self, kind: str, fn: Callable) -> None:
        """Register an admission plugin invoked before create/update/patch
        is persisted: the seam the mutating/validating webhooks plug into."""
        self._admission.append((kind, fn))

    def _admit(self, operation: str, obj: dict, old: dict | None) -> dict:
        for kind, fn in self._admission:
            if kind == k8s.kind(obj):
                obj = fn(operation, obj, old)
        # the schema holds what will be persisted, after the webhooks
        self._validate_against_crd(obj)
        return obj

    # ----------------------------------------------------------- CRD schemas
    def _index_crd(self, crd: dict) -> None:
        """Register a CRD's served schemas (caller holds the lock)."""
        kind = k8s.get_in(crd, "spec", "names", "kind")
        if not kind:
            return
        versions = {}
        for v in k8s.get_in(crd, "spec", "versions", default=[]) or []:
            s = k8s.get_in(v, "schema", "openAPIV3Schema")
            if v.get("served") and s:
                versions[v["name"]] = s
        if versions:
            self._crd_schemas[kind] = versions

    def _unindex_crd(self, crd: dict) -> None:
        """Drop a deleted CRD's schemas (caller holds the lock)."""
        self._crd_schemas.pop(k8s.get_in(crd, "spec", "names", "kind"), None)

    def _validate_against_crd(self, obj: dict) -> None:
        with self._lock:
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
        """Snapshot the watchers of one event (caller holds the lock and
        has stamped ``obj``'s resourceVersion); returns the emission for
        ``_dispatch_all``."""
        kind, ns = k8s.kind(obj), k8s.namespace(obj)
        targets = [w for w in self._watches
                   if w.kind == kind
                   and (w.namespace is None or w.namespace == ns)
                   and k8s.matches_labels(obj, w.label_selector)]
        return etype, obj, targets

    @staticmethod
    def _dispatch_all(emitted: list) -> None:
        """Deliver emitted events outside the lock, in write order. The
        object is the stored one, shared by every consumer: callbacks
        treat it as immutable."""
        for etype, obj, targets in emitted:
            for w in targets:
                w.callback(WatchEvent(etype, obj))

    def watch(self, kind: str, callback: Callable[[WatchEvent], None],
              namespace: str | None = None,
              label_selector: dict[str, str] | None = None) -> None:
        with self._lock:
            self._watches.append(_Watch(kind, callback, namespace,
                                        label_selector))

    def unwatch(self, callback: Callable[[WatchEvent], None]) -> None:
        """Deregister a watch callback (equality, so a bound method
        handed in again matches)."""
        with self._lock:
            self._watches = [w for w in self._watches
                             if w.callback != callback]

    # ----------------------------------------------------------------- verbs
    def create(self, obj: dict) -> dict:
        obj = k8s.deepcopy(obj)
        obj = self._admit("CREATE", obj, None)
        md = k8s.meta(obj)
        if not md.get("name") and md.get("generateName"):
            md["name"] = md["generateName"] + generate_suffix(
                f'{md["generateName"]}{next(self._uid_counter)}', 5)
        if not md.get("name"):
            raise InvalidError("metadata.name or generateName required")
        bucket, name = self._bucket_of(obj)
        md.setdefault("creationTimestamp", k8s.now_iso())
        with self._lock:
            if self._stored(bucket, name) is not None:
                raise AlreadyExistsError(f"{bucket[0]} {bucket[1]}/{name}")
            md["uid"] = f"uid-{next(self._uid_counter)}"
            md["generation"] = 1
            md["resourceVersion"] = self._next_rv()
            self._objects.setdefault(bucket, {})[name] = obj
            emitted = [self._emit_locked("ADDED", obj)]
            if bucket[0] == "CustomResourceDefinition":
                self._index_crd(obj)
        self._dispatch_all(emitted)
        return k8s.deepcopy(obj)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._lock:
            obj = self._stored(self._bucket_key(kind, namespace), name)
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
        with self._lock:
            if namespace is None:
                buckets = [b for b in self._objects if b[0] == kind]
            else:
                buckets = [self._bucket_key(kind, namespace)]
            refs = [((b[1], n), o) for b in buckets
                    for n, o in self._objects.get(b, {}).items()]
        refs.sort(key=lambda pair: pair[0])
        return [k8s.deepcopy(o) for _, o in refs
                if k8s.matches_labels(o, label_selector)]

    def update(self, obj: dict) -> dict:
        obj = k8s.deepcopy(obj)
        bucket, name = self._bucket_of(obj)
        label = f"{bucket[0]} {bucket[1]}/{name}"
        with self._lock:
            old = self._stored(bucket, name)
        if old is None:
            raise NotFoundError(label)
        snapshot_rv = old["metadata"]["resourceVersion"]
        new_rv = k8s.get_in(obj, "metadata", "resourceVersion")
        if new_rv is not None and new_rv != snapshot_rv:
            raise ConflictError(f"{label}: stale resourceVersion")
        # admission runs outside the lock; the re-check below confirms the
        # state it admitted against is still the state being replaced
        obj = self._admit("UPDATE", obj, k8s.deepcopy(old))
        with self._lock:
            old = self._stored(bucket, name)
            if old is None:
                raise NotFoundError(label)
            # only optimistic writers re-check: a no-RV update keeps the
            # apiserver's unconditional last-write-wins semantics
            if new_rv is not None and \
                    old["metadata"]["resourceVersion"] != snapshot_rv:
                raise ConflictError(f"{label}: object changed during "
                                    f"admission")
            md = k8s.meta(obj)
            md["uid"] = old["metadata"]["uid"]
            md["creationTimestamp"] = old["metadata"]["creationTimestamp"]
            if k8s.get_in(old, "metadata", "deletionTimestamp"):
                md["deletionTimestamp"] = old["metadata"]["deletionTimestamp"]
            if obj.get("spec") != old.get("spec"):
                md["generation"] = old["metadata"].get("generation", 1) + 1
            else:
                md["generation"] = old["metadata"].get("generation", 1)
            md["resourceVersion"] = self._next_rv()
            if (k8s.get_in(obj, "metadata", "deletionTimestamp")
                    and not k8s.get_in(obj, "metadata", "finalizers")):
                # last finalizer stripped → actually remove (two-phase
                # delete), cascading to dependents
                emitted = self._remove_and_gc(bucket, name, replacement=obj)
            else:
                self._objects[bucket][name] = obj
                emitted = [self._emit_locked("MODIFIED", obj)]
                if bucket[0] == "CustomResourceDefinition":
                    self._index_crd(obj)
        self._dispatch_all(emitted)
        return k8s.deepcopy(obj)

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        """RFC 7386 JSON merge patch (client.MergeFrom semantics). Unlike
        update(), it re-merges against the current version on a concurrent
        write, with bounded backoff."""
        bucket = self._bucket_key(kind, namespace)
        for attempt in range(self.PATCH_MAX_RETRIES):
            with self._lock:
                old = self._stored(bucket, name)
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
        bucket, name = self._bucket_of(obj)
        new_status = k8s.deepcopy(obj.get("status", {}))
        new_rv = k8s.get_in(obj, "metadata", "resourceVersion")
        with self._lock:
            old = self._stored(bucket, name)
            if old is None:
                raise NotFoundError(f"{bucket[0]} {bucket[1]}/{name}")
            if new_rv is not None and \
                    new_rv != old["metadata"]["resourceVersion"]:
                raise ConflictError(f"{bucket[0]} {bucket[1]}/{name}")
            stored = {**old, "status": new_status,
                      "metadata": {**old["metadata"],
                                   "resourceVersion": self._next_rv()}}
            self._objects[bucket][name] = stored
            emitted = [self._emit_locked("MODIFIED", stored)]
        self._dispatch_all(emitted)
        return k8s.deepcopy(stored)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Two-phase delete: finalizers present → set deletionTimestamp and
        wait for controllers to strip them; else remove + cascade to owned
        objects (background GC)."""
        bucket = self._bucket_key(kind, namespace)
        with self._lock:
            obj = self._stored(bucket, name)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name}")
            if k8s.get_in(obj, "metadata", "finalizers"):
                emitted = []
                if not k8s.get_in(obj, "metadata", "deletionTimestamp"):
                    emitted.append(self._mark_deleting_locked(bucket, name,
                                                              obj))
            else:
                emitted = self._remove_and_gc(bucket, name)
        self._dispatch_all(emitted)

    # ------------------------------------------------------- delete plumbing
    def _mark_deleting_locked(self, bucket: tuple[str, str], name: str,
                              obj: dict) -> tuple:
        """Copy-on-write delete mark (the stored object is immutable)."""
        marked = {**obj, "metadata": {**obj["metadata"],
                                      "deletionTimestamp": k8s.now_iso(),
                                      "resourceVersion": self._next_rv()}}
        self._objects[bucket][name] = marked
        return self._emit_locked("MODIFIED", marked)

    def _remove_and_gc(self, bucket: tuple[str, str], name: str,
                       replacement: dict | None = None) -> list:
        """Remove an object and cascade-delete its dependents through
        ownerReferences, honouring the dependents' own finalizers (caller
        holds the lock). The DELETED event carries a fresh
        resourceVersion, as the real apiserver's does."""
        objs = self._objects.get(bucket, {})
        obj = objs.pop(name, None)
        if replacement is not None:
            obj = replacement
        emitted: list = []
        if obj is None:
            return emitted
        if bucket[0] == "CustomResourceDefinition":
            self._unindex_crd(obj)
        final = {**obj, "metadata": {**obj["metadata"],
                                     "resourceVersion": self._next_rv()}}
        emitted.append(self._emit_locked("DELETED", final))
        owner_uid = k8s.uid(obj)
        if not owner_uid:
            return emitted
        dependents = [(b, n) for b, bobjs in self._objects.items()
                      for n, o in bobjs.items()
                      if k8s.is_owned_by(o, owner_uid)]
        for dbucket, dname in dependents:
            dobj = self._stored(dbucket, dname)
            if dobj is None:
                continue
            if k8s.get_in(dobj, "metadata", "finalizers"):
                if not k8s.get_in(dobj, "metadata", "deletionTimestamp"):
                    emitted.append(self._mark_deleting_locked(
                        dbucket, dname, dobj))
            else:
                emitted.extend(self._remove_and_gc(dbucket, dname))
        return emitted

    # ----------------------------------------------------------- conveniences
    def all_objects(self) -> Iterator[dict]:
        with self._lock:
            refs = [o for objs in self._objects.values()
                    for o in objs.values()]
        return iter([k8s.deepcopy(o) for o in refs])
