"""The port's in-process apiserver held against the reference's: every
case of tests/test_store.py runs on both stores, each with the case's own
assertions; both must raise the same error classes (by name), make the
same writes, and end in the same objects (compared through the
harness's ``normalise`` (tests/torch_parity.py)).
"""

from __future__ import annotations

import pytest

from kubeflow_tpu.cluster import errors as ref_errors
from kubeflow_tpu.cluster.store import ClusterStore as RefStore
from kubeflow_tpu.cluster.store import WatchEvent as RefWatchEvent
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu_torch.cluster import errors
from kubeflow_tpu_torch.cluster.store import ClusterStore, WatchEvent
from kubeflow_tpu_torch.utils import k8s
from torch_parity import normalise


class Side:
    def __init__(self, side: str):
        ref = side == "ref"
        self.side = side
        self.store = RefStore() if ref else ClusterStore()
        self.errors = ref_errors if ref else errors
        self.k8s = ref_k8s if ref else k8s
        self.WatchEvent = RefWatchEvent if ref else WatchEvent
        self.raised: list[str] = []

    def raises(self, cls_name: str, fn, *args):
        """Run ``fn``; it must raise this side's ``cls_name``."""
        with pytest.raises(getattr(self.errors, cls_name)) as info:
            fn(*args)
        self.raised.append(type(info.value).__name__)

    def objects(self) -> dict:
        return {(o["kind"], self.k8s.namespace(o), self.k8s.name(o)):
                normalise(o, self.side) for o in self.store.all_objects()}


def mk(kind, name, ns="default", **extra):
    obj = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": name, "namespace": ns}}
    obj.update(extra)
    return obj


# ------------------------------------------------ the reference's cases
def create_sets_metadata(s):
    out = s.store.create(mk("ConfigMap", "a"))
    assert out["metadata"]["uid"]
    assert out["metadata"]["resourceVersion"]
    assert out["metadata"]["creationTimestamp"]
    assert out["metadata"]["generation"] == 1
    return [out["metadata"]["uid"], out["metadata"]["resourceVersion"]]


def create_duplicate_conflicts(s):
    s.store.create(mk("ConfigMap", "a"))
    s.raises("AlreadyExistsError", s.store.create, mk("ConfigMap", "a"))


def generate_name(s):
    out = s.store.create({"apiVersion": "apps/v1", "kind": "StatefulSet",
                          "metadata": {"generateName": "nb-",
                                       "namespace": "default"}})
    assert out["metadata"]["name"].startswith("nb-")
    assert len(out["metadata"]["name"]) > 3
    return out["metadata"]["name"]   # the seeded suffix: equal on both


def optimistic_concurrency(s):
    a = s.store.create(mk("ConfigMap", "a", data={"k": "1"}))
    b = s.store.get("ConfigMap", "default", "a")
    b["data"] = {"k": "2"}
    s.store.update(b)
    a["data"] = {"k": "3"}
    s.raises("ConflictError", s.store.update, a)


def generation_bumps_on_spec_change_only(s):
    obj = s.store.create(mk("StatefulSet", "s", spec={"replicas": 1}))
    obj["metadata"]["labels"] = {"x": "y"}
    obj = s.store.update(obj)
    assert obj["metadata"]["generation"] == 1
    obj["spec"]["replicas"] = 2
    obj = s.store.update(obj)
    assert obj["metadata"]["generation"] == 2


def merge_patch_removes_with_null(s):
    s.store.create(mk("Notebook", "nb",
                      metadata={"name": "nb", "namespace": "default",
                                "annotations": {"a": "1", "b": "2"}}))
    out = s.store.patch("Notebook", "default", "nb",
                        {"metadata": {"annotations": {"a": None}}})
    assert out["metadata"]["annotations"] == {"b": "2"}


def finalizer_two_phase_delete(s):
    obj = mk("Notebook", "nb")
    obj["metadata"]["finalizers"] = ["example/fin"]
    s.store.create(obj)
    s.store.delete("Notebook", "default", "nb")
    cur = s.store.get("Notebook", "default", "nb")
    assert s.k8s.is_deleting(cur)
    cur["metadata"]["finalizers"] = []
    s.store.update(cur)
    s.raises("NotFoundError", s.store.get, "Notebook", "default", "nb")


def owner_gc_cascade(s):
    owner = s.store.create(mk("Notebook", "nb"))
    child = mk("StatefulSet", "nb")
    s.k8s.set_controller_reference(owner, child)
    s.store.create(child)
    grandchild = mk("Pod", "nb-0")
    s.k8s.set_controller_reference(
        s.store.get("StatefulSet", "default", "nb"), grandchild)
    s.store.create(grandchild)
    s.store.delete("Notebook", "default", "nb")
    s.raises("NotFoundError", s.store.get, "StatefulSet", "default", "nb")
    s.raises("NotFoundError", s.store.get, "Pod", "default", "nb-0")


def watch_events(s):
    seen = []
    s.store.watch("ConfigMap", seen.append)
    s.store.create(mk("ConfigMap", "a"))
    cur = s.store.get("ConfigMap", "default", "a")
    cur["data"] = {"x": "1"}
    s.store.update(cur)
    s.store.delete("ConfigMap", "default", "a")
    assert [e.type for e in seen] == ["ADDED", "MODIFIED", "DELETED"]
    assert all(isinstance(e, s.WatchEvent) for e in seen)
    return [(e.type, normalise(e.obj, s.side)) for e in seen]


def update_status_subresource_ignores_spec(s):
    obj = s.store.create(mk("StatefulSet", "s", spec={"replicas": 1}))
    obj["spec"]["replicas"] = 5
    obj["status"] = {"readyReplicas": 1}
    out = s.store.update_status(obj)
    assert out["spec"]["replicas"] == 1
    assert out["status"]["readyReplicas"] == 1


def cluster_scoped_kinds(s):
    s.store.create({"apiVersion": "rbac.authorization.k8s.io/v1",
                    "kind": "ClusterRoleBinding",
                    "metadata": {"name": "crb", "namespace": "ignored"}})
    assert s.store.get("ClusterRoleBinding", "", "crb")


# the 11 cases of tests/test_store.py, under their names
REFERENCE_CASES = {f"test_{fn.__name__}": fn for fn in (
    create_sets_metadata, create_duplicate_conflicts, generate_name,
    optimistic_concurrency, generation_bumps_on_spec_change_only,
    merge_patch_removes_with_null, finalizer_two_phase_delete,
    owner_gc_cascade, watch_events, update_status_subresource_ignores_spec,
    cluster_scoped_kinds)}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_on_both_stores(case):
    ref, port = Side("ref"), Side("port")
    want = REFERENCE_CASES[case](ref)
    got = REFERENCE_CASES[case](port)
    assert got == want
    assert port.raised == ref.raised
    assert port.objects() == ref.objects()
    assert port.store._last_rv == ref.store._last_rv


# ------------------------------------------------------- beyond the cases
def cascade_honours_dependent_finalizers(s):
    """A dependent with a finalizer is marked deleting, not removed; its
    own dependents stay until it goes."""
    owner = s.store.create(mk("Notebook", "nb"))
    child = mk("StatefulSet", "nb")
    child["metadata"]["finalizers"] = ["example/fin"]
    s.k8s.set_controller_reference(owner, child)
    child = s.store.create(child)
    pod = mk("Pod", "nb-0")
    s.k8s.set_controller_reference(child, pod)
    s.store.create(pod)
    s.store.delete("Notebook", "default", "nb")
    assert s.k8s.is_deleting(s.store.get("StatefulSet", "default", "nb"))
    assert s.store.get("Pod", "default", "nb-0")
    cur = s.store.get("StatefulSet", "default", "nb")
    cur["metadata"]["finalizers"] = []
    s.store.update(cur)
    s.raises("NotFoundError", s.store.get, "Pod", "default", "nb-0")


def list_orders_by_namespace_and_name_and_filters_labels(s):
    for ns, name, team in (("b", "x", "red"), ("a", "z", "red"),
                           ("a", "y", "blue"), ("b", "w", None)):
        labels = {"team": team} if team else {}
        s.store.create(mk("ConfigMap", name, ns,
                          metadata={"name": name, "namespace": ns,
                                    "labels": labels}))
    every = [(s.k8s.namespace(o), s.k8s.name(o))
             for o in s.store.list("ConfigMap")]
    assert every == [("a", "y"), ("a", "z"), ("b", "w"), ("b", "x")]
    red = [s.k8s.name(o) for o in s.store.list("ConfigMap", None,
                                               {"team": "red"})]
    labelled = [s.k8s.name(o) for o in s.store.list("ConfigMap", "a",
                                                    {"team": None})]
    return every, red, labelled


def admission_runs_before_persisting(s):
    """A registered admission plugin sees CREATE and UPDATE (with the old
    object) and its answer is what is stored; a raise refuses the write."""
    calls = []

    def admit(operation, obj, old):
        calls.append((operation, old is None))
        if obj.get("data", {}).get("refuse"):
            raise s.errors.InvalidError("refused")
        obj.setdefault("metadata", {}).setdefault("labels", {})["admitted"] \
            = "yes"
        return obj
    s.store.register_admission("ConfigMap", admit)
    out = s.store.create(mk("ConfigMap", "a"))
    assert out["metadata"]["labels"] == {"admitted": "yes"}
    out["data"] = {"refuse": "1"}
    s.raises("InvalidError", s.store.update, out)
    s.store.create(mk("Secret", "untouched"))
    return calls


def unwatch_stops_delivery_and_namespace_filters(s):
    seen, scoped = [], []
    s.store.watch("ConfigMap", seen.append)
    s.store.watch("ConfigMap", scoped.append, namespace="other")
    s.store.create(mk("ConfigMap", "a"))
    s.store.unwatch(seen.append)
    s.store.create(mk("ConfigMap", "b"))
    s.store.create(mk("ConfigMap", "c", "other"))
    return ([s.k8s.name(e.obj) for e in seen],
            [s.k8s.name(e.obj) for e in scoped])


EXTRA_CASES = {fn.__name__: fn for fn in (
    cascade_honours_dependent_finalizers,
    list_orders_by_namespace_and_name_and_filters_labels,
    admission_runs_before_persisting,
    unwatch_stops_delivery_and_namespace_filters)}


@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
def test_store_semantics_on_both_stores(case):
    ref, port = Side("ref"), Side("port")
    want = EXTRA_CASES[case](ref)
    got = EXTRA_CASES[case](port)
    assert got == want
    assert port.raised == ref.raised
    assert port.objects() == ref.objects()
    assert port.store._last_rv == ref.store._last_rv
