"""The port's status mirroring held against the reference's, case for
case.

Every case of tests/test_status_mirroring.py (status initialisation,
readyReplicas from the StatefulSet, containerState from the notebook
container, pod conditions newest first, the unschedulable pod, SliceReady
over every worker of a v5e-16 / h100-32 slice and no status rewrite when
stable) runs through both stacks (``torch_parity.Stack``: store, Manager
and NotebookReconciler, no simulator), each side with the case's own
assertions on pods staged as the StatefulSet controller would create
them. Then every object of both stores is compared after ``normalise``,
and so are the writes and the reconciles of each drain.
"""

from __future__ import annotations

import pytest

from torch_parity import Stack, assert_parity

NS = "kubeflow-user"


def apply_nb(s, name="test", **kw):
    s.reconciler()
    s.store.create(s.api.new_notebook(name, NS, **kw))
    s.drain()
    return s.store.get(s.api.KIND, NS, name)


def stage_pod(s, nb_name, *, conditions=None, container_statuses=None,
              ordinal=0):
    """A pod as the StatefulSet controller would create it, with a staged
    status (the in-process store has no kubelet writing statuses)."""
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": f"{nb_name}-{ordinal}", "namespace": NS,
                        "labels": {s.names.NOTEBOOK_NAME_LABEL: nb_name,
                                   "statefulset": nb_name}},
           "spec": {"containers": [{"name": nb_name, "image": "img"}]},
           "status": {}}
    if conditions is not None:
        pod["status"]["conditions"] = conditions
    if container_statuses is not None:
        pod["status"]["containerStatuses"] = container_statuses
    existing = s.store.get_or_none("Pod", NS, pod["metadata"]["name"])
    if existing is not None:
        existing["status"] = pod["status"]
        return s.store.update(existing)
    return s.store.create(pod)


def reconciled_status(s, name="test"):
    s.store.patch(s.api.KIND, NS, name,
                  {"metadata": {"labels": {"touch": "x"}}})
    s.drain()
    return s.store.get(s.api.KIND, NS, name).get("status", {})


def slice_ready_of(s, status):
    return next(c for c in status["conditions"]
                if c["type"] == s.api.CONDITION_SLICE_READY)


def status_initialization(s):
    status = apply_nb(s)["status"]
    assert status["readyReplicas"] == 0
    assert status["containerState"] == {}
    (cond,) = status["conditions"]
    assert cond["type"] == s.api.CONDITION_SLICE_READY
    assert cond["status"] == "False"
    assert cond["reason"] == "WaitingForWorkers"


def ready_replicas_from_statefulset(s):
    apply_nb(s)
    sts = s.store.get("StatefulSet", NS, "test")
    sts["status"] = {"readyReplicas": 1, "replicas": 1}
    s.store.update(sts)
    assert reconciled_status(s)["readyReplicas"] == 1


def container_state_from_notebook_container(s):
    apply_nb(s)
    stage_pod(s, "test", container_statuses=[
        {"name": "istio-proxy", "state": {"waiting": {"reason": "Init"}}},
        {"name": "test",
         "state": {"running": {"startedAt": "2026-01-01T00:00:00Z"}}}])
    # only the container named after the CR is mirrored
    assert reconciled_status(s)["containerState"] == \
        {"running": {"startedAt": "2026-01-01T00:00:00Z"}}


def pod_conditions_mirrored_newest_first(s):
    apply_nb(s)
    stage_pod(s, "test", conditions=[
        {"type": "Running", "lastTransitionTime": "2022-08-30T01:10:30Z"},
        {"type": "Waiting", "reason": "PodInitializing",
         "lastTransitionTime": "2022-08-30T01:10:30Z"}])
    mirrored = [c for c in reconciled_status(s)["conditions"]
                if c["type"] != s.api.CONDITION_SLICE_READY]
    assert [c["type"] for c in mirrored] == ["Waiting", "Running"]


def unschedulable_pod_condition_mirrored(s):
    apply_nb(s)
    stage_pod(s, "test", conditions=[
        {"type": "PodScheduled", "status": "False",
         "reason": "Unschedulable",
         "message": "0/3 nodes are available: insufficient nvidia.com/gpu"}])
    status = reconciled_status(s)
    sched = next(c for c in status["conditions"]
                 if c["type"] == "PodScheduled")
    assert sched["reason"] == "Unschedulable"
    assert "nvidia.com/gpu" in sched["message"]
    assert slice_ready_of(s, status)["status"] == "False"


def slice_ready_requires_all_workers(s):
    apply_nb(s, annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")})
    ready = {"type": "Ready", "status": "True"}
    for i in range(3):
        stage_pod(s, "test", conditions=[ready], ordinal=i)
    cond = slice_ready_of(s, reconciled_status(s))
    assert cond["status"] == "False"
    assert cond["message"] == "3/4 workers ready"
    stage_pod(s, "test", conditions=[ready], ordinal=3)
    cond = slice_ready_of(s, reconciled_status(s))
    assert cond["status"] == "True"
    assert cond["reason"] == "AllWorkersReady"


def status_not_rewritten_when_stable(s):
    calls = []
    orig = s.store.update_status

    def spy(obj, **kw):
        if obj.get("kind") == s.api.KIND:
            calls.append(s.k8s.name(obj))
        return orig(obj, **kw)

    s.store.update_status = spy
    apply_nb(s)
    assert calls == ["test"]  # exactly one initial status write
    s.store.patch(s.api.KIND, NS, "test",
                  {"metadata": {"labels": {"touch": "1"}}})
    s.drain()
    assert calls == ["test"]  # stable status: no second write
    return calls


CASES = {fn.__name__: fn for fn in (
    status_initialization, ready_replicas_from_statefulset,
    container_state_from_notebook_container,
    pod_conditions_mirrored_newest_first,
    unschedulable_pod_condition_mirrored, slice_ready_requires_all_workers,
    status_not_rewritten_when_stable)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_status_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    assert CASES[case](port) == CASES[case](ref)
    assert_parity(ref, port)
