"""The port's event recording and re-emission held against the
reference's, case for case.

Every case of tests/test_events.py runs through both stacks
(``torch_parity.Stack``: store, Manager and NotebookReconciler) with
each side's ``EventRecorder``: creation and aggregation, StatefulSet and
Pod events re-issued on the Notebook, the unrelated and foreign ones
ignored, no re-emission loop, long names, deleted pods, the TTL prune
and the extension's ``MLflowClusterRolePending`` warning from each
side's ``rbac`` module. Each side makes the case's own
assertions; then every object of both stores (the Events by their
aggregation names) is compared after ``normalise``, and so are the
writes and the reconciles of each drain. The TTL case ages events with
the recorder's injected clock instead of sleeping out a second.
"""

from __future__ import annotations

import time

import pytest

from kubeflow_tpu.cluster import events as ref_events
from kubeflow_tpu_torch.cluster import events
from torch_parity import Stack, assert_parity

EVENTS = {"ref": ref_events, "port": events}


def _notebook_events(s, ns, nb_name):
    out = []
    for ev in s.store.list(EVENTS[s.side].EVENT_KIND, ns):
        inv = ev.get("involvedObject", {})
        if inv.get("kind") == s.api.KIND and inv.get("name") == nb_name:
            out.append(ev)
    return out


def _with_notebook(s, name="mynb"):
    s.reconciler()
    s.store.create(s.api.new_notebook(name, "ns"))
    s.drain()


def recorder_creates_and_aggregates(s):
    ev = EVENTS[s.side]
    nb = s.store.create(s.api.new_notebook("mynb", "ns"))
    rec = ev.EventRecorder(s.store)
    first = rec.eventf(nb, ev.TYPE_WARNING, "FailedScheduling",
                       "0/3 nodes available")
    assert first["count"] == 1
    assert first["involvedObject"]["uid"] == s.k8s.uid(nb)
    assert first["source"]["component"] == "notebook-controller"
    again = rec.eventf(nb, ev.TYPE_WARNING, "FailedScheduling",
                       "0/3 nodes available")
    assert again["count"] == 2
    assert s.k8s.name(again) == s.k8s.name(first)
    other = rec.eventf(nb, ev.TYPE_WARNING, "FailedScheduling",
                       "0/4 nodes available")
    assert other["count"] == 1
    assert s.k8s.name(other) != s.k8s.name(first)
    return [s.k8s.name(first), s.k8s.name(again), s.k8s.name(other)]


def sts_event_reemitted_on_notebook(s):
    ev = EVENTS[s.side]
    _with_notebook(s)
    sts = s.store.get("StatefulSet", "ns", "mynb")
    ev.EventRecorder(s.store, component="statefulset-controller").eventf(
        sts, ev.TYPE_WARNING, "FailedCreate", "pods \"mynb-0\" forbidden")
    s.drain()
    emitted = _notebook_events(s, "ns", "mynb")
    assert len(emitted) == 1
    assert emitted[0]["reason"] == "FailedCreate"
    assert emitted[0]["message"] == (
        'Reissued from statefulset/mynb: pods "mynb-0" forbidden')
    assert emitted[0]["type"] == ev.TYPE_WARNING


def pod_event_resolves_via_label(s):
    ev = EVENTS[s.side]
    _with_notebook(s)
    pod = s.store.create({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "mynb-0", "namespace": "ns",
                     "labels": {s.names.NOTEBOOK_NAME_LABEL: "mynb"}},
        "spec": {"containers": []},
    })
    ev.EventRecorder(s.store, component="kubelet").eventf(
        pod, ev.TYPE_NORMAL, "Pulled", "image pulled")
    s.drain()
    emitted = _notebook_events(s, "ns", "mynb")
    assert len(emitted) == 1
    assert emitted[0]["message"] == "Reissued from pod/mynb-0: image pulled"
    assert emitted[0]["type"] == ev.TYPE_NORMAL


def unrelated_events_ignored(s):
    ev = EVENTS[s.side]
    _with_notebook(s)
    stranger = s.store.create({
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": "not-a-notebook", "namespace": "ns"},
        "spec": {"replicas": 1},
    })
    ev.EventRecorder(s.store).eventf(stranger, ev.TYPE_WARNING,
                                     "FailedCreate", "boom")
    svc = s.store.get("Service", "ns", "mynb")
    ev.EventRecorder(s.store).eventf(svc, ev.TYPE_WARNING, "Unrelated",
                                     "nope")
    s.drain()
    assert _notebook_events(s, "ns", "mynb") == []


def reemission_does_not_loop(s):
    ev = EVENTS[s.side]
    _with_notebook(s)
    sts = s.store.get("StatefulSet", "ns", "mynb")
    rec = ev.EventRecorder(s.store, component="statefulset-controller")
    for _ in range(3):
        rec.eventf(sts, ev.TYPE_WARNING, "FailedCreate", "quota")
        s.drain()
    emitted = _notebook_events(s, "ns", "mynb")
    assert len(emitted) == 1
    assert emitted[0]["count"] == 3


def mlflow_pending_event(s):
    ev, rbac = EVENTS[s.side], s.ext.rbac
    nb = s.store.create(s.api.new_notebook(
        "mynb", "ns",
        annotations={s.names.MLFLOW_INSTANCE_ANNOTATION: "tracking"}))
    rec = ev.EventRecorder(s.store, component="extension-controller")
    delay = rbac.reconcile_mlflow_integration(s.store, nb, recorder=rec)
    assert delay == rbac.MLFLOW_REQUEUE_SECONDS
    emitted = _notebook_events(s, "ns", "mynb")
    assert len(emitted) == 1
    assert emitted[0]["reason"] == "MLflowClusterRolePending"
    assert emitted[0]["type"] == ev.TYPE_WARNING
    return delay


def sts_event_for_long_name_notebook(s):
    ev = EVENTS[s.side]
    long_name = "n" * 60
    _with_notebook(s, long_name)
    stss = [o for o in s.store.list("StatefulSet", "ns")
            if s.k8s.get_label(o, s.names.NOTEBOOK_NAME_LABEL) == long_name]
    assert len(stss) == 1 and s.k8s.name(stss[0]) != long_name
    ev.EventRecorder(s.store, component="statefulset-controller").eventf(
        stss[0], ev.TYPE_WARNING, "FailedCreate", "quota exceeded")
    s.drain()
    emitted = _notebook_events(s, "ns", long_name)
    assert len(emitted) == 1
    assert emitted[0]["reason"] == "FailedCreate"
    return s.k8s.name(stss[0])


def foreign_sts_sharing_notebook_name_ignored(s):
    ev = EVENTS[s.side]
    _with_notebook(s, "db")
    s.store.create(s.api.new_notebook("other", "ns"))
    s.drain()
    foreign = s.store.create({
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": "db-foreign", "namespace": "ns"},
        "spec": {"replicas": 1},
    })
    ev.EventRecorder(s.store).eventf(foreign, ev.TYPE_WARNING,
                                     "FailedCreate", "boom")
    s.drain()
    assert _notebook_events(s, "ns", "db") == []
    assert _notebook_events(s, "ns", "other") == []


def terminal_pod_event_survives_pod_deletion(s):
    ev = EVENTS[s.side]
    _with_notebook(s)
    ghost_pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "mynb-0", "namespace": "ns",
                     "uid": "ghost-uid"},
    }
    ev.EventRecorder(s.store, component="kubelet").eventf(
        ghost_pod, ev.TYPE_WARNING, "OOMKilled", "container killed")
    s.drain()
    emitted = _notebook_events(s, "ns", "mynb")
    assert len(emitted) == 1
    assert emitted[0]["reason"] == "OOMKilled"


def event_ttl_prune(s):
    ev = EVENTS[s.side]
    nb = s.store.create(s.api.new_notebook("mynb", "ns"))
    # the recorder's clock runs 2 s ahead: past RFC3339's one-second
    # granularity, so the first event is stale at the second's prune
    rec = ev.EventRecorder(s.store, ttl_seconds=0.0,
                           clock=lambda: time.time() + 2.0)
    rec.eventf(nb, ev.TYPE_NORMAL, "Old", "stale")
    rec._last_prune.clear()
    rec.eventf(nb, ev.TYPE_NORMAL, "New", "fresh")
    reasons = {e["reason"] for e in s.store.list(ev.EVENT_KIND, "ns")}
    assert reasons == {"New"}


def prune_spares_undatable_events_but_dates_microtime(s):
    ev = EVENTS[s.side]
    nb = s.store.create(s.api.new_notebook("mynb", "ns"))
    s.store.create({"kind": "Event", "apiVersion": "v1",
                    "metadata": {"name": "ext-no-ts", "namespace": "ns"},
                    "involvedObject": {"kind": "Notebook", "name": "mynb"},
                    "reason": "External"})
    s.store.create({"kind": "Event", "apiVersion": "v1",
                    "metadata": {"name": "ext-eventtime", "namespace": "ns"},
                    "involvedObject": {"kind": "Notebook", "name": "mynb"},
                    "reason": "ExternalMicroStale",
                    "eventTime": "2020-01-01T12:00:00.000000Z"})
    rec = ev.EventRecorder(s.store, ttl_seconds=60.0)
    rec._last_prune.clear()
    rec.eventf(nb, ev.TYPE_NORMAL, "New", "fresh")
    reasons = {e["reason"] for e in s.store.list(ev.EVENT_KIND, "ns")}
    assert "External" in reasons and "New" in reasons
    assert "ExternalMicroStale" not in reasons


def prune_falls_back_to_first_timestamp(s):
    ev = EVENTS[s.side]
    s.store.create({"kind": "Event", "apiVersion": "v1",
                    "metadata": {"name": "old-first-ts", "namespace": "ns"},
                    "involvedObject": {"kind": "Notebook", "name": "mynb"},
                    "reason": "OldFirst",
                    "firstTimestamp": "2020-01-01T00:00:00Z"})
    nb = s.store.create(s.api.new_notebook("mynb", "ns"))
    rec = ev.EventRecorder(s.store, ttl_seconds=60.0)
    rec._last_prune.clear()
    rec.eventf(nb, ev.TYPE_NORMAL, "New", "fresh")
    reasons = {e["reason"] for e in s.store.list(ev.EVENT_KIND, "ns")}
    assert "OldFirst" not in reasons and "New" in reasons


CASES = {fn.__name__: fn for fn in (
    recorder_creates_and_aggregates, sts_event_reemitted_on_notebook,
    pod_event_resolves_via_label, unrelated_events_ignored,
    reemission_does_not_loop, mlflow_pending_event,
    sts_event_for_long_name_notebook,
    foreign_sts_sharing_notebook_name_ignored,
    terminal_pod_event_survives_pod_deletion, event_ttl_prune,
    prune_spares_undatable_events_but_dates_microtime,
    prune_falls_back_to_first_timestamp)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_events_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    assert CASES[case](port) == CASES[case](ref)
    assert_parity(ref, port)
