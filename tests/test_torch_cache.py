"""The port's read path held against the reference's: ``cluster/cache.py``
(``CachingClient``, its transforms and indexes) and ``cluster/echo.py``
(``EchoTrackingClient``), case for case on the same inputs.

- the six in-process cases of tests/test_cache_index.py (the four
  pagination and wire cases wait for the store's wire parts, ROADMAP.md
  queue A item 8): both caches fed the same randomized population and
  traffic give the same answers, each equal to a scan of its store, and
  count the same index lookups and full scans;
- every case of tests/test_cache_transforms.py, on both modules;
- the three of tests/test_event_driven_boot.py (the simulator's boot
  timer under a manager that reads through the cache);
- the echo client: both see the same event sequence and make the same
  drop decisions (their own write, a foreign later rv, a DELETED event,
  and the in-process store's inline delivery, which fails open), and
  both attribute each verb to the same reconcile phase.

Every ``start()`` stops in a ``finally``; every wait has a timeout.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

from kubeflow_tpu.cluster import cache as ref_cache
from kubeflow_tpu.cluster import echo as ref_echo
from kubeflow_tpu.cluster import kubelet as ref_kubelet
from kubeflow_tpu.cluster import store as ref_store
from kubeflow_tpu.controllers import manager as ref_manager
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu.utils import metrics as ref_metrics
from kubeflow_tpu_torch.cluster import cache, echo, kubelet, store
from kubeflow_tpu_torch.controllers import manager
from kubeflow_tpu_torch.utils import k8s, metrics

SIDES = {
    "ref": SimpleNamespace(cache=ref_cache, echo=ref_echo, store=ref_store,
                           kubelet=ref_kubelet, manager=ref_manager,
                           k8s=ref_k8s, metrics=ref_metrics),
    "port": SimpleNamespace(cache=cache, echo=echo, store=store,
                            kubelet=kubelet, manager=manager, k8s=k8s,
                            metrics=metrics),
}


def both(case):
    """``case(side)`` for the reference and the port; the two results,
    which must be equal."""
    got = {name: case(side) for name, side in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# ------------------------------------------ tests/test_cache_index.py
KINDS = ("StatefulSet", "Pod", "Service")
NAMESPACES = ("ns-a", "ns-b", "ns-c")
OWNERS = ("uid-owner-1", "uid-owner-2", "uid-owner-3")
# first two are indexed by default; the third never is
LABELS = ("notebook-name", "statefulset", "team")
VALUES = ("v0", "v1", "v2")


def _rand_obj(rng: random.Random, i: int, namespace=None) -> dict:
    labels = {key: rng.choice(VALUES)
              for key in LABELS if rng.random() < 0.5}
    obj = {
        "apiVersion": "v1", "kind": rng.choice(KINDS),
        "metadata": {
            "name": f"obj-{i}",
            "namespace": namespace or rng.choice(NAMESPACES),
            "labels": labels,
        },
        "spec": {"n": i},
    }
    if rng.random() < 0.6:
        obj["metadata"]["ownerReferences"] = [{
            "kind": "Notebook", "name": "own", "controller": True,
            "uid": rng.choice(OWNERS)}]
    return obj


def _queries(rng: random.Random):
    """Every selector shape the controllers use, plus adversarial mixes."""
    return [
        (rng.choice(NAMESPACES), None),
        (None, None),
        (None, {"notebook-name": rng.choice(VALUES)}),     # indexed eq
        (None, {"notebook-name": None}),                   # indexed exists
        (rng.choice(NAMESPACES), {"statefulset": rng.choice(VALUES)}),
        (None, {"team": rng.choice(VALUES)}),              # unindexed eq
        (rng.choice(NAMESPACES), {"team": None}),          # unindexed exists
        (None, {"notebook-name": rng.choice(VALUES),       # mixed
                "team": rng.choice(VALUES)}),
    ]


def _naive(side, st, kind, namespace, selector):
    """The full-scan semantics, straight off the source of truth."""
    return sorted(
        side.k8s.name(o) for o in st.list(kind)
        if (namespace is None or side.k8s.namespace(o) == namespace)
        and side.k8s.matches_labels(o, selector))


def _names(side, objs):
    return sorted(side.k8s.name(o) for o in objs)


def test_indexed_list_equals_scan_on_randomized_population():
    def case(side):
        answers = []
        for seed in (3, 5, 8):
            rng = random.Random(seed)
            st = side.store.ClusterStore()
            client = side.cache.CachingClient(st, disable_for=())
            for i in range(120):
                st.create(_rand_obj(rng, i))
            for kind in KINDS:
                for namespace, selector in _queries(rng):
                    got = _names(side, client.list(kind, namespace,
                                                   selector))
                    assert got == _naive(side, st, kind, namespace,
                                         selector)
                    answers.append(got)
        return answers
    both(case)


def test_list_by_field_equals_field_scan():
    """The by-field lookup (``spec.nodeName``) returns the filtered-scan
    set, stays coherent across an update and a delete, and serves an
    unindexed path through one counted full scan."""
    def case(side):
        rng = random.Random(11)
        st = side.store.ClusterStore()
        client = side.cache.CachingClient(st, disable_for=())
        registry = side.metrics.MetricsRegistry()
        client.attach_metrics(registry)
        nodes = [f"node-{i}" for i in range(5)]
        for i in range(60):
            obj = _rand_obj(rng, i)
            if rng.random() < 0.8:
                obj["spec"]["nodeName"] = rng.choice(nodes)
            st.create(obj)

        def naive(kind, node):
            return sorted(side.k8s.name(o) for o in st.list(kind)
                          if side.k8s.get_in(o, "spec", "nodeName") == node)

        answers = []
        for kind in KINDS:
            for node in nodes:
                got = _names(side, client.list_by_field(
                    kind, "spec.nodeName", node))
                assert got == naive(kind, node)
                answers.append(got)
        moved = next(o for o in st.list("Pod")
                     if side.k8s.get_in(o, "spec", "nodeName") == nodes[0])
        moved["spec"]["nodeName"] = nodes[1]
        st.update(moved)
        victim = next((o for o in st.list("Pod")
                       if side.k8s.get_in(o, "spec", "nodeName") == nodes[1]
                       and side.k8s.name(o) != side.k8s.name(moved)), None)
        if victim is not None:
            st.delete("Pod", side.k8s.namespace(victim),
                      side.k8s.name(victim))
        for node in nodes[:2]:
            got = _names(side, client.list_by_field("Pod", "spec.nodeName",
                                                    node))
            assert got == naive("Pod", node)
            answers.append(got)
        scans = registry.counter("cache_full_scans_total", "")
        before = scans.total()
        lookups = registry.counter("cache_index_lookups_total", "").get(
            {"kind": "Pod", "index": "by-field"})
        assert lookups > 0
        assert client.list_by_field("Pod", "spec.hostname", "nope") == []
        assert scans.total() == before + 1
        return answers, lookups, before
    both(case)


def test_get_owned_equals_ownership_scan():
    def case(side):
        rng = random.Random(21)
        st = side.store.ClusterStore()
        client = side.cache.CachingClient(st, disable_for=())
        for i in range(80):
            st.create(_rand_obj(rng, i))
        answers = []
        for kind in KINDS:
            for uid in OWNERS:
                owner = {"kind": "Notebook",
                         "metadata": {"name": "own", "uid": uid}}
                got = _names(side, client.get_owned(kind, owner))
                assert got == sorted(side.k8s.name(o) for o in st.list(kind)
                                     if side.k8s.is_owned_by(o, uid))
                answers.append(got)
        return answers
    both(case)


def _integrity(client) -> None:
    """Every index entry points at a live object, and every object
    appears in exactly the indexes its fields imply."""
    for kind, ks in client._kinds.items():
        for ns, keys in ks.by_namespace.items():
            assert keys, f"empty {kind} namespace bucket leaked"
            for key in keys:
                assert key in ks.objects and key[0] == ns
        for uid, keys in ks.by_owner.items():
            assert keys
            for key in keys:
                assert uid in [r.get("uid") for r in
                               ks.objects[key]["metadata"].get(
                                   "ownerReferences", [])]
        for lk, buckets in ks.by_label.items():
            for val, keys in buckets.items():
                assert keys, f"empty {kind} label bucket {lk}={val} leaked"
                for key in keys:
                    assert ks.objects[key]["metadata"]["labels"][lk] == val
        for key, obj in ks.objects.items():
            assert key in ks.by_namespace[key[0]]
            for lk in ks.label_keys:
                val = (obj["metadata"].get("labels") or {}).get(lk)
                if val is not None:
                    assert key in ks.by_label[lk][val]


def test_index_consistency_under_interleaved_ingest_delete_tombstone():
    """Random interleavings of the watch-feed traffic (ADDED, MODIFIED
    with label and owner churn, DELETED, a stale snapshot racing a
    delete, an older rv re-fed, write-through ingest): after every burst
    both caches answer every query as a scan of their store does, and
    their indexes are coherent."""
    def case(side):
        answers = []
        for seed in (2, 9):
            rng = random.Random(seed)
            st = side.store.ClusterStore()
            client = side.cache.CachingClient(st, auto_informer=False,
                                              disable_for=())
            for kind in KINDS:
                client.backfill(kind)
            live: dict[str, dict] = {}
            for step in range(300):
                roll = rng.random()
                if roll < 0.45 or not live:
                    obj = st.create(_rand_obj(rng, step))
                    live[side.k8s.name(obj)] = obj
                    client.feed(side.store.WatchEvent("ADDED", obj))
                elif roll < 0.7:
                    name = rng.choice(sorted(live))
                    obj = side.k8s.deepcopy(live[name])
                    obj["metadata"]["labels"] = {
                        key: rng.choice(VALUES)
                        for key in LABELS if rng.random() < 0.5}
                    obj["metadata"]["ownerReferences"] = [{
                        "kind": "Notebook", "name": "own",
                        "controller": True, "uid": rng.choice(OWNERS)}] \
                        if rng.random() < 0.7 else []
                    obj = st.update(obj)
                    live[name] = obj
                    if rng.random() < 0.8:
                        client.feed(side.store.WatchEvent("MODIFIED", obj))
                    else:
                        client._ingest_write(obj)
                elif roll < 0.85:
                    name = rng.choice(sorted(live))
                    obj = live.pop(name)
                    st.delete(obj["kind"], side.k8s.namespace(obj), name)
                    client.feed(side.store.WatchEvent("DELETED", obj))
                    if rng.random() < 0.5:
                        client._ingest(side.k8s.deepcopy(obj))
                else:
                    name = rng.choice(sorted(live))
                    stale = side.k8s.deepcopy(live[name])
                    stale["metadata"]["resourceVersion"] = "1"
                    stale["metadata"]["labels"] = {"team": "stale"}
                    client.feed(side.store.WatchEvent("MODIFIED", stale))
                if step % 50 == 49:
                    _integrity(client)
                    for kind in KINDS:
                        for namespace, selector in _queries(rng):
                            got = _names(side, client.list(kind, namespace,
                                                           selector))
                            assert got == _naive(side, st, kind, namespace,
                                                 selector)
                            answers.append(got)
            _integrity(client)
        return answers
    both(case)


def test_scan_vs_index_accounting():
    def case(side):
        st = side.store.ClusterStore()
        client = side.cache.CachingClient(st, disable_for=())
        registry = side.metrics.MetricsRegistry()
        client.attach_metrics(registry)
        st.create(_rand_obj(random.Random(1), 0, namespace="ns-a"))
        scans = registry.counter("cache_full_scans_total", "")
        lookups = registry.counter("cache_index_lookups_total", "")
        client.list("Pod", "ns-a")                          # by-namespace
        client.list("Pod", None, {"notebook-name": "v0"})   # by-label
        client.list("Pod", None, {"notebook-name": None})   # by-label exists
        client.list("Pod")                                  # all
        client.get_owned("Pod", {"metadata": {"uid": "uid-owner-1"}})
        assert scans.total() == 0
        counts = {index: lookups.get({"kind": "Pod", "index": index})
                  for index in ("by-namespace", "by-label", "all",
                                "by-owner")}
        assert counts == {"by-namespace": 1, "by-label": 2, "all": 1,
                          "by-owner": 1}
        # the one unindexable shape: no namespace, no indexed label key
        client.list("Pod", None, {"team": "v0"})
        assert scans.total() == 1
        return counts
    both(case)


def test_watch_gap_serves_live_until_recovered():
    def case(side):
        st = side.store.ClusterStore()
        client = side.cache.CachingClient(st, auto_informer=False,
                                          disable_for=())
        created = st.create({"kind": "Pod", "apiVersion": "v1",
                             "metadata": {"name": "p", "namespace": "ns"}})
        client.backfill("Pod")
        # the stream drops: a delete the cache never hears about
        st.delete("Pod", "ns", "p")
        seen = [_names(side, client.list("Pod", "ns"))]     # stale
        client.mark_watch_gap("Pod")
        seen.append(client.list("Pod", "ns"))               # live
        assert client.get_or_none("Pod", "ns", "p") is None
        assert client.get_owned("Pod", {"metadata": {
            "uid": "x", "namespace": "ns"}}) == []
        # the resync delivers the missed DELETED, then recovery
        client.feed(side.store.WatchEvent("DELETED", created))
        client.mark_watch_recovered("Pod")
        seen.append(client.list("Pod", "ns"))
        # overlapping gaps: live until the last stream recovers
        client.mark_watch_gap("Pod")
        client.mark_watch_gap("Pod")
        client.mark_watch_recovered("Pod")
        gapped = [client._is_gapped("Pod")]
        client.mark_watch_recovered("Pod")
        gapped.append(client._is_gapped("Pod"))
        assert seen == [["p"], [], []] and gapped == [True, False]
        return seen, gapped
    both(case)


# -------------------------------------- tests/test_cache_transforms.py
def secret(**meta):
    return {"kind": "Secret", "apiVersion": "v1", "type": "Opaque",
            "metadata": {"name": "s", "namespace": "ns", **meta},
            "data": {"password": "aHVudGVyMg=="},
            "stringData": {"token": "plaintext"}}


def configmap(**meta):
    return {"kind": "ConfigMap", "apiVersion": "v1",
            "metadata": {"name": "cm", "namespace": "ns", **meta},
            "data": {"config.yaml": "a: 1"},
            "binaryData": {"blob": "AAAA"}}


class TestStripSecretData:
    def test_strips_data_stringdata_managedfields(self):
        out = both(lambda s: s.cache.strip_secret_data(
            secret(managedFields=[{"manager": "kubectl"}])))
        assert "data" not in out and "stringData" not in out
        assert "managedFields" not in out["metadata"]

    def test_handles_missing_payload_fields(self):
        out = both(lambda s: s.cache.strip_secret_data(
            {"kind": "Secret", "metadata": {"name": "s"}}))
        assert out["kind"] == "Secret"

    def test_passes_through_non_secret_unchanged(self):
        pod = {"kind": "Pod", "metadata": {"name": "p"},
               "data": {"keep": "me"}}
        assert both(lambda s: s.cache.strip_secret_data(pod) is pod)

    def test_handles_missing_annotations_without_error(self):
        assert "data" not in both(lambda s: s.cache.strip_secret_data(
            secret()))

    def test_strips_last_applied_preserving_others(self):
        def case(s):
            return s.cache.strip_secret_data(secret(annotations={
                s.cache.LAST_APPLIED_ANNOTATION: '{"huge": "payload"}',
                "keep.me/here": "yes"}))["metadata"]["annotations"]
        assert both(case) == {"keep.me/here": "yes"}

    def test_preserves_labels_annotations_and_type(self):
        out = both(lambda s: s.cache.strip_secret_data(
            secret(labels={"app": "x"}, annotations={"a": "b"})))
        assert out["metadata"]["labels"] == {"app": "x"}
        assert out["metadata"]["annotations"] == {"a": "b"}
        assert out["type"] == "Opaque"

    def test_original_object_not_mutated(self):
        def case(s):
            original = secret(managedFields=[{"m": 1}])
            s.cache.strip_secret_data(original)
            return original
        original = both(case)
        assert "data" in original and "managedFields" in original["metadata"]


class TestStripConfigMapData:
    def test_strips_data_binarydata_managedfields(self):
        out = both(lambda s: s.cache.strip_configmap_data(
            configmap(managedFields=[{"manager": "kubectl"}])))
        assert "data" not in out and "binaryData" not in out
        assert "managedFields" not in out["metadata"]

    def test_handles_missing_payload_fields(self):
        assert both(lambda s: s.cache.strip_configmap_data(
            {"kind": "ConfigMap", "metadata": {"name": "cm"}}))["kind"] == \
            "ConfigMap"

    def test_passes_through_non_configmap_unchanged(self):
        svc = {"kind": "Service", "metadata": {"name": "s"},
               "data": {"keep": "me"}}
        assert both(lambda s: s.cache.strip_configmap_data(svc) is svc)

    def test_strips_last_applied_preserving_others(self):
        def case(s):
            return s.cache.strip_configmap_data(configmap(annotations={
                s.cache.LAST_APPLIED_ANNOTATION: "x" * 10_000,
                "opendatahub.io/managed-by": "workbenches"}))[
                "metadata"]["annotations"]
        assert both(case) == {"opendatahub.io/managed-by": "workbenches"}

    def test_preserves_labels_and_annotations(self):
        out = both(lambda s: s.cache.strip_configmap_data(
            configmap(labels={"l": "v"}, annotations={"a": "b"})))
        assert out["metadata"]["labels"] == {"l": "v"}
        assert out["metadata"]["annotations"] == {"a": "b"}


class TestCachingClientGuarantee:
    def test_cached_watch_path_strips_but_reads_stay_live(self):
        def case(s):
            st = s.store.ClusterStore()
            client = s.cache.CachingClient(st)
            st.create(secret())
            return client.get("Secret", "ns", "s")["data"]
        assert both(case) == {"password": "aHVudGVyMg=="}

    def test_managed_fields_never_reach_cache_consumers(self):
        def case(s):
            st = s.store.ClusterStore()
            client = s.cache.CachingClient(st, disable_for=())
            st.create({"kind": "ConfigMap", "apiVersion": "v1",
                       "metadata": {"name": "cm", "namespace": "ns",
                                    "managedFields": [{"manager": "x"}],
                                    "annotations": {
                                        s.cache.LAST_APPLIED_ANNOTATION: "{}",
                                        "keep": "me"}},
                       "data": {"k": "v"}})
            (obj,) = client.list("ConfigMap", "ns")
            return ("data" in obj, "managedFields" in obj["metadata"],
                    obj["metadata"]["annotations"])
        assert both(case) == (False, False, {"keep": "me"})


class TestWriteThroughIngest:
    def test_create_response_visible_before_watch_event(self):
        def case(s):
            st = s.store.ClusterStore()
            client = s.cache.CachingClient(st, auto_informer=False,
                                           disable_for=("ConfigMap",))
            client.backfill("ConfigMap")  # warm, empty
            client.create({"kind": "ConfigMap", "apiVersion": "v1",
                           "metadata": {"name": "cm", "namespace": "ns"},
                           "data": {"k": "v"}})
            return client.get("ConfigMap", "ns", "cm")["data"]
        assert both(case) == {"k": "v"}

    def test_late_update_response_does_not_resurrect_deleted_object(self):
        def case(s):
            st = s.store.ClusterStore()
            client = s.cache.CachingClient(st, auto_informer=False,
                                           disable_for=())
            client.backfill("ConfigMap")
            created = client.create({"kind": "ConfigMap", "apiVersion": "v1",
                                     "metadata": {"name": "cm",
                                                  "namespace": "ns"}})
            updated = st.update(created)
            client.feed(s.store.WatchEvent("DELETED", updated))
            client._ingest_write(updated)
            return client.get_or_none("ConfigMap", "ns", "cm")
        assert both(case) is None

    def test_create_after_delete_is_a_genuine_recreate(self):
        def case(s):
            st = s.store.ClusterStore()
            client = s.cache.CachingClient(st, auto_informer=False,
                                           disable_for=())
            client.backfill("ConfigMap")
            created = client.create({"kind": "ConfigMap", "apiVersion": "v1",
                                     "metadata": {"name": "cm",
                                                  "namespace": "ns"}})
            client.feed(s.store.WatchEvent("DELETED", created))
            st.delete("ConfigMap", "ns", "cm")
            client.create({"kind": "ConfigMap", "apiVersion": "v1",
                           "metadata": {"name": "cm", "namespace": "ns"}})
            return client.get_or_none("ConfigMap", "ns", "cm") is not None
        assert both(case)


class TestIndexedIngest:
    @staticmethod
    def _pod(name, labels=None, owner_uid=None, rv="1"):
        obj = {"kind": "Pod", "apiVersion": "v1",
               "metadata": {"name": name, "namespace": "ns",
                            "resourceVersion": rv,
                            "labels": dict(labels or {})}}
        if owner_uid:
            obj["metadata"]["ownerReferences"] = [
                {"kind": "Notebook", "name": "own", "controller": True,
                 "uid": owner_uid}]
        return obj

    @staticmethod
    def _client(s):
        client = s.cache.CachingClient(s.store.ClusterStore(),
                                       auto_informer=False, disable_for=())
        client.backfill("Pod")
        return client

    def test_relabel_moves_between_index_buckets(self):
        def case(s):
            client = self._client(s)
            ev = s.store.WatchEvent
            client.feed(ev("ADDED", self._pod(
                "p", labels={"notebook-name": "a"}, owner_uid="u1", rv="1")))
            seen = [_names(s, client.list("Pod", None,
                                          {"notebook-name": "a"}))]
            client.feed(ev("MODIFIED", self._pod(
                "p", labels={"notebook-name": "b"}, owner_uid="u2", rv="2")))
            seen += [_names(s, client.list("Pod", None, {"notebook-name": v}))
                     for v in ("a", "b")]
            seen += [_names(s, client.get_owned("Pod", {"metadata": {
                "uid": u}})) for u in ("u1", "u2")]
            return seen
        assert both(case) == [["p"], [], ["p"], [], ["p"]]

    def test_tombstoned_snapshot_never_reaches_an_index(self):
        def case(s):
            client = self._client(s)
            pod = self._pod("p", labels={"notebook-name": "a"},
                            owner_uid="u1")
            client.feed(s.store.WatchEvent("ADDED", pod))
            client.feed(s.store.WatchEvent("DELETED", pod))
            client._ingest(pod)  # stale snapshot racing the delete
            return (client.list("Pod", "ns"),
                    client.list("Pod", None, {"notebook-name": "a"}),
                    client.get_owned("Pod", {"metadata": {"uid": "u1"}}))
        assert both(case) == ([], [], [])

    def test_stale_rv_refeed_does_not_reindex(self):
        def case(s):
            client = self._client(s)
            client.feed(s.store.WatchEvent("ADDED", self._pod(
                "p", labels={"notebook-name": "new"}, rv="5")))
            client.feed(s.store.WatchEvent("MODIFIED", self._pod(
                "p", labels={"notebook-name": "old"}, rv="3")))
            return [_names(s, client.list("Pod", None, {"notebook-name": v}))
                    for v in ("new", "old")]
        assert both(case) == [["p"], []]


# ------------------------------------- tests/test_event_driven_boot.py
def _sts(name, replicas=1):
    return {"apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": name, "namespace": "d"},
            "spec": {"replicas": replicas, "serviceName": name,
                     "selector": {"matchLabels": {"statefulset": name}},
                     "template": {
                         "metadata": {"labels": {"statefulset": name}},
                         "spec": {"containers": [
                             {"name": "c", "image": "i"}]}}}}


def _wait(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return False


def test_event_driven_boot_marks_ready_without_polling_requeues():
    def case(s):
        st = s.store.ClusterStore()
        client = s.cache.CachingClient(st, auto_informer=False,
                                       disable_for=())
        # the reference's case turns its error limiter off; no reconcile
        # here fails, so the port's limiter never acts
        kw = {"rate_limiter": False} if s is SIDES["ref"] else {}
        mgr = s.manager.Manager(client, read_cache=client, **kw)
        sim = s.kubelet.StatefulSetSimulator(
            client, boot_delay_s=0.15, manage_nodes=False,
            event_driven_boot=True)
        sim.setup(mgr)
        mgr.start()
        try:
            t0 = time.monotonic()
            st.create(_sts("ev"))
            assert _wait(lambda: s.k8s.condition_true(
                st.get_or_none("Pod", "d", "ev-0") or {}, "Ready"))
            # readiness came from the boot timer at ~boot_delay, not from
            # a safety-net requeue (2 x boot_delay at the earliest)
            assert time.monotonic() - t0 >= 0.14
        finally:
            mgr.stop()
        return s.k8s.condition_true(st.get("Pod", "d", "ev-0"), "Ready")
    assert both(case)


def test_event_driven_boot_skips_vanished_and_already_ready_pods():
    def case(s):
        st = s.store.ClusterStore()
        sim = s.kubelet.StatefulSetSimulator(
            st, boot_delay_s=0.05, manage_nodes=False,
            event_driven_boot=True)
        # scheduling a pod that never exists is a no-op, not a crash
        sim._boot_scheduler.schedule(time.monotonic(), "d", "ghost-0")
        time.sleep(0.2)
        return st.get_or_none("Pod", "d", "ghost-0")
    assert both(case) is None


def test_ready_hook_disables_the_event_path():
    """A ready hook's answer can change between polls, so the one-shot
    timer must not own readiness: hooked simulators keep the polled
    path."""
    assert both(lambda s: s.kubelet.StatefulSetSimulator(
        s.store.ClusterStore(), boot_delay_s=0.1,
        ready_hook=lambda pod: True, manage_nodes=False,
        event_driven_boot=True)._boot_scheduler) is None


# ------------------------------------------------------- cluster/echo.py
def _echo_decisions(s):
    """The same write and event sequence through ``s``'s echo client;
    each drop decision (True = dropped as our own echo)."""
    st = s.store.ClusterStore()
    client = s.echo.EchoTrackingClient(st)
    inline: list = []
    events: list = []

    def on_pod(event):
        events.append(event)
        # the in-process store delivers before the write returns: the
        # record is not there yet, so the predicate fails open
        inline.append(client.is_echo(event))
    st.watch("Pod", on_pod)
    pod = {"kind": "Pod", "apiVersion": "v1",
           "metadata": {"name": "p", "namespace": "ns"}}
    client.create(pod)                                   # our write
    client.patch("Pod", "ns", "p", {"metadata": {"labels": {"a": "1"}}})
    st.patch("Pod", "ns", "p", {"metadata": {"labels": {"b": "2"}}})
    client.delete("Pod", "ns", "p")                      # DELETED
    decisions = [client.is_echo(e) for e in events]
    assert decisions == [True, True, False, False]
    assert inline == [False] * 4
    assert [client.not_echo(e) for e in events] == \
        [not d for d in decisions]
    # an rv-less object is never an echo; Events are never recorded
    assert not client.is_echo(s.store.WatchEvent("MODIFIED", {
        "kind": "Pod", "metadata": {"name": "p", "namespace": "ns"}}))
    ev = client.create({"kind": "Event", "apiVersion": "v1",
                        "metadata": {"name": "e.1", "namespace": "ns"}})
    assert not client.is_echo(s.store.WatchEvent("ADDED", ev))
    return [e.type for e in events], decisions, inline


def test_echo_drops_exactly_its_own_writes():
    assert both(_echo_decisions)[0] == ["ADDED", "MODIFIED", "MODIFIED",
                                        "DELETED"]


def test_echo_keeps_the_newest_rvs_per_object():
    """Past ``RVS_PER_KEY`` writes of one object only the newest are
    remembered: the oldest write's echo is delivered (fails open)."""
    def case(s):
        st = s.store.ClusterStore()
        client = s.echo.EchoTrackingClient(st)
        events: list = []
        st.watch("Pod", events.append)
        client.create({"kind": "Pod", "apiVersion": "v1",
                       "metadata": {"name": "p", "namespace": "ns"}})
        for i in range(s.echo.EchoTrackingClient.RVS_PER_KEY):
            client.patch("Pod", "ns", "p",
                         {"metadata": {"labels": {"i": str(i)}}})
        return [client.is_echo(e) for e in events]
    assert both(case) == [False, True, True, True, True]


def test_echo_attributes_verbs_to_reconcile_phases():
    """Reads and writes through the echo client land in the phase
    collector the manager turns into reconcile_read_seconds and
    reconcile_write_seconds; outside a window they are not kept."""
    def case(s):
        client = s.echo.EchoTrackingClient(s.store.ClusterStore())
        client.get_or_none("Pod", "ns", "p")                 # outside
        s.metrics.phase_collect_start()
        client.create({"kind": "Pod", "apiVersion": "v1",
                       "metadata": {"name": "p", "namespace": "ns"}})
        client.list("Pod", "ns")
        client.get_owned("Pod", {"metadata": {"uid": "u",
                                              "namespace": "ns"}})
        phases = s.metrics.phase_collect_finish()
        return sorted(phases), all(v > 0 for v in phases.values()), \
            s.metrics.phase_collect_finish()
    assert both(case) == (["read", "write"], True, {})


@pytest.mark.parametrize("controller_reads", ["cached", "live"])
def test_manager_observes_read_and_write_phases(controller_reads):
    """Both managers observe one read and one write sample a reconcile
    for a reconciler whose client is the echo client, over a read cache
    or the live store."""
    def case(s):
        st = s.store.ClusterStore()
        client = s.cache.CachingClient(st, auto_informer=False,
                                       disable_for=()) \
            if controller_reads == "cached" else st
        mgr = s.manager.Manager(
            client, read_cache=client if controller_reads == "cached"
            else None)
        registry = s.metrics.MetricsRegistry()
        mgr.attach_metrics(registry)
        echo_client = s.echo.EchoTrackingClient(client)

        class Rec:
            name = "rec"

            def reconcile(self, req):
                pod = echo_client.get("Pod", req.namespace, req.name)
                if s.k8s.get_label(pod, "seen") is None:
                    echo_client.patch("Pod", req.namespace, req.name, {
                        "metadata": {"labels": {"seen": "1"}}})
                return None

        mgr.register(Rec())
        mgr.watch("Pod", "rec", predicate=echo_client.not_echo)
        st.create({"kind": "Pod", "apiVersion": "v1",
                   "metadata": {"name": "p", "namespace": "ns"}})
        mgr.run_until_idle(timeout=5.0)
        expo = registry.expose()
        return sorted(line.split(" ")[0] + " " + line.split(" ")[1]
                      for line in expo.splitlines()
                      if line.startswith(("reconcile_read_seconds_count",
                                          "reconcile_write_seconds_count")))
    counts = both(case)
    assert counts and all(line.endswith(" 2") for line in counts)
