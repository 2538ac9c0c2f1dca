"""The port's HTTP apiserver held against the reference's, request for
request.

Each case below is a reference test's own body, run twice with the
reference's ``HttpApiClient`` (or plain ``http.client``): against the
reference's ``ApiServerProxy(ClusterStore())`` and against the port's
(``torch_wire.wire_case``). Both runs must pass the case's assertions,
and what the two servers answered must be equal after ``torch_wire``'s
normalisation: status codes, ``Content-Type``, ``Retry-After``, bodies
and watch frames, plus the store each case wrote (objects, last rv,
resume rings), its audit lines and the server's and store's exposition
lines. A case whose client runs a watch
thread races that thread's resync LISTs and stream against the test's
own writes, so there the watch thread's requests are left out of the
comparison and the rest, with the store, is compared.

Held here: the server cases of tests/test_http_transport.py (all but
the two that test the client), all 14 of tests/test_http_resilience.py,
all 7 of tests/test_consistent_reads.py and the three pagination cases
of tests/test_cache_index.py; then TLS on an openssl-minted certificate,
the REST mapper's table, and a seeded script of 300 raw requests through
``http.client`` whose answers must be equal in order.
"""

from __future__ import annotations

import http.client
import json
import shutil
import ssl
import subprocess

import numpy as np
import pytest

import test_cache_index as ref_cache_index
import test_consistent_reads as ref_reads
import test_http_resilience as ref_resilience
import test_http_transport as ref_transport
from kubeflow_tpu.cluster import apiserver as ref_apiserver
from kubeflow_tpu.cluster import errors as ref_errors
from kubeflow_tpu.cluster import restmapper as ref_restmapper
from kubeflow_tpu.utils import k8s
from kubeflow_tpu_torch.cluster import restmapper
from kubeflow_tpu_torch.cluster.store import CLUSTER_SCOPED_KINDS
from torch_wire import (SIDES, TIMEOUT, Tap, client_of, main_thread,
                        normalise_audit, normalise_exposition,
                        normalise_object, recorded_instances, run_both,
                        served, side_globals, store_state, wire_case)

SEED = 22


def _server_lines(registry) -> list[str]:
    """The server's and store's families of an exposition (the client's
    and the timing samples left out)."""
    return [ln for ln in normalise_exposition(registry.expose())
            if ln.split("{")[0].split(" ")[-1].startswith(
                ("apf_", "watch_", "store_", "apiserver_"))]


def _wire(module, name, *, threaded=False, client_kw=None, tmp_path=None,
          errors=False):
    """Run one reference case on both sides; the answers must agree."""
    def run(s, mp):
        stores, registries = [], []
        sub = None
        if tmp_path is not None:
            sub = tmp_path / s.side
            sub.mkdir()
        with side_globals(mp, module, s.side, errors=errors):
            if hasattr(module, "ClusterStore"):
                recorded_instances(mp, module, "ClusterStore", stores)
            if hasattr(module, "MetricsRegistry"):
                recorded_instances(mp, module, "MetricsRegistry",
                                   registries)
            tap, st = wire_case(module, name, s, mp, tmp_path=sub,
                                client_kw=client_kw, errors=errors)
            stores.insert(0, st)
        records = tap.normalised(s)
        if threaded:
            records = main_thread(records)
        out = {"records": records,
               "stores": [store_state(st, s.side) for st in stores]}
        if not threaded:
            out["exposition"] = [_server_lines(r) for r in registries]
        if sub is not None and (sub / "audit.ndjson").exists():
            out["audit"] = normalise_audit((sub / "audit.ndjson").read_text())
        return out
    out = run_both(run)
    assert out["port"] == out["ref"]
    return out


# ------------------------------------------- tests/test_http_transport.py
TRANSPORT = {
    "test_create_get_roundtrip": False,
    "test_get_not_found_maps_to_exception": False,
    "test_create_duplicate_is_already_exists": False,
    "test_list_with_label_selector": False,
    "test_update_and_stale_conflict": False,
    "test_merge_patch": False,
    "test_update_status_subresource_only_touches_status": False,
    "test_delete_and_finalizer_two_phase": False,
    "test_generate_name_materializes": False,
    "test_cluster_scoped_resource_paths": False,
    "test_bearer_token_required_when_configured": False,
    "test_unknown_path_is_k8s_status_404": False,
    "test_crd_schema_enforced_over_http": False,
    "test_watch_streams_added_modified_deleted": True,
    "test_watch_with_label_selector_filters": True,
    "test_watch_reconnects_after_server_restart": True,
    "test_status_subresource_patch_only_touches_status": False,
    "test_unknown_kind_raises_clear_mapping_error": False,
    "test_audit_log_records_mutating_requests": False,
}


@pytest.mark.parametrize("name", sorted(TRANSPORT))
def test_transport_case(name, tmp_path):
    out = _wire(ref_transport, name, threaded=TRANSPORT[name],
                tmp_path=tmp_path)
    if name == "test_audit_log_records_mutating_requests":
        assert [e["verb"] for e in out["port"]["audit"]] == \
            ["POST", "PATCH", "DELETE"]


def test_admission_runs_server_side():
    """tests/test_http_transport.py's case, its admission plugin raising
    the serving side's own InvalidError (the reference's client maps the
    422 back to the reference's)."""
    def run(s, mp):
        with served(s) as (st, proxy), client_of(proxy) as client:
            tap = Tap(s, mp)

            def admit(operation, obj, old):
                if obj["metadata"]["name"] == "forbidden":
                    raise s.errors.InvalidError("name forbidden")
                k8s.set_annotation(obj, "admitted", "yes")
                return obj
            st.register_admission("ConfigMap", admit)
            created = client.create(ref_transport.cm("ok"))
            assert k8s.get_annotation(created, "admitted") == "yes"
            with pytest.raises(ref_errors.InvalidError):
                client.create(ref_transport.cm("forbidden"))
            return tap.normalised(s), store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]


# ------------------------------------------ tests/test_http_resilience.py
RESILIENCE = {
    "test_get_retries_through_429_and_counts_metric": False,
    "test_429_retry_after_is_honored": False,
    "test_429_exhaustion_raises_too_many_requests": False,
    "test_503_retried_for_get_but_not_update": False,
    "test_get_survives_connection_reset_mid_body": False,
    "test_latency_spike_fault_delays_but_succeeds": False,
    "test_create_reset_applies_then_retry_adopts_via_409": False,
    "test_genuine_already_exists_still_raises": False,
    "test_delete_reset_applies_then_retry_tolerates_404": False,
    "test_genuine_delete_of_missing_object_still_raises": False,
    "test_watch_survives_503_burst_on_resync_list": True,
    "test_watch_survives_reset_during_resync_list": True,
    "test_watch_kill_reconnect_resyncs_missed_changes": True,
    "test_ping_truth_table": False,
}


@pytest.mark.parametrize("name", sorted(RESILIENCE))
def test_resilience_case(name):
    _wire(ref_resilience, name, threaded=RESILIENCE[name],
          client_kw={"retry_policy": ref_resilience.FAST})


# ----------------------------------------- tests/test_consistent_reads.py
READS_IN_PROCESS = [
    "test_serve_cache_is_never_stale_relative_to_the_store",
    "test_serve_cache_snapshot_covers_pre_existing_objects",
    "test_serve_cache_pagination_matches_store_semantics",
    "test_wait_for_rv_gates_until_fresh",
    "test_cache_served_results_match_store_results_under_churn",
]


@pytest.mark.parametrize("name", READS_IN_PROCESS)
def test_consistent_reads_case(name):
    def run(s, mp):
        stores, caches = [], []
        with side_globals(mp, ref_reads, s.side, errors=True):
            assert ref_reads._KindServeCache is s.apiserver._KindServeCache
            recorded_instances(mp, ref_reads, "ClusterStore", stores)
            recorded_instances(mp, ref_reads, "_KindServeCache", caches)
            getattr(ref_reads, name)()
        return ([store_state(st, s.side) for st in stores],
                [[[normalise_object(o, s.side) for o in page[0]],
                  page[1], page[2]]
                 for page in (c.list_page(None, None) for c in caches)])
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("name", [
    "test_wire_rv_gated_get_and_list_serve_from_cache",
    "test_serve_cache_unavailable_on_wrapped_stores"])
def test_consistent_reads_wire_case(name):
    _wire(ref_reads, name)


# ---------------------------------------------- tests/test_cache_index.py
def test_store_pagination_equals_unpaginated_for_every_page_size():
    def run(s, mp):
        stores = []
        with side_globals(mp, ref_cache_index, s.side, errors=True):
            recorded_instances(mp, ref_cache_index, "ClusterStore", stores)
            ref_cache_index.\
                test_store_pagination_equals_unpaginated_for_every_page_size()
            (st,) = stores
            pages = []
            for kind in ref_cache_index.KINDS:
                cont = None
                while True:
                    page, cont, rv = st.list_page(kind, None, limit=4,
                                                  continue_token=cont)
                    pages.append([[normalise_object(o, s.side) for o in page],
                                  cont, rv])
                    if cont is None:
                        break
        return store_state(st, s.side), pages
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_malformed_continue_token_rejected():
    """tests/test_cache_index.py's case, each side raising its own
    InvalidError; the tokens each side mints decode on the other."""
    from kubeflow_tpu.cluster.store import (_decode_continue as ref_decode,
                                            _encode_continue as ref_encode)
    from kubeflow_tpu_torch.cluster.store import (_decode_continue,
                                                  _encode_continue)
    for s in SIDES.values():
        with pytest.raises(s.errors.InvalidError):
            s.ClusterStore().list_page("Pod", continue_token="!!not-base64!!")
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        pair = ("".join(rng.choice(list("ab-/é☃0"), rng.integers(0, 9))),
                "".join(rng.choice(list("xyz.=+"), rng.integers(0, 9))))
        assert _encode_continue(*pair) == ref_encode(*pair)
        assert ref_decode(_encode_continue(*pair)) == pair
        assert _decode_continue(ref_encode(*pair)) == pair


def test_wire_pagination_same_item_set_and_rv0():
    def run(s, mp):
        stores = []
        tap = Tap(s, mp)
        with side_globals(mp, ref_cache_index, s.side):
            recorded_instances(mp, ref_cache_index, "ClusterStore", stores)
            # the case imports ApiServerProxy inside its body
            mp.setattr(ref_apiserver, "ApiServerProxy", s.ApiServerProxy)
            ref_cache_index.test_wire_pagination_same_item_set_and_rv0()
        return tap.normalised(s), [store_state(st, s.side) for st in stores]
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert any("continue=" in r["path"] for r in out["port"][0])


# ------------------------------------------------------------------ TLS
@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl is not installed")
def test_https_with_verified_ca(tmp_path):
    """Each side's server on an openssl-minted certificate (as
    tests/test_http_stack.py mints it), the reference's client verifying
    it and authenticating with a bearer token."""
    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)

    def run(s, mp):
        tap = Tap(s, mp)
        with served(s, certfile=str(cert), keyfile=str(key),
                    token="tls-token") as (st, proxy):
            assert proxy.url.startswith("https://")
            with client_of(proxy, token="tls-token",
                           ca_cert=str(cert)) as client:
                created = client.create({"kind": "ConfigMap",
                                         "metadata": {"name": "tls-cm",
                                                      "namespace": "default"}})
                assert created["metadata"]["uid"]
                assert client.get("ConfigMap", "default", "tls-cm")
            ctx = ssl.create_default_context(cafile=str(cert))
            conn = http.client.HTTPSConnection("127.0.0.1", proxy.port,
                                               context=ctx, timeout=TIMEOUT)
            try:
                conn.request("GET", "/api/v1/namespaces/default/configmaps")
                resp = conn.getresponse()
                assert resp.status == 401
                resp.read()
            finally:
                conn.close()
            return tap.normalised(s), store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------- REST mapper
def test_rest_mapper_table_equals_the_reference():
    assert restmapper._MAPPINGS == [
        restmapper.RestMapping(m.kind, m.api_version, m.plural, m.namespaced)
        for m in ref_restmapper._MAPPINGS]
    for m in restmapper._MAPPINGS:
        if m.kind in CLUSTER_SCOPED_KINDS:
            assert not m.namespaced, m.kind
        for ns in (None, "team-a"):
            for name in (None, "x"):
                assert m.path(ns, name, "status") == \
                    ref_restmapper.mapping_for(m.kind).path(ns, name,
                                                            "status")
        g, v = m.group_version
        assert restmapper.mapping_for_route(g, "v9", m.plural) is not None
    with pytest.raises(KeyError, match="no REST mapping"):
        restmapper.mapping_for("SomethingNobodyRegistered")


# ---------------------------------------------- 300 seeded raw requests
_KINDS = {
    "ConfigMap": "/api/v1/namespaces/{ns}/configmaps",
    "Notebook": "/apis/kubeflow.org/v1/namespaces/{ns}/notebooks",
    "Service": "/api/v1/namespaces/{ns}/services",
    "Pod": "/api/v1/namespaces/{ns}/pods",
    "Namespace": "/api/v1/namespaces",
}


def _script(rng) -> list:
    """300 requests: (method, path, body bytes or None, headers)."""
    ops = []
    for i in range(300):
        kind = list(_KINDS)[rng.integers(len(_KINDS))]
        ns = ["default", "team-a", "team-b"][rng.integers(3)]
        coll = _KINDS[kind].format(ns=ns)
        name = f"o{rng.integers(12)}"
        item = f"{coll}/{name}"
        labels = {"app": ["x", "y"][rng.integers(2)],
                  "tier": str(rng.integers(3))}
        body = {"kind": kind, "metadata": {"name": name, "labels": labels},
                "data": {"i": str(i)}}
        if kind == "Notebook":
            body["spec"] = {"template": {"spec": {"containers": [
                {"name": name, "image": "img"}]}}}
        if kind == "Service":
            body["spec"] = {"ports": [{"name": "http", "port": 80}]}
        json_h = {"Content-Type": "application/json"}
        r = rng.integers(20)
        if r < 4:
            ops.append(("POST", coll, body, json_h))
        elif r == 4:
            ops.append(("POST", coll, {"kind": kind, "metadata": {
                "generateName": "gen-"}}, json_h))
        elif r < 7:
            ops.append(("GET", item, None, {}))
        elif r == 7:
            sel = "app=x" if rng.integers(2) else "tier"
            ops.append(("GET", f"{coll}?labelSelector={sel}", None, {}))
        elif r == 8:
            ops.append(("GET", f"{coll}?limit={rng.integers(1, 4)}",
                        None, {}))
        elif r == 9:
            ops.append(("GET", f"{coll}?limit=2&continue=<last>", None, {}))
        elif r == 10:
            ops.append(("PATCH", item, {"metadata": {"labels": {
                "app": None, "p": str(i)}}},
                {"Content-Type": "application/merge-patch+json"}))
        elif r == 11:
            ops.append(("PATCH", f"{item}/status",
                        {"status": {"n": i}},
                        {"Content-Type": "application/merge-patch+json"}))
        elif r == 12:
            ops.append(("PATCH", item, {"x": 1},
                        {"Content-Type": "application/json-patch+json"}))
        elif r == 13:
            ops.append(("PUT", item, {**body, "metadata": {
                **body["metadata"], "resourceVersion": "1"}}, json_h))
        elif r == 14:
            ops.append(("PUT", f"{item}/status",
                        {**body, "status": {"phase": "Running"}}, json_h))
        elif r == 15:
            ops.append(("DELETE", item, None, {}))
        elif r == 16:
            ops.append(("GET", f"{coll}?continue=!!bad!!", None, {}))
        elif r == 17:
            ops.append(("POST", f"/api/v1/namespaces/{ns}/services/"
                        f"{name}:80/proxy/x", {"k": 1}, json_h))
        elif r == 18:
            ops.append(("GET", f"/apis/nonsense/v1/{name}", None, {}))
        else:
            ops.append(("GET", f"{coll}?resourceVersion=0&limit=3",
                        None, {}))
    return ops


def test_seeded_raw_request_script():
    ops = _script(np.random.default_rng(SEED))

    def run(s, mp):
        tap = Tap(s, mp)
        with served(s) as (st, proxy):
            conn = http.client.HTTPConnection("127.0.0.1", proxy.port,
                                              timeout=TIMEOUT)
            last = "<none>"
            statuses = []
            try:
                for method, path, body, headers in ops:
                    path = path.replace("<last>", last)
                    data = json.dumps(body).encode() \
                        if body is not None else None
                    conn.request(method, path, body=data, headers=headers)
                    resp = conn.getresponse()
                    payload = resp.read()
                    statuses.append(resp.status)
                    if resp.status == 200 and method == "GET" and \
                            b'"continue"' in payload:
                        last = json.loads(payload)["metadata"]["continue"]
            finally:
                conn.close()
        records = tap.normalised(s, ordered=True)
        return statuses, records, store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]
    statuses = set(out["port"][0])
    assert {200, 201, 404, 405, 409, 415, 422} <= statuses, statuses
