"""The port's HTTP client held against the reference's, client for client.

Each case is a reference test's own body, run twice: the reference's
``HttpApiClient`` against the reference's ``ApiServerProxy``, then the
port's client against the port's server (``torch_wire.wire_case`` with
``client=True`` swaps the client half's names in the test module, and
``inline`` the modules its body imports). Both runs pass the case's
assertions; what each server answered (``Tap``), the store each case
wrote and the client's ``rest_client_*``/``watch_resumes_total`` lines
must be equal.

Held here: ``test_http_transport``'s two client cases, the keep-alive
pool cases of ``test_watch_resume`` (3) and its slim ``seen`` record,
the client halves of ``test_observability``'s watch-path and
workqueue/client family cases and of its two traceparent/audit cases,
and ``test_cache_index``'s malformed-LIST case, adapted: its fake
response had no ``headers``, which the client reads for the
Content-Type, so the reference's own case fails on the reference; here
the fake carries empty headers, and both clients must raise the same
transport error and count the same retries. Then the pure helpers on
seeded inputs: ``RetryPolicy``'s decorrelated-jitter schedule for 200
seeds, and ``_serialize_selector``, ``_resource_from_path``,
``_error_from_response`` and ``_parse_retry_after`` on 500 inputs each.
Every client a case makes is closed in a ``finally``.
"""

from __future__ import annotations

import http.client
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest

import test_cache_index as ref_cache_index
import test_http_transport as ref_transport
import test_observability as ref_observability
import test_watch_resume as ref_watch_resume
from torch_wire import (SIDES, client_of, inline_modules,
                        normalise_exposition, recorded_instances, run_both,
                        served, side_globals, store_state, wire_case)
from torch_parity import normalise_spans

SEED = 23
CLIENT_FAMILIES = ("rest_client_", "watch_resumes_total")


def client_lines(registry) -> list[str]:
    """The client's families of an exposition, timing samples left out."""
    return [ln for ln in normalise_exposition(registry.expose())
            if ln.split("{")[0].split(" ")[-1].startswith(CLIENT_FAMILIES)]


def _client_case(module, name, *, inline=(), **extra):
    """One reference case through both pairs; what each answered must
    agree."""
    def run(s, mp):
        registries = []
        if hasattr(module, "MetricsRegistry"):
            with side_globals(mp, module, s.side, client=True):
                recorded_instances(mp, module, "MetricsRegistry", registries)
        tap, st = wire_case(module, name, s, mp, client=True,
                            inline=inline, **extra)
        return {"records": tap.normalised(s),
                "store": store_state(st, s.side),
                "client": [client_lines(r) for r in registries]}
    out = run_both(run)
    assert out["port"] == out["ref"]
    return out


# ------------------------------------------ tests/test_http_transport.py
def test_register_admission_rejected_on_http_client():
    _client_case(ref_transport,
                 "test_register_admission_rejected_on_http_client")


def test_rest_client_requests_metric():
    """The body imports ``MetricsRegistry`` itself: ``inline`` makes that
    import find the side's registry, kept for the comparison."""
    def run(s, mp):
        registries = []
        recorded_instances(mp, s.metrics, "MetricsRegistry", registries)
        tap, st = wire_case(ref_transport, "test_rest_client_requests_metric",
                            s, mp, client=True, inline=("metrics",))
        return tap.normalised(s), store_state(st, s.side), \
            [client_lines(r) for r in registries]
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert 'rest_client_requests_total{code="404",method="GET"} 1' in \
        out["port"][2][0]


# ------------------------------------------- tests/test_watch_resume.py
POOL = ["test_pool_reuses_one_connection_per_thread",
        "test_pool_recovers_stale_connection_after_restart",
        "test_pool_recovers_from_injected_resets"]


@pytest.mark.parametrize("name", POOL)
def test_pool_case(name):
    out = _client_case(ref_watch_resume, name)
    assert any('type="pooled"' in ln for ln in out["port"]["client"][0])


def _seeded_object(rng: np.random.Generator, i: int) -> dict:
    md = {"name": f"o{i}", "namespace": f"ns{rng.integers(3)}",
          "uid": f"uid-{i}", "resourceVersion": str(rng.integers(1, 999))}
    for key in ("labels", "ownerReferences", "annotations", "finalizers",
                "generation", "deletionTimestamp"):
        if rng.random() < 0.5:
            md[key] = {"labels": {"a": "b"},
                       "ownerReferences": [{"kind": "Notebook",
                                            "uid": "u", "name": "n"}],
                       "annotations": {"big": "x" * int(rng.integers(9))},
                       "finalizers": ["f"], "generation": 3,
                       "deletionTimestamp": "t"}[key]
    obj = {"kind": str(rng.choice(["Pod", "StatefulSet", "Notebook"])),
           "apiVersion": "v1", "metadata": md,
           "spec": {"replicas": int(rng.integers(4))}}
    if rng.random() < 0.3:
        del obj["apiVersion"]
    return obj


def test_slim_seen_keeps_routing_fields_only():
    """The reference's case on each client, then ``_slim`` of both on 200
    seeded objects."""
    def run(s, mp):
        with side_globals(mp, ref_watch_resume, s.side, client=True):
            assert ref_watch_resume.HttpApiClient is s.HttpApiClient
            ref_watch_resume.test_slim_seen_keeps_routing_fields_only()
        rng = np.random.default_rng(SEED)
        return [s.HttpApiClient._slim(_seeded_object(rng, i))
                for i in range(200)]
    out = run_both(run)
    assert out["port"] == out["ref"]


# ------------------------------------------ tests/test_observability.py
def _recording(s):
    exporter = s.tracing.InMemorySpanExporter()
    s.tracing.set_provider(s.tracing.SDKProvider(exporter))
    return exporter


def test_watch_path_metric_families_exported():
    """The reference's whole case (client and server families in one
    exposition) on each pair; its body imports the apiserver, the client
    and the store, which ``inline`` swaps."""
    def run(s, mp):
        registries = []
        with side_globals(mp, ref_observability, s.side, client=True):
            recorded_instances(mp, ref_observability, "MetricsRegistry",
                               registries)
            inline_modules(mp, s.side, ("apiserver", "http_client", "store"))
            ref_observability.test_watch_path_metric_families_exported()
        (registry,) = registries
        return [ln for ln in normalise_exposition(registry.expose())
                if "_seconds_sum" not in ln and "_bucket" not in ln]
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert 'rest_client_connections_opened_total{type="pooled"} 1' in \
        out["port"]


def test_wire_spans_traceparent_and_audit(tmp_path):
    """The reference's case on each pair, each side recording with its own
    provider: rest.post (the side's client) → apiserver.request (joined
    through the traceparent header) → apf.wait and apiserver.handle, one
    trace, and the audit line carries its id."""
    def run(s, mp):
        sub = tmp_path / s.side
        sub.mkdir()
        exporter = _recording(s)
        try:
            with side_globals(mp, ref_observability, s.side, client=True):
                inline_modules(mp, s.side, ("apiserver", "http_client"))
                ref_observability.test_wire_spans_traceparent_and_audit(
                    exporter, sub)
        finally:
            s.tracing.set_provider(s.tracing.NoopProvider())
        line = json.loads((sub / "audit.ndjson").read_text().splitlines()[0])
        line.pop("ts")
        line.pop("peer")
        line["trace_id"] = line["trace_id"] == \
            f"{exporter.by_name('op')[0].trace_id:032x}"
        # the server's spans end on its handler thread, racing the
        # client's: compared in name order
        spans = sorted(exporter.spans, key=lambda sp: sp.name)
        return normalise_spans(spans, s.side), line
    out = run_both(run)
    assert out["port"] == out["ref"]


class _Untraced:
    """A tracer that records nothing: the apiserver of the two-process
    shape, whose process installs no recording provider."""

    def __init__(self, s):
        self._noop = s.tracing.NoopProvider()

    def start_span(self, name, attributes=None, parent=None):
        return self._noop.span("apiserver", name, attributes, parent=parent)


def test_audit_trace_id_without_server_side_recording(tmp_path):
    """The client half of the reference's case: the side's client records
    inside a span, its apiserver records nothing (its tracer and its
    recording check are the no-op's), and the audit line still carries
    the client's trace id, sent in the traceparent header."""
    def run(s, mp):
        audit = tmp_path / f"{s.side}.ndjson"
        exporter = _recording(s)
        mp.setattr(s.apiserver, "_TRACER", _Untraced(s))
        mp.setattr(s.apiserver, "tracing", SimpleNamespace(
            parse_traceparent=s.tracing.parse_traceparent,
            is_recording=lambda: False,
            current_span=lambda: s.tracing._NOOP_SPAN))
        try:
            with served(s, audit_log=str(audit)) as (_, proxy), \
                    client_of(proxy, s) as client:
                with s.tracing.get_tracer("test").start_span("op") as op:
                    client.create({"kind": "ConfigMap", "apiVersion": "v1",
                                   "metadata": {"name": "a",
                                                "namespace": "ns"}})
        finally:
            s.tracing.set_provider(s.tracing.NoopProvider())
        assert not [sp for sp in exporter.spans
                    if sp.name.startswith(("apiserver.", "apf."))]
        line = json.loads(audit.read_text().splitlines()[0])
        assert line["trace_id"] == f"{op.trace_id:032x}"
        line.pop("ts")
        line.pop("peer")
        line["trace_id"] = "<the client's>"
        return normalise_spans(exporter.spans, s.side), line
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_workqueue_and_client_families_exported_via_manager():
    """The client half of the reference's case: a manager whose reconciler
    reads through the side's client, both on one registry; the rest
    client's families land in the manager's exposition beside the
    workqueue's."""
    def run(s, mp):
        registry = s.metrics.MetricsRegistry()
        with served(s) as (st, proxy), client_of(proxy, s) as client:
            client.attach_metrics(registry)
            st.create({"kind": "ConfigMap", "apiVersion": "v1",
                       "metadata": {"name": "x", "namespace": "ns"}})
            mgr = s.manager.Manager(client)
            mgr.attach_metrics(registry)
            seen = []

            class Rec:
                name = "r"

                def reconcile(self, req):
                    seen.append(client.get_or_none("ConfigMap",
                                                   req.namespace, req.name))
                    return None
            mgr.register(Rec())
            mgr.enqueue("r", s.manager.Request("ns", "x"))
            mgr.run_until_idle(timeout=10)
        text = registry.expose()
        for family in ("rest_client_requests_total",
                       "rest_client_request_duration_seconds",
                       "rest_client_retries_total",
                       "rest_client_connections_opened_total",
                       "watch_resumes_total", "workqueue_adds_total",
                       "controller_runtime_reconcile_total"):
            assert family in text, family
        assert seen and seen[0]["metadata"]["name"] == "x"
        return [ln for ln in normalise_exposition(text)
                if "_seconds_sum" not in ln and "_bucket" not in ln]
    out = run_both(run)
    assert out["port"] == out["ref"]


# ---------------------------------------------- tests/test_cache_index.py
class _Resp:
    """A clean 200 answering ``body``, with the (empty) headers the
    client reads its Content-Type from."""
    headers: dict = {}

    def __init__(self, body: bytes) -> None:
        self._body = body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self) -> bytes:
        return self._body


def test_list_body_without_items_is_a_transport_error():
    """tests/test_cache_index.py's case with ``headers`` on its fake
    response (the reference's case fails on the reference for the lack
    of them): a LIST body without ``items`` raises the retryable
    ``MalformedListError``, rides the bounded transport retry and counts
    toward the health tracker, on both clients alike."""
    assert "headers" not in vars(ref_cache_index)  # the reference's fake

    def run(s, mp):
        hc = s.http_client
        registry = s.metrics.MetricsRegistry()
        client = hc.HttpApiClient(
            "http://127.0.0.1:1", metrics=registry,
            retry_policy=hc.RetryPolicy(max_attempts=2,
                                        backoff_base_s=0.001,
                                        backoff_cap_s=0.002),
            rng=random.Random(SEED))
        calls, health = [], []
        try:
            # an LB error page where the LIST body should be
            client._request = lambda *a, **kw: (calls.append(a), _Resp(
                b'{"kind": "Status", "code": 200}'))[1]
            client.set_health_tracker(SimpleNamespace(
                record_success=lambda: health.append(True),
                record_failure=lambda: health.append(False)))
            with pytest.raises(hc.MalformedListError) as err:
                client.list("ConfigMap", "ns")
        finally:
            client.close()
        assert len(calls) == 2
        assert health == [False, False]
        assert issubclass(hc.MalformedListError, hc.TRANSPORT_ERRORS)
        assert issubclass(hc.MalformedListError, http.client.HTTPException)
        return (type(err.value).__name__, str(err.value), calls, health,
                client_lines(registry))
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert 'rest_client_retries_total{reason="transport",verb="GET"} 1' \
        in out["port"][4]


# ------------------------------------------------------- seeded helpers
class _Schedule:
    """``_stopped`` for a client whose retry waits are recorded, never
    slept."""

    def __init__(self):
        self.waits: list[float] = []

    def wait(self, timeout):
        self.waits.append(timeout)
        return False

    def is_set(self):
        return False

    def set(self):
        pass


def _schedule(s, seed: int, codes: list) -> tuple:
    """The waits one logical GET takes through ``codes`` (a status with
    its Retry-After, or None for a reset), and how it ended."""
    hc = s.http_client
    rng = random.Random(seed)
    policy = hc.RetryPolicy(max_attempts=rng.randint(1, 6),
                            backoff_base_s=rng.choice([0.01, 0.05, 0.2]),
                            backoff_cap_s=rng.choice([0.1, 2.0, 5.0]))
    client = hc.HttpApiClient("http://127.0.0.1:1", retry_policy=policy,
                              rng=random.Random(seed))
    client._stopped = _Schedule()
    answers = iter(codes)

    def request(method, path, *a, **kw):
        code, retry_after = next(answers, (200, None))
        if code is None:
            raise ConnectionResetError("reset")
        if code >= 400:
            body = json.dumps({"reason": "", "message": "m"}).encode()
            headers = {"Retry-After": retry_after} if retry_after else {}
            raise hc._error_from_response(code, body, headers)
        return _Resp(b"{}")
    client._request = request
    try:
        client._json("GET", "/api/v1/namespaces/ns/configmaps/x")
        end = "ok"
    except Exception as exc:  # noqa: BLE001 - the ending is compared
        end = f"{type(exc).__name__}:{getattr(exc, 'code', None)}"
    finally:
        client.close()
    return client._stopped.waits, end


def test_retry_policy_schedule_on_seeded_runs():
    """The decorrelated-jitter backoff and Retry-After pacing of 200
    seeded runs of 429s, 503s and resets: the same waits, the same
    endings."""
    def run(s, mp):
        out = []
        for seed in range(200):
            rng = random.Random(seed * 7 + 1)
            codes = [rng.choice([(429, None), (429, "0.5"), (503, None),
                                 (503, "2"), (None, None), (404, None),
                                 (429, "bogus")])
                     for _ in range(rng.randint(0, 7))]
            out.append(_schedule(s, seed, codes))
        return out
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert sum(len(w) for w, _ in out["port"]) > 200


def _seeded_inputs(rng: np.random.Generator, n: int) -> list:
    words = ["a", "b-c", "notebook-name", "app", "x.y/z", "", "~", "1"]
    out = []
    for _ in range(n):
        sel = {str(rng.choice(words)): (None if rng.random() < 0.3
                                        else str(rng.choice(words)))
               for _ in range(int(rng.integers(0, 4)))}
        parts = [str(rng.choice(["api", "apis", "namespaces", "ns",
                                 "v1", "kubeflow.org", "pods",
                                 "notebooks", "nb", "status"]))
                 for _ in range(int(rng.integers(0, 8)))]
        path = "/" + "/".join(parts)
        if rng.random() < 0.3:
            path += "?watch=true&limit=3"
        code = int(rng.choice([400, 401, 403, 404, 409, 410, 422, 429,
                               500, 503, 504]))
        body = rng.choice([
            json.dumps({"reason": str(rng.choice(
                ["NotFound", "AlreadyExists", "Conflict", "Invalid",
                 "Forbidden", "TooManyRequests", "ServiceUnavailable",
                 "Expired", "Other", ""])), "message": "msg"}),
            json.dumps({"message": ""}), "not json <html>", "",
            json.dumps([1, 2])])
        retry = rng.choice([None, "", "3", "0.25", "-1", "soon",
                            "Wed, 21 Oct 2015 07:28:00 GMT", "1e3"])
        out.append((sel, path, code, str(body).encode(), retry))
    return out


def test_pure_helpers_on_seeded_inputs():
    """``_serialize_selector``, ``_resource_from_path``,
    ``_error_from_response`` (class name, code, message, Retry-After) and
    ``_parse_retry_after`` of both packages on 500 seeded inputs."""
    inputs = _seeded_inputs(np.random.default_rng(SEED), 500)

    def run(s, mp):
        hc = s.http_client
        out = []
        for sel, path, code, body, retry in inputs:
            headers = {"Retry-After": retry} if retry is not None else {}
            err = hc._error_from_response(code, body, headers)
            try:
                resource = hc._resource_from_path(path)
            except IndexError as exc:
                resource = f"IndexError:{exc}"
            out.append([hc._serialize_selector(sel), resource,
                        type(err).__name__, err.code, str(err),
                        err.retry_after, hc._parse_retry_after(retry)])
        return out
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert len({row[2] for row in out["port"]}) >= 7


def test_error_maps_name_the_same_classes():
    ref, port = SIDES["ref"].http_client, SIDES["port"].http_client
    for table in ("_ERROR_BY_REASON", "_ERROR_BY_CODE"):
        want = {k: v.__name__ for k, v in getattr(ref, table).items()}
        got = {k: v.__name__ for k, v in getattr(port, table).items()}
        assert got == want
        assert all(v.__module__ == "kubeflow_tpu_torch.cluster.errors"
                   for v in getattr(port, table).values())
    assert [c.__name__ for c in port.TRANSPORT_ERRORS] == \
        [c.__name__ for c in ref.TRANSPORT_ERRORS]
    for const in ("WATCH_SERVER_TIMEOUT_S", "WATCH_READ_TIMEOUT_S",
                  "WATCH_RECONNECT_DELAY_S", "WATCH_BACKOFF_MAX_S",
                  "WATCH_BACKOFF_RESET_AFTER_S"):
        assert getattr(port, const) == getattr(ref, const), const
    assert port.RetryPolicy() == port.RetryPolicy(
        **vars(ref.RetryPolicy()))
    assert port.HttpApiClient.supports_inprocess_admission is False
