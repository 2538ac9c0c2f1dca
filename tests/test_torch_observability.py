"""The port's observability tier held against the reference's, case for
case: the in-process cases of tests/test_observability.py run through
both packages on the same inputs, each side with the case's own
assertions, and what each side recorded is compared after
``torch_parity``'s normalisation (span and trace ids as ordinal tokens,
wall-clock times dropped, the tracer prefix ``kubeflow_tpu.`` mapped onto
``kubeflow_tpu_torch.``, exemplar timestamps dropped, each side's images
and slice requests through ``normalise``): span trees, ``/metrics`` text
line for line, the debug endpoint's JSON, JSON log records.

Mirrored: the providers (3), the webhook's root span and its
restart-gating child (2), the health server (3), the span stack,
emitted spans and the flight recorder (5), the manager's root and queue
spans, its join of the annotation trace and the notebook reconciler's
stamp (3), log correlation (2), escaping and exemplars (3), the metric
catalog over the port's own source and tests (4, plus the port's
entries held to the reference's), and the workqueue half of
``test_workqueue_and_client_families_exported_via_manager``. The
manager cases drain with ``run_until_idle`` instead of a started pool,
so both sides dispatch in one order. The slice-repair and slice-pool
family cases are here too (2); the scheduler's is in
tests/test_torch_scheduler.py, the traceparent cases in
tests/test_torch_tracing.py. The wire's server half (4): the APF half
of the shard/APF family case, the server and store families of the
watch-path case, and the server half of the two traceparent/audit
cases, the reference's ``HttpApiClient`` driving each side's
apiserver.

The binaries' cases (``torch_wire.binaries_case``, each the
reference's own body on each side): the four leader-election cases
(``controllers/election.py``), the whole shard/APF family case with its
shard half, and ``test_render_trace_timeline`` (``cli.py``, with both
renderers on seeded span trees). The client halves of the watch-path
and workqueue/client families cases are in
tests/test_torch_http_client.py.
"""

from __future__ import annotations

import ast
import io
import json
import logging as pylogging
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

import test_observability as ref_observability
from kubeflow_tpu.controllers.manager import Manager as RefManager
from kubeflow_tpu.utils import health as ref_health
from kubeflow_tpu.utils import logging as ref_logging
from kubeflow_tpu.utils import metrics as ref_metrics
from kubeflow_tpu.utils import tracing as ref_tracing
from kubeflow_tpu_torch.controllers.manager import Manager
from kubeflow_tpu_torch.utils import health, metrics, tracing
from kubeflow_tpu_torch.utils import logging as port_logging
from torch_parity import IMAGE_TOKENS, Ids, Stack, normalise_spans
from torch_wire import SIDES as WIRE_SIDES
from torch_wire import binaries_case, normalise_object

REPO = Path(__file__).resolve().parent.parent
SIDES = {
    "ref": SimpleNamespace(tracing=ref_tracing, metrics=ref_metrics,
                           logging=ref_logging, health=ref_health,
                           Manager=RefManager),
    "port": SimpleNamespace(tracing=tracing, metrics=metrics,
                            logging=port_logging, health=health,
                            Manager=Manager)}


def both(case, *args):
    """``case(side_modules, side, *args)`` on each side, the no-op
    provider restored after each; {side: result}."""
    out = {}
    for side, m in SIDES.items():
        try:
            out[side] = case(m, side, *args)
        finally:
            m.tracing.set_provider(m.tracing.NoopProvider())
    return out


def recording(m):
    """A recording provider over an in-memory exporter on side ``m``."""
    exporter = m.tracing.InMemorySpanExporter()
    m.tracing.set_provider(m.tracing.SDKProvider(exporter))
    return exporter


def _get(url: str) -> tuple[int, str, str]:
    """(status, body, content type) of a GET, an HTTP error's too."""
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode(), \
                resp.headers["Content-Type"]
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read().decode(), \
                exc.headers["Content-Type"]


_EXEMPLAR_RE = re.compile(r' # \{([^{}]*)\} ([^ ]+) [0-9.]+$')


def normalise_exposition(text: str, ids: Ids | None = None) -> list[str]:
    """An exposition's lines with each exemplar's timestamp dropped and
    its trace and span ids as ordinal tokens."""
    ids = ids if ids is not None else Ids()

    def exemplar(m):
        labels = re.sub(
            r'(trace_id|span_id)="([0-9a-f]+)"',
            lambda x: f'{x.group(1)}="'
                      f'{ids(x.group(1)[:-3], x.group(2))}"', m.group(1))
        return f" # {{{labels}}} {m.group(2)} <ts>"
    return [_EXEMPLAR_RE.sub(exemplar, line) for line in text.splitlines()]


# ------------------------------------------------------------- providers
def test_noop_provider_records_nothing_and_never_fails():
    def case(m, side):
        tracer = m.tracing.get_tracer("t")
        with tracer.start_span("root", {"a": 1}) as span:
            span.set_attribute("k", "v")
            span.add_event("e")
            span.set_status(m.tracing.STATUS_OK)
        return m.tracing.get_provider().recording
    got = both(case)
    assert got == {"ref": False, "port": False}


def test_sdk_provider_parents_and_exports():
    def case(m, side):
        exporter = recording(m)
        tracer = m.tracing.get_tracer("t")
        with tracer.start_span("root") as root:
            root.set_attribute("x", 1)
            with tracer.start_span("child") as child:
                child.add_event("evt", {"k": "v"})
        spans = exporter.spans
        assert [s.name for s in spans] == ["child", "root"]  # export on end
        child, root = spans
        assert child.parent_id == root.span_id
        assert child.trace_id == root.trace_id
        assert child.events[0].name == "evt"
        return normalise_spans(spans, side)
    got = both(case)
    assert got["port"] == got["ref"]


def test_sdk_provider_records_exception():
    def case(m, side):
        exporter = recording(m)
        with pytest.raises(ValueError):
            with m.tracing.get_tracer("t").start_span("boom"):
                raise ValueError("bad")
        (span,) = exporter.spans
        assert span.status == m.tracing.STATUS_ERROR
        assert span.events[0].attributes["exception.type"] == "ValueError"
        return normalise_spans([span], side)
    got = both(case)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------- webhook
def _webhook_spans(s: Stack, exporter) -> list:
    """The spans, with each side's images also mapped inside the parked
    diffs' text."""
    def inside(value):
        if isinstance(value, str):
            for image, token in IMAGE_TOKENS[s.side].items():
                value = value.replace(image, token)
        return value
    spans = normalise_spans(exporter.spans, s.side)
    for span in spans:
        for ev in span["events"]:
            ev["attributes"] = {k: inside(v)
                                for k, v in ev["attributes"].items()}
    return spans


def test_webhook_admission_emits_root_span():
    """One root span per admission with the notebook, namespace and
    operation, and the image-swap event: a generic image is swapped on
    both sides (for the reference's JAX default, for the port's CUDA
    one)."""
    def case(m, side):
        s = Stack(side)
        exporter = recording(m)
        wh = s.wh.Mutating(s.store, s.Config())
        nb = s.api.new_notebook(
            "traced", "ns", image="jupyter/scipy-notebook:latest",
            annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                         s.accelerator("v5e-4")})
        wh.handle("CREATE", nb, None)
        (span,) = exporter.by_name("notebook-mutating-webhook")
        assert span.attributes["notebook.name"] == "traced"
        assert span.attributes["notebook.namespace"] == "ns"
        assert span.attributes["admission.operation"] == "CREATE"
        assert span.status == m.tracing.STATUS_OK
        assert any(e.name == "image-swapped" for e in span.events)
        return _webhook_spans(s, exporter)
    got = both(case)
    assert got["port"] == got["ref"]


def test_webhook_restart_gating_child_span():
    """The parked-update path opens a child span with an updates-parked
    event: a running notebook keeping the side's native image, updated
    to one its webhook swaps (the reference's case: a JAX image updated
    to a CUDA one; turned round on the port)."""
    def case(m, side):
        s = Stack(side)
        exporter = recording(m)
        wh = s.wh.Mutating(s.store, s.Config())
        ann = {s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4")}
        old = s.api.new_notebook("run", "ns", image=s.image("native"),
                                 annotations=dict(ann))
        incoming = s.api.new_notebook("run", "ns", image=s.image("foreign"),
                                      annotations=dict(ann))
        out = wh.handle("UPDATE", incoming, old)
        children = exporter.by_name("maybe-restart-running-notebook")
        assert len(children) == 1
        roots = exporter.by_name("notebook-mutating-webhook")
        assert children[0].parent_id == roots[0].span_id
        assert any(e.name == "updates-parked" for e in children[0].events)
        assert s.names.UPDATE_PENDING_ANNOTATION in \
            out["metadata"]["annotations"]
        return _webhook_spans(s, exporter)
    got = both(case)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------- health server
def test_health_server_endpoints():
    def case(m, side):
        reg = m.metrics.MetricsRegistry()
        reg.notebook_create_total.inc()
        srv = m.health.HealthServer(metrics_registry=reg, host="127.0.0.1")
        srv.add_healthz_check("loop", lambda: True)
        ready = {"ok": False}
        srv.add_readyz_check("webhook", lambda: ready["ok"])
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            seen = [_get(f"{base}/healthz")]
            assert seen[-1][0] == 200 and "loop" in seen[-1][1]
            seen.append(_get(f"{base}/readyz"))
            assert seen[-1][0] == 503        # the webhook check failing
            ready["ok"] = True
            seen.append(_get(f"{base}/readyz"))
            assert seen[-1][0] == 200
            seen.append(_get(f"{base}/metrics"))
            assert seen[-1][0] == 200
            assert "notebook_create_total 1" in seen[-1][1]
            seen.append(_get(f"{base}/nothing-here"))
            assert seen[-1][0] == 404
        finally:
            srv.stop()
        return seen
    got = both(case)
    assert got["port"] == got["ref"]


def test_health_server_debug_trace_endpoint():
    def case(m, side):
        rec = m.tracing.FlightRecorder()
        m.tracing.set_provider(m.tracing.SDKProvider(rec))
        try:
            with m.tracing.get_tracer("t").start_span(
                    "reconcile", {m.tracing.KEY_ATTRIBUTE: "ns/nb"}):
                pass
        finally:
            m.tracing.set_provider(m.tracing.NoopProvider())
        srv = m.health.HealthServer(flight_recorder=rec, host="127.0.0.1")
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            status, body, ctype = _get(f"{base}/debug/notebooks/ns/nb/trace")
            assert status == 200 and ctype == "application/json"
            payload = json.loads(body)
            assert payload["namespace"] == "ns" and payload["name"] == "nb"
            (trace,) = payload["traces"]
            assert trace["spans"][0]["name"] == "reconcile"
            assert trace["spans"][0]["attributes"][
                m.tracing.KEY_ATTRIBUTE] == "ns/nb"
            misses = [_get(f"{base}/debug/notebooks/ns/unknown/trace"),
                      _get(f"{base}/debug/notebooks/ns/nb/other")]
            assert [x[0] for x in misses] == [404, 404]
        finally:
            srv.stop()
        # no recorder attached → 404, not a crash
        bare = m.health.HealthServer(host="127.0.0.1")
        bare.start()
        try:
            misses.append(_get(
                f"http://127.0.0.1:{bare.port}/debug/notebooks/a/b/trace"))
            assert misses[-1][0] == 404
        finally:
            bare.stop()
        ids = Ids()
        return {"traces": [{"trace_id": ids("trace", t["trace_id"]),
                            "spans": normalise_spans(t["spans"], side, ids)}
                           for t in payload["traces"]],
                "misses": misses}
    got = both(case)
    assert got["port"] == got["ref"]


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? ([^ ]+)$')


def _parse_prometheus(text: str) -> dict:
    """The reference case's scrape parser: {(name, labels): value}; an
    exemplar comment is stripped as any trailing comment."""
    samples: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if " # " in line:
            line = line.split(" # ", 1)[0]
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        name, labels, value = m.groups()
        samples[(name, labels or "")] = float(value)
    return samples


def test_metrics_endpoint_scrape_round_trip():
    """GET /metrics: the version content type, a trailing newline, every
    line parseable, escaped label values and an exemplar; the text equal
    line for line across the packages."""
    def case(m, side):
        reg = m.metrics.MetricsRegistry()
        reg.notebook_create_total.inc({"namespace": "ns"})
        reg.gauge("rt_gauge", "g").set(2.5, {"node": 'weird"name'})
        h = reg.histogram("rt_seconds", "h", buckets=(0.1, 1.0))
        h.observe(0.05, {"verb": "get"},
                  exemplar={"trace_id": "ef" * 16, "span_id": "01" * 8})
        srv = m.health.HealthServer(metrics_registry=reg, host="127.0.0.1")
        srv.start()
        try:
            status, body, ctype = _get(f"http://127.0.0.1:{srv.port}/metrics")
        finally:
            srv.stop()
        assert status == 200 and ctype == "text/plain; version=0.0.4"
        assert body.endswith("\n")
        samples = _parse_prometheus(body)
        assert samples[("notebook_create_total", '{namespace="ns"}')] == 1.0
        assert samples[("rt_gauge", '{node="weird\\"name"}')] == 2.5
        assert samples[("rt_seconds_bucket", '{verb="get",le="0.1"}')] == 1.0
        assert samples[("rt_seconds_count", '{verb="get"}')] == 1.0
        return normalise_exposition(body)
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------ slice repair and pool families
def test_slice_repair_metric_families_exported():
    """The four slice-health families with their label sets, the
    degraded gauge computed at scrape time from the Notebooks and
    drained to 0 (its sample kept) once the slice recovers."""
    def case(m, side):
        s = Stack(side)
        rec = s.slicerepair.SliceRepairReconciler(s.store, s.Config(),
                                                  s.metrics)
        s.store.create(s.api.new_notebook("nb", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4"),
            s.names.SLICE_HEALTH_ANNOTATION: "Degraded"}))
        rec.repairs_total.inc({"namespace": "ns", "reason": "NodeNotReady"})
        rec.repair_duration.observe(1.5, {"namespace": "ns"})
        rec.quarantines_total.inc({"namespace": "ns"})
        text = s.metrics.expose()
        assert 'slice_repairs_total{namespace="ns",reason="NodeNotReady"} ' \
            '1' in text
        assert 'slice_repair_duration_seconds_count{namespace="ns"} 1' \
            in text
        assert 'slice_quarantines_total{namespace="ns"} 1' in text
        assert 'slice_degraded{namespace="ns",state="Degraded"} 1' in text
        s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {"annotations": {
            s.names.SLICE_HEALTH_ANNOTATION: None}}})
        after = s.metrics.expose()
        assert 'slice_degraded{namespace="ns",state="Degraded"} 0' in after
        return text.splitlines() + after.splitlines()
    got = both(case)
    assert got["port"] == got["ref"]


def test_slice_pool_metric_families_exported():
    """The pool and migration families with their label sets:
    ``slicepool_size`` by pool and state (computed at scrape time from
    the pool's StatefulSets), the bind latency by pool, misses by reason,
    ``notebook_migrations_total`` by outcome (the repairer's)."""
    def case(m, side):
        s = Stack(side)
        pool = s.SlicePoolReconciler(s.store, s.Config(), s.metrics)
        repair = s.slicerepair.SliceRepairReconciler(s.store, s.Config(),
                                                     s.metrics)
        s.store.create({
            "apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": "p-w0", "namespace": "tpu-slice-pools",
                         "labels": {s.names.POOL_LABEL: "p"},
                         "annotations": {
                             s.names.POOL_STATE_ANNOTATION: "Warm"}},
            "spec": {"replicas": 1}})
        pool.bind_latency.observe(0.05, {"pool": "p"})
        pool.bind_misses.inc({"reason": "PoolContended"})
        repair.migrations_total.inc({"outcome": "success"})
        repair.migrations_total.inc({"outcome": "fallback"})
        text = s.metrics.expose()
        for line in ('slicepool_size{pool="p",state="Warm"} 1',
                     'slicepool_bind_latency_seconds_count{pool="p"} 1',
                     'slicepool_bind_misses_total{reason="PoolContended"} 1',
                     'notebook_migrations_total{outcome="success"} 1',
                     'notebook_migrations_total{outcome="fallback"} 1'):
            assert line in text
        return text.splitlines()
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------------- span stack, emit, recorder
def test_noop_span_cm_is_a_shared_singleton():
    def case(m, side):
        provider = m.tracing.NoopProvider()
        cm1 = provider.span("t", "a", {"attr": 1})
        cm2 = provider.span("t", "b")
        assert cm1 is cm2
        with cm1 as span:
            span.set_attribute("k", "v")
            assert span.context() is None
        assert provider.emit("t", "c", 1.0, 2.0).context() is None
        m.tracing.set_provider(m.tracing.NoopProvider())
        return (m.tracing.is_recording(), m.tracing.current_context(),
                m.tracing.current_exemplar())
    got = both(case)
    assert got["port"] == got["ref"] == (False, None, None)


def test_sdk_provider_thread_parentage():
    """Four threads each keep their own span stack: a child always
    parents on its own thread's root, and every root is a new trace."""
    def case(m, side):
        exporter = recording(m)
        tracer = m.tracing.get_tracer("t")
        errors: list = []

        def worker(i: int) -> None:
            for _ in range(50):
                with tracer.start_span(f"root-{i}") as root:
                    with tracer.start_span(f"child-{i}") as child:
                        if child.parent_id != root.span_id or \
                                child.trace_id != root.trace_id:
                            errors.append((i, child.span_id))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        spans = exporter.spans
        roots = [s for s in spans if s.name.startswith("root-")]
        by_id = {s.span_id: s for s in spans}
        # each child's parent is its own thread's root
        pairs = sorted((s.name, by_id[s.parent_id].name) for s in spans
                       if s.name.startswith("child-"))
        return {"errors": errors, "roots": len(roots),
                "root_parents": {s.parent_id for s in roots},
                "traces": len({s.trace_id for s in roots}),
                "pairs": sorted(set(pairs)), "children": len(pairs)}
    got = both(case)
    assert got["port"] == got["ref"]
    assert got["port"] == {
        "errors": [], "roots": 200, "root_parents": {None}, "traces": 200,
        "pairs": [(f"child-{i}", f"root-{i}") for i in range(4)],
        "children": 200}


def test_explicit_parent_overrides_stack():
    def case(m, side):
        exporter = recording(m)
        tracer = m.tracing.get_tracer("t")
        remote = m.tracing.SpanContext(trace_id=0xDEAD, span_id=0xBEEF)
        with tracer.start_span("local-root"):
            with tracer.start_span("stitched", parent=remote):
                with tracer.start_span("grandchild"):
                    pass
        stitched = exporter.by_name("stitched")[0]
        grandchild = exporter.by_name("grandchild")[0]
        local = exporter.by_name("local-root")[0]
        assert stitched.trace_id == 0xDEAD
        assert stitched.parent_id == 0xBEEF
        assert grandchild.trace_id == 0xDEAD
        assert grandchild.parent_id == stitched.span_id
        assert local.trace_id != 0xDEAD
        return normalise_spans(exporter.spans, side)
    got = both(case)
    assert got["port"] == got["ref"]


def test_emit_span_synthetic_timestamps():
    """emit_span exports a finished span with explicit times (kept in the
    comparison: they are the case's, not the clock's), parented on the
    open span or on an explicit remote one."""
    def case(m, side):
        exporter = recording(m)
        tracer = m.tracing.get_tracer("t")
        with tracer.start_span("root"):
            tracer.emit_span("workqueue.wait", 10.0, 11.5,
                             {"controller": "c"})
        root = exporter.by_name("root")[0]
        wait = exporter.by_name("workqueue.wait")[0]
        assert wait.start_time == 10.0 and wait.end_time == 11.5
        assert wait.parent_id == root.span_id
        assert wait.trace_id == root.trace_id
        remote = m.tracing.SpanContext(5, 6)
        detached = m.tracing.get_tracer("t").emit_span("det", 1.0, 2.0,
                                                       parent=remote)
        assert detached.trace_id == 5 and detached.parent_id == 6
        alone = tracer.emit_span("alone", 3.0, 4.0)
        assert alone.parent_id is None
        spans = exporter.spans
        return (normalise_spans(spans, side),
                [(s.start_time, s.end_time) for s in spans
                 if s.name != "root"])
    got = both(case)
    assert got["port"] == got["ref"]


def test_flight_recorder_binds_and_bounds_per_key():
    def case(m, side):
        inner = m.tracing.InMemorySpanExporter()
        rec = m.tracing.FlightRecorder(inner=inner, traces_per_key=2)
        m.tracing.set_provider(m.tracing.SDKProvider(rec))
        tracer = m.tracing.get_tracer("t")
        for _ in range(3):
            with tracer.start_span("reconcile",
                                   {m.tracing.KEY_ATTRIBUTE: "ns/nb"}):
                with tracer.start_span("child"):
                    pass
        m.tracing.set_provider(m.tracing.NoopProvider())
        traces = rec.trace_for("ns", "nb")
        assert len(traces) == 2   # a ring of 2: the oldest trace evicted
        for t in traces:
            # the child exported before its keyed root and still landed
            # in the trace (parked unbound until the root arrived)
            assert {s["name"] for s in t["spans"]} == {"reconcile", "child"}
        assert rec.keys() == ["ns/nb"]
        assert rec.trace_for("ns", "other") == []
        assert len(inner.spans) == 6   # the decorator tees every span
        ids = Ids()
        return [{"trace_id": ids("trace", t["trace_id"]),
                 "spans": normalise_spans(t["spans"], side, ids)}
                for t in traces]
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------------------ the manager's spans
class _Rec:
    name = "notebook-test"

    def __init__(self):
        self.calls = 0

    def reconcile(self, req):
        self.calls += 1
        return None


def _manager_run(m, side, annotations: dict | None = None):
    """A Notebook created on the side's store with a bare reconciler
    watching it, drained on the calling thread under a recording
    provider; the spans and the reconciles."""
    s = Stack(side)
    exporter = recording(m)
    mgr = m.Manager(s.store)
    rec = _Rec()
    mgr.register(rec)
    mgr.watch(s.api.KIND, rec.name)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4"),
        **(annotations or {})}))
    n = mgr.run_until_idle(timeout=10)
    return exporter, n, rec.calls


def test_manager_reconcile_root_and_queue_spans():
    """Every traced dispatch gets a reconcile root carrying the notebook
    key, with workqueue.enqueue (watch delivery → queue) and
    workqueue.wait (queue → worker) as synthetic children inside it."""
    def case(m, side):
        exporter, n, calls = _manager_run(m, side)
        root = [s for s in exporter.by_name("reconcile")
                if s.attributes.get("controller") == "notebook-test"][0]
        assert root.attributes[m.tracing.KEY_ATTRIBUTE] == "ns/nb"
        wait = exporter.by_name("workqueue.wait")[0]
        enqueue = exporter.by_name("workqueue.enqueue")[0]
        assert wait.parent_id == root.span_id
        assert enqueue.parent_id == root.span_id
        assert enqueue.attributes["event"] == "ADDED"
        # backdated to the watch delivery: the queue legs lie inside it
        assert root.start_time <= enqueue.start_time + 1e-6
        assert root.start_time <= wait.start_time + 1e-6
        assert root.end_time >= wait.end_time
        return normalise_spans(exporter.spans, side), n, calls
    got = both(case)
    assert got["port"] == got["ref"]


def test_manager_reconcile_joins_annotation_trace():
    """An object carrying the trace-context annotation reconciles into
    that trace: the cross-controller stitch at the dispatch layer."""
    def case(m, side):
        carried = m.tracing.SpanContext(trace_id=0xFEED, span_id=0xFACE)
        exporter, n, calls = _manager_run(m, side, {
            Stack(side).names.TRACE_CONTEXT_ANNOTATION:
                m.tracing.format_traceparent(carried)})
        root = exporter.by_name("reconcile")[0]
        assert root.trace_id == 0xFEED
        assert root.parent_id == 0xFACE
        return normalise_spans(exporter.spans, side), n, calls
    got = both(case)
    assert got["port"] == got["ref"]


@pytest.fixture(scope="module")
def stamped_runs():
    """Each side's whole control plane (the reference's
    ``setup_controllers``, the port's ``build_manager(components="all")``)
    reconciling one notebook under a recording provider, drained on the
    calling thread: {side: (stack, spans)}."""
    out = {}
    for side, m in SIDES.items():
        s = Stack(side)
        try:
            s.entry_point()
            exporter = recording(m)
            s.store.create(s.api.new_notebook("nb", "ns", annotations={
                s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4")}))
            s.drain()
        finally:
            m.tracing.set_provider(m.tracing.NoopProvider())
        out[side] = (s, exporter.spans)
    return out


def test_notebook_reconciler_stamps_trace_context(stamped_runs):
    """The first traced reconcile stamps the notebook with the
    trace-context annotation, which is not copied onto its StatefulSet;
    the stamp is one value, the reconciles its echo causes join it, and
    both sides record the same span trees and store the same objects."""
    seen = {}
    for side, (s, spans) in stamped_runs.items():
        m = SIDES[side]
        nb = s.store.get(s.api.KIND, "ns", "nb")
        header = s.k8s.get_annotation(nb, s.names.TRACE_CONTEXT_ANNOTATION)
        assert header, "trace-context annotation never stamped"
        ctx = m.tracing.parse_traceparent(header)
        assert ctx is not None
        sts = s.store.get("StatefulSet", "ns", "nb")
        assert s.names.TRACE_CONTEXT_ANNOTATION not in \
            (sts["metadata"].get("annotations") or {})
        assert s.names.TRACE_CONTEXT_ANNOTATION not in \
            (sts["spec"]["template"]["metadata"].get("annotations") or {})
        stamper = [sp for sp in spans if sp.name == "reconcile" and
                   sp.span_id == ctx.span_id]
        assert [sp.attributes["controller"] for sp in stamper] == \
            ["notebook-controller"]
        joined = [sp for sp in spans if sp.name == "reconcile" and
                  sp.parent_id == ctx.span_id]
        assert joined and all(sp.trace_id == ctx.trace_id for sp in joined)
        ids = Ids()
        snapshot = s.snapshot()
        stamp = snapshot[(s.api.KIND, "ns", "nb")]["metadata"][
            "annotations"]
        stamp[s.names.TRACE_CONTEXT_ANNOTATION] = (
            ids("trace", ctx.trace_id), ids("span", ctx.span_id))
        seen[side] = {"spans": normalise_spans(spans, side, ids),
                      "snapshot": snapshot,
                      "writes": s.store._last_rv - s.base,
                      "drains": s.drains}
    assert seen["port"] == seen["ref"]


def test_manager_legs_on_every_root(stamped_runs):
    """The whole control plane's reconciles each carry their queue legs,
    and the phase collector's ``reconcile.read``/``reconcile.write``
    legs where the reconcile read or wrote through the echo client, on
    both sides alike."""
    got = {}
    for side, (s, spans) in stamped_runs.items():
        roots = {sp.span_id: sp for sp in spans if sp.name == "reconcile"}
        legs = sorted((roots[sp.parent_id].attributes["controller"],
                       sp.name) for sp in spans
                      if sp.parent_id in roots and sp.name != "reconcile")
        assert all(any(sp.parent_id == r and sp.name == "workqueue.wait"
                       for sp in spans) for r in roots)
        got[side] = {"roots": len(roots), "legs": legs}
    assert got["port"] == got["ref"]
    assert any(name == "reconcile.write" for _, name in got["port"]["legs"])


# ----------------------------------------------------- log correlation
def test_json_log_correlation():
    def case(m, side):
        stream = io.StringIO()
        handler = pylogging.StreamHandler(stream)
        handler.addFilter(m.logging.CorrelationFilter())
        handler.setFormatter(m.logging.JsonFormatter())
        logger = pylogging.getLogger("test.correlation")
        logger.addHandler(handler)
        logger.setLevel(pylogging.INFO)
        logger.propagate = False
        recording(m)
        try:
            token = m.logging.reconcile_key_var.set("ns/nb")
            try:
                with m.tracing.get_tracer("t").start_span(
                        "traced-op") as span:
                    logger.info("inside")
                    want = (f"{span.trace_id:032x}", f"{span.span_id:016x}")
            finally:
                m.logging.reconcile_key_var.reset(token)
            logger.info("outside")
        finally:
            logger.removeHandler(handler)
        inside, outside = [json.loads(line)
                           for line in stream.getvalue().splitlines()]
        assert (inside["trace_id"], inside["span_id"]) == want
        assert inside["reconcile_key"] == "ns/nb"
        # nothing to correlate → the keys are absent, not null
        assert "trace_id" not in outside
        assert "reconcile_key" not in outside
        ids = Ids()
        for rec in (inside, outside):
            rec.pop("ts")
            for k in ("trace_id", "span_id"):
                if k in rec:
                    rec[k] = ids(k[:-3], rec[k])
        return [inside, outside]
    got = both(case)
    assert got["port"] == got["ref"]


def test_text_log_format_has_no_correlation_fields():
    """setup_logging('text') keeps the classic line shape byte for byte:
    the correlation filter rides on the JSON handler only."""
    def case(m, side):
        root = pylogging.getLogger()
        saved_handlers = list(root.handlers)
        saved_level = root.level
        out = []
        try:
            m.logging.setup_logging(fmt="text")
            (handler,) = root.handlers
            assert not any(isinstance(f, m.logging.CorrelationFilter)
                           for f in handler.filters)
            assert not isinstance(handler.formatter,
                                  m.logging.JsonFormatter)
            rec = pylogging.LogRecord("x.y", pylogging.WARNING, __file__, 1,
                                      "line %d", (7,), None)
            rec.created = 0.0
            out.append(handler.formatter.format(rec))
            out.append(root.level)
            m.logging.setup_logging(debug=True, fmt="json")
            (handler,) = root.handlers
            assert any(isinstance(f, m.logging.CorrelationFilter)
                       for f in handler.filters)
            out.append(handler.formatter.format(rec))
            out.append(root.level)
        finally:
            for h in list(root.handlers):
                root.removeHandler(h)
            for h in saved_handlers:
                root.addHandler(h)
            root.setLevel(saved_level)
        return out
    got = both(case)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "1970-01-01T00:00:00Z WARNING x.y line 7"


# ------------------------------------------------ escaping and exemplars
def test_prometheus_label_value_escaping():
    def case(m, side):
        reg = m.metrics.MetricsRegistry(include_notebook_metrics=False)
        c = reg.counter("esc_total", "help with \\ backslash\nand newline")
        c.inc({"path": 'a\\b"c\nd'})
        text = reg.expose()
        assert '# HELP esc_total help with \\\\ backslash\\nand newline' \
            in text
        assert 'esc_total{path="a\\\\b\\"c\\nd"} 1' in text
        # the escaped sample stays one line
        assert len([ln for ln in text.splitlines()
                    if ln.startswith("esc_total{")]) == 1
        return text
    got = both(case)
    assert got["port"] == got["ref"]


def test_histogram_label_escaping_and_exemplar_bucket():
    def case(m, side):
        reg = m.metrics.MetricsRegistry(include_notebook_metrics=False)
        h = reg.histogram("esc_seconds", "h", buckets=(0.1, 1.0))
        h.observe(0.05, {"verb": 'g"et'},
                  exemplar={"trace_id": "ab" * 16, "span_id": "cd" * 8})
        h.observe(0.5, {"verb": 'g"et'})
        h.observe(7.0, {"verb": "put"}, exemplar={"trace_id": "ef" * 16})
        text = reg.expose()
        lines = text.splitlines()
        b01 = [ln for ln in lines if ln.startswith(
            'esc_seconds_bucket{verb="g\\"et",le="0.1"}')]
        b10 = [ln for ln in lines if ln.startswith(
            'esc_seconds_bucket{verb="g\\"et",le="1"}')]
        inf = [ln for ln in lines if ln.startswith(
            'esc_seconds_bucket{verb="g\\"et",le="+Inf"}')]
        assert len(b01) == len(b10) == len(inf) == 1
        # the exemplar rides only the bucket its value fell into
        assert f' # {{span_id="{"cd" * 8}",trace_id="{"ab" * 16}"}} 0.05 ' \
            in b01[0]
        assert " # " not in b10[0] and " # " not in inf[0]
        # past the last bucket: on +Inf
        assert " # " in [ln for ln in lines if ln.startswith(
            'esc_seconds_bucket{verb="put",le="+Inf"}')][0]
        assert h.total_sum() == 7.55 and h.total_count() == 3
        assert [h._exemplar_bucket(v) for v in (0.1, 0.2, 2.0)] == [0, 1, 2]
        return normalise_exposition(text)
    got = both(case)
    assert got["port"] == got["ref"]


def test_histogram_exemplar_from_current_span():
    def case(m, side):
        reg = m.metrics.MetricsRegistry(include_notebook_metrics=False)
        h = reg.histogram("ex_seconds", "h", buckets=(1.0,))
        recording(m)
        with m.tracing.get_tracer("t").start_span("op") as span:
            h.observe(0.5, {"verb": "get"},
                      exemplar=m.tracing.current_exemplar())
            want = f'trace_id="{span.trace_id:032x}"'
        text = reg.expose()
        (line,) = [ln for ln in text.splitlines()
                   if ln.startswith('ex_seconds_bucket{verb="get",le="1"}')]
        assert want in line
        return normalise_exposition(text)
    got = both(case)
    assert got["port"] == got["ref"]


# --------------------------------------------------------- the catalog
# a registration has a receiver identifier before the dot, so prose
# mentions in docstrings stay out
_REGISTRATION_RE = re.compile(
    r'\w\.(?:counter|gauge|histogram)\(\s*(?:#[^\n]*)?\n?\s*"([a-z_0-9]+)"')
PORT = REPO / "kubeflow_tpu_torch"


def test_metric_family_catalog_matches_source():
    """Every family the port's modules register is in the port's
    catalog, and every catalog entry is registered somewhere."""
    found: set[str] = set()
    for path in PORT.rglob("*.py"):
        found |= set(_REGISTRATION_RE.findall(path.read_text()))
    new = found - metrics.METRIC_FAMILY_CATALOG
    gone = metrics.METRIC_FAMILY_CATALOG - found
    assert not new and not gone, (
        f"unlisted in the catalog: {sorted(new)}, listed but not "
        f"registered: {sorted(gone)}")


def test_port_catalog_entries_equal_the_reference():
    """Each family the port registers is one of the reference's, under
    the same label names (a family of the port's own would be a parity
    fault)."""
    assert metrics.METRIC_FAMILY_CATALOG <= ref_metrics.METRIC_FAMILY_CATALOG
    assert set(metrics.METRIC_FAMILY_LABELS) == \
        set(metrics.METRIC_FAMILY_CATALOG)
    for family, labels in metrics.METRIC_FAMILY_LABELS.items():
        assert labels == ref_metrics.METRIC_FAMILY_LABELS[family], family


def _labeled_use_sites():
    """The literal label dicts passed to ``.inc``/``.set``/``.observe``/
    ``.get`` in the port, each mapped to its receiver's family through
    the module's ``x = registry.counter("family", ...)`` registration
    (aliases like ``metric = self._metric`` resolved); dynamic label
    dicts are skipped."""
    sites = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        local = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                call = node.value
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in ("counter", "gauge",
                                           "histogram") and \
                        call.args and isinstance(call.args[0], ast.Constant):
                    for target in node.targets:
                        if isinstance(target, ast.Attribute):
                            local[target.attr] = call.args[0].value
                        elif isinstance(target, ast.Name):
                            local[target.id] = call.args[0].value
        for _ in range(2):
            for node in ast.walk(tree):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, (ast.Attribute, ast.Name)):
                    src = node.value.attr \
                        if isinstance(node.value, ast.Attribute) \
                        else node.value.id
                    if src in local:
                        for target in node.targets:
                            if isinstance(target, ast.Name):
                                local[target.id] = local[src]
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr in ("inc", "set", "observe", "get")):
                continue
            recv = node.func.value
            rname = recv.attr if isinstance(recv, ast.Attribute) else (
                recv.id if isinstance(recv, ast.Name) else "")
            family = local.get(rname)
            if family is None:
                continue
            dicts = [a for a in node.args if isinstance(a, ast.Dict)]
            dicts += [kw.value for kw in node.keywords
                      if kw.arg == "labels" and isinstance(kw.value, ast.Dict)]
            for d in dicts:
                keys = [k.value for k in d.keys
                        if isinstance(k, ast.Constant) and
                        isinstance(k.value, str)]
                if len(keys) == len(d.keys):
                    sites.append((path, node.lineno, family,
                                  frozenset(keys)))
    return sites


def test_metric_label_names_pinned_per_family():
    violations = []
    sites = _labeled_use_sites()
    assert sites
    for path, lineno, family, keys in sites:
        extra = keys - set(metrics.METRIC_FAMILY_LABELS.get(family, ()))
        if extra:
            violations.append(f"{path.name}:{lineno}: {family} uses "
                              f"undeclared label(s) {sorted(extra)}")
    assert not violations, "\n".join(violations)


def test_every_declared_label_is_used_somewhere():
    used: dict = {}
    for _path, _lineno, family, keys in _labeled_use_sites():
        used.setdefault(family, set()).update(keys)
    stale = [f"{family}: {sorted(set(labels) - used.get(family, set()))}"
             for family, labels in sorted(metrics.METRIC_FAMILY_LABELS.items())
             if set(labels) - used.get(family, set())]
    assert not stale, "\n".join(stale)


def test_every_catalog_family_is_referenced_in_tests():
    """Every family the port registers is named in some port test."""
    text = "\n".join(p.read_text() for p in
                     sorted((REPO / "tests").glob("test_torch_*.py")))
    missing = [name for name in sorted(metrics.METRIC_FAMILY_CATALOG)
               if name not in text]
    assert not missing, f"families no port test names: {missing}"


class _IdleEngine:
    """An engine the serving front mirrors at scrape: one counter."""
    requests_total = 0

    def close(self) -> None:
        pass


def test_notebook_and_serving_series_exported():
    """The registry's five notebook series (``notebook_create_total``,
    ``notebook_create_failed_total``, ``notebook_culling_total`` and
    ``last_notebook_culling_timestamp_seconds`` through
    ``record_culling``, ``notebook_running``) and the serving front's
    (``serving_http_requests_total``, ``serving_generate_seconds_sum``,
    ``serving_generate_seconds_count``, the mirrored engine counter)
    expose alike on both sides (the culling timestamp's value is the
    clock's, masked)."""
    from kubeflow_tpu.runtime.server import ServingServer as RefServer
    from kubeflow_tpu_torch.runtime.server import ServingServer

    def case(m, side):
        reg = m.metrics.MetricsRegistry()
        reg.notebook_create_total.inc()
        reg.notebook_create_failed_total.inc()
        reg.record_culling("ns", "nb")
        reg.notebook_running.set(2)
        text = reg.expose()
        for family in ("notebook_create_total", "notebook_create_failed_total",
                       "notebook_culling_total", "notebook_running",
                       "last_notebook_culling_timestamp_seconds"):
            assert f"# TYPE {family} " in text
        srv = (RefServer if side == "ref" else ServingServer)(
            _IdleEngine(), None, port=0)
        try:
            served = srv.metrics.expose()
        finally:
            srv.stop()
        for family in ("serving_http_requests_total",
                       "serving_generate_seconds_sum",
                       "serving_generate_seconds_count",
                       "serving_engine_requests_total"):
            assert f"# TYPE {family} " in served
        return [re.sub(r"^(last_notebook_culling_timestamp_seconds) .*",
                       r"\1 <time>", ln)
                for ln in (text + served).splitlines()]
    got = both(case)
    assert got["port"] == got["ref"]


def test_workqueue_families_exported_via_manager():
    """The manager's families land in one exposition when a manager
    drains against an attached registry: the same series on both sides
    (their values are durations, so only the samples' names and labels
    are compared)."""
    def case(m, side):
        s = Stack(side)
        reg = m.metrics.MetricsRegistry()
        mgr = m.Manager(s.store)
        mgr.attach_metrics(reg)
        rec = _Rec()
        rec.name = "r"
        mgr.register(rec)
        mgr.enqueue("r", s.Request("ns", "x"))
        assert mgr.run_until_idle(timeout=10) == 1 and rec.calls == 1
        text = reg.expose()
        for family in ("workqueue_adds_total", "workqueue_depth",
                       "workqueue_queue_duration_seconds",
                       "workqueue_work_duration_seconds",
                       "controller_runtime_reconcile_total",
                       "workqueue_unfinished_work_seconds",
                       "workqueue_longest_running_processor_seconds"):
            assert family in text, f"{family} missing from the exposition"
        return sorted(_parse_prometheus(text))
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------------------ the wire's server half
def _wire_side(side):
    """The apiserver, store and APF modules of one side."""
    if side == "ref":
        from kubeflow_tpu.cluster import apf as w_apf
        from kubeflow_tpu.cluster import apiserver as w_apiserver
        from kubeflow_tpu.cluster import store as w_store
    else:
        from kubeflow_tpu_torch.cluster import apf as w_apf
        from kubeflow_tpu_torch.cluster import apiserver as w_apiserver
        from kubeflow_tpu_torch.cluster import store as w_store
    return SimpleNamespace(apf=w_apf, apiserver=w_apiserver, store=w_store)


def test_apf_metric_families_exported():
    """The APF half of tests/test_observability.py's
    ``test_shard_and_apf_metric_families_exported`` (the shard map waits
    for the sharded manager): the flow-control trio by priority_level."""
    def case(m, side):
        w = _wire_side(side)
        metrics = m.metrics.MetricsRegistry()
        dispatcher = w.apf.APFDispatcher(queue_wait_s=0.1)
        dispatcher.attach_metrics(metrics)
        meta = {"user_agent": "kubeflow-tpu-manager/m0", "verb": "list",
                "kind": "Pod"}
        dispatcher.release(dispatcher.acquire(meta))
        tenant = {"user_agent": "tenant", "verb": "list", "kind": "Pod"}
        held = [dispatcher.acquire(tenant)
                for _ in range(dispatcher.total_seats)]
        with pytest.raises(w.apf.RejectedError):
            dispatcher.acquire(tenant)
        for t in held:
            dispatcher.release(t)
        text = metrics.expose()
        assert 'apf_dispatched_total{priority_level="workload-high"} 1' \
            in text
        assert 'apf_rejected_total{priority_level="global-default"} 1' \
            in text
        assert 'apf_current_inqueue{priority_level="global-default"} 0' \
            in text
        t2, queued = dispatcher.acquire_info(meta)
        assert queued is False
        dispatcher.release(t2)
        return normalise_exposition(text)
    got = both(case)
    assert got["port"] == got["ref"]


def test_watch_path_metric_families_exported():
    """The server and store families of tests/test_observability.py's
    case (the client's two wait for the port's client): ring evictions
    by kind, the watch queue's coalescing counter, and the fan-out and
    cache-LIST families ``ApiServerProxy.attach_metrics`` registers,
    with the store's lock-hold histograms beside them."""
    from kubeflow_tpu.cluster.http_client import HttpApiClient

    def case(m, side):
        w = _wire_side(side)
        store = w.store.ClusterStore()
        store.watch_cache_capacity = 1
        metrics = m.metrics.MetricsRegistry()
        proxy = w.apiserver.ApiServerProxy(store)
        proxy.attach_metrics(metrics)
        proxy.start()
        client = HttpApiClient(proxy.url)
        try:
            for name in ("a", "b"):
                client.create({"kind": "ConfigMap", "apiVersion": "v1",
                               "metadata": {"name": name, "namespace": "ns"}})
            coalesce = metrics.counter("watch_queue_coalesced_total", "")
            q = w.apiserver._WatcherQueue(
                soft_limit=0,
                on_coalesce=lambda: coalesce.inc({"kind": "ConfigMap"}))
            obj = {"kind": "ConfigMap",
                   "metadata": {"name": "a", "namespace": "ns"}}
            q.put(w.store.EventFrame(1, "ADDED", obj))
            q.put(w.store.EventFrame(2, "MODIFIED", obj))
        finally:
            client.close()
            proxy.stop()
        text = metrics.expose()
        assert 'watch_cache_evictions_total{kind="ConfigMap"} 1' in text
        assert 'watch_queue_coalesced_total{kind="ConfigMap"} 1' in text
        for family in ("watch_fanout_bytes_total", "watch_frames_sent_total",
                       "apiserver_cache_lists_total",
                       "store_list_lock_seconds",
                       'store_write_lock_seconds_count{kind="ConfigMap"} 2'):
            assert family in text, family
        return [ln for ln in normalise_exposition(text)
                if "_seconds_sum" not in ln and "_seconds_bucket" not in ln]
    got = both(case)
    assert got["port"] == got["ref"]


def _wait_for_server_side(exporter, audit, timeout: float = 10.0) -> None:
    """Until ``exporter`` holds the server's three spans and ``audit`` its
    line, or ``timeout`` seconds have passed (the assertions then fail as
    they would have)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(exporter.by_name(name) for name in (
                "apiserver.request", "apf.wait", "apiserver.handle")) \
                and audit.exists() and audit.read_text().strip():
            return
        time.sleep(0.01)


def test_wire_spans_traceparent_and_audit(tmp_path):
    """The server half of tests/test_observability.py's case: the
    reference's client, in a span of its own recording provider, creates
    through each side's apiserver (recording with its side's provider);
    the server's ``apiserver.request`` joins the client's trace through
    the traceparent header, ``apf.wait`` and ``apiserver.handle`` hang
    under it, and the audit line carries the trace id."""
    from kubeflow_tpu.cluster.http_client import HttpApiClient

    def case(m, side):
        w = _wire_side(side)
        client_exporter = ref_tracing.InMemorySpanExporter()
        ref_tracing.set_provider(ref_tracing.SDKProvider(client_exporter))
        server_exporter = client_exporter if side == "ref" else recording(m)
        audit = tmp_path / f"{side}.ndjson"
        proxy = w.apiserver.ApiServerProxy(w.store.ClusterStore(),
                                           audit_log=str(audit))
        proxy.start()
        client = HttpApiClient(proxy.url)
        try:
            with ref_tracing.get_tracer("test").start_span("op"):
                client.create({"kind": "ConfigMap", "apiVersion": "v1",
                               "metadata": {"name": "a", "namespace": "ns"}})
            # the handler thread ends its spans after the body reached
            # the client, and stopping the server does not join it: wait
            # for the three server spans and the audit line
            _wait_for_server_side(server_exporter, audit)
        finally:
            client.close()
            proxy.stop()
            ref_tracing.set_provider(ref_tracing.NoopProvider())
        op = client_exporter.by_name("op")[0]
        rest = client_exporter.by_name("rest.post")[0]
        server = server_exporter.by_name("apiserver.request")[0]
        apf_wait = server_exporter.by_name("apf.wait")[0]
        handle = server_exporter.by_name("apiserver.handle")[0]
        assert server.trace_id == op.trace_id
        assert server.parent_id == rest.span_id
        assert apf_wait.parent_id == server.span_id
        assert "apf.queued" in apf_wait.attributes
        assert handle.parent_id == server.span_id
        line = json.loads(audit.read_text().splitlines()[0])
        assert line["trace_id"] == f"{op.trace_id:032x}"
        # two providers draw their span ids apart (and may draw the same
        # numbers): a server span's parent is named, not tokenised
        spans = normalise_spans([op, rest], "ref")
        for span, raw in zip(normalise_spans([server, apf_wait, handle],
                                             side),
                             (server, apf_wait, handle)):
            span.pop("span_id")
            span["trace_id"] = raw.trace_id == op.trace_id
            parent = (rest, "rest.post") if raw is server \
                else (server, "apiserver.request")
            span["parent_id"] = parent[1] \
                if raw.parent_id == parent[0].span_id else "<other>"
            spans.append(span)
        line["trace_id"] = line["trace_id"] == f"{op.trace_id:032x}"
        line.pop("ts")
        line.pop("peer")
        return spans, line
    got = both(case)
    assert got["port"] == got["ref"]


def test_audit_trace_id_without_server_side_recording(tmp_path):
    """tests/test_observability.py's case on each side: the apiserver
    records no spans, yet its audit line carries the client's trace id
    from the traceparent header."""
    def case(m, side):
        w = _wire_side(side)
        audit = tmp_path / f"{side}.ndjson"
        proxy = w.apiserver.ApiServerProxy(w.store.ClusterStore(),
                                           audit_log=str(audit))
        proxy.start()
        try:
            req = urllib.request.Request(
                f"{proxy.url}/api/v1/namespaces/ns/configmaps",
                data=json.dumps({"kind": "ConfigMap", "apiVersion": "v1",
                                 "metadata": {"name": "a",
                                              "namespace": "ns"}}).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8
                         + "-01"},
                method="POST")
            with urllib.request.urlopen(req, timeout=5) as resp:
                assert resp.status == 201
        finally:
            proxy.stop()
        line = json.loads(audit.read_text().splitlines()[0])
        assert line["trace_id"] == "ab" * 16
        line.pop("ts")
        line.pop("peer")
        return line
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------------- the binaries' cases (election,
# sharding, the CLI's timeline), each the reference's own body
# each case, and whether an elector's own thread renews in it (its
# renewals then count as many writes as rounds ran)
ELECTION_CASES = {"test_single_candidate_acquires_and_renews": False,
                  "test_second_candidate_blocked_until_lease_expires": False,
                  "test_release_hands_over_immediately": False,
                  "test_manager_parks_until_leader": True}


def _renew_masked(objs, threaded: bool) -> list:
    out = []
    for o in objs:
        o = normalise_object(o, "port")
        if o.get("kind") == "Lease" and o["spec"].get("renewTime"):
            o["spec"]["renewTime"] = "<renewed>"
        if threaded:
            for key in ("resourceVersion", "generation"):
                o["metadata"].pop(key, None)
        out.append(o)
    return sorted(out, key=json.dumps)


@pytest.mark.parametrize("name", sorted(ELECTION_CASES))
def test_election_case_on_both_sides(name):
    """tests/test_observability.py's election case on each side's
    ``LeaderElector``, ``Manager`` and store: its own assertions, then
    equal Leases (renew times masked) and, where no elector thread
    renews, equal writes."""
    threaded = ELECTION_CASES[name]
    got = {}
    for side, s in WIRE_SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_observability, name, s, mp)
        got[side] = [(_renew_masked(st.all_objects(), threaded),
                      None if threaded else st._last_rv)
                     for st in made["ClusterStore"]]
    assert got["port"] == got["ref"]


def test_shard_and_apf_metric_families_exported():
    """The whole of tests/test_observability.py's family case on each
    side, the shard half now with it: ``shard_ownership`` by shard and
    manager (1 while held, 0 after the graceful stop) and
    ``shard_rebalance_total`` by manager, beside the APF trio; equal
    expositions (timing samples dropped)."""
    got = {}
    for side, s in WIRE_SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_observability,
                                 "test_shard_and_apf_metric_families_exported",
                                 s, mp, keep=("MetricsRegistry",),
                                 inline=("apf", "sharding"))
        got[side] = [normalise_exposition(r.expose())
                     for r in made["MetricsRegistry"]]
        assert any("shard_ownership" in ln for ln in got[side][0])
    assert got["port"] == got["ref"]


def test_render_trace_timeline():
    """tests/test_observability.py's case on each side's
    ``cli.render_trace``, then both renderers on 60 seeded span trees:
    equal text (critical path, error and retry marks, the phase footer,
    the lifecycle line)."""
    import numpy as np

    from kubeflow_tpu import cli as ref_cli
    from kubeflow_tpu_torch import cli
    for side, s in WIRE_SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            binaries_case(ref_observability, "test_render_trace_timeline",
                          s, mp, inline=("cli",))
    rng = np.random.default_rng(24)
    names_ = ["reconcile", "workqueue.wait", "workqueue.enqueue",
              "rest.get", "rest.patch", "apiserver.request", "apf.wait",
              "reconcile.read", "reconcile.write"]
    for _ in range(60):
        traces = []
        for t in range(int(rng.integers(0, 4))):
            spans = []
            for i in range(int(rng.integers(1, 9))):
                start = 100.0 + float(rng.uniform(0, 1))
                dur = float(rng.uniform(0, 0.5))
                parent = f"{int(rng.integers(0, i)):016x}" if i else None
                attrs = {"retries": int(rng.integers(0, 3))} \
                    if rng.integers(2) else {}
                spans.append({
                    "name": names_[rng.integers(len(names_))],
                    "trace_id": f"{t:032x}", "span_id": f"{i:016x}",
                    "parent_id": parent, "start": start,
                    "end": start + dur, "duration_s": dur,
                    "status": ["OK", "UNSET", "ERROR"][rng.integers(3)],
                    "attributes": attrs, "events": []})
            traces.append({"trace_id": f"{t:032x}", "spans": spans})
        payload = {"namespace": "ns", "name": "nb", "traces": traces}
        assert cli.render_trace(payload) == ref_cli.render_trace(payload)
        assert cli._critical_path(payload["traces"][0]["spans"]
                                  if traces else []) == \
            ref_cli._critical_path(payload["traces"][0]["spans"]
                                   if traces else [])
