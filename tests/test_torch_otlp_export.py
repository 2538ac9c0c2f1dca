"""The port's OTLP/HTTP exporter held against the reference's: the four
cases of tests/test_otlp_export.py through both packages, each side
posting to a local collector of its own, the paths, content types and
every span of the captured request bodies (with its resource and
scope) compared after normalisation (span and trace ids as ordinal
tokens, times dropped, the tracer prefix ``kubeflow_tpu.`` mapped onto
``kubeflow_tpu_torch.``, each side's images as tokens); and ``_encode``
on 200 seeded span sets (every attribute type, events, statuses with
and without a message, spans with and without a parent, several
tracers), whose ExportTraceServiceRequest bodies must be equal JSON.
Every exporter is shut down, every collector stopped and the no-op
provider restored in a ``finally``.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

from kubeflow_tpu.utils import tracing as ref_tracing
from kubeflow_tpu_torch.utils import tracing
from torch_parity import Ids, Stack, normalise_result, tracer_name

SIDES = {"ref": ref_tracing, "port": tracing}
WAIT = 10.0


class Collector:
    """A minimal OTLP collector: keeps each POST's path, content type
    and JSON body."""

    def __init__(self):
        received: list = []
        self.received = received
        self.posted = threading.Event()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                received.append({"path": self.path,
                                 "content_type": self.headers["Content-Type"],
                                 "body": json.loads(body)})
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")
                outer.posted.set()

            def log_message(self, *a):
                pass

        self._srv = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._srv.server_port}"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._thread.join(timeout=WAIT)
        self._srv.server_close()


def _find_spans(received, name=None):
    spans = []
    for req in received:
        for rs in req["body"]["resourceSpans"]:
            for ss in rs["scopeSpans"]:
                for span in ss["spans"]:
                    if name is None or span["name"] == name:
                        spans.append((rs, ss, span))
    return spans


_TIMES = ("startTimeUnixNano", "endTimeUnixNano", "timeUnixNano")


def normalise_body(body, side: str, ids: Ids) -> object:
    """An ExportTraceServiceRequest body with ids as ordinal tokens, the
    times dropped and the scope names mapped."""
    if isinstance(body, list):
        return [normalise_body(x, side, ids) for x in body]
    if not isinstance(body, dict):
        return normalise_result(body, side)
    out = {}
    for k, v in body.items():
        if k in _TIMES:
            continue
        if k == "traceId":
            out[k] = ids("trace", v)
        elif k in ("spanId", "parentSpanId"):
            out[k] = ids("span", v)
        elif k == "scope":
            out[k] = {"name": tracer_name(v["name"])}
        else:
            out[k] = normalise_body(v, side, ids)
    return out


def normalise_posts(received, side: str) -> dict:
    """The posts' paths and content types, and every span they carried
    with its resource and scope, in order (how the flusher split them
    into posts is timing, not compared)."""
    ids = Ids()
    return {"posts": sorted({(r["path"], r["content_type"])
                             for r in received}),
            "spans": [normalise_body({"resource": rs["resource"],
                                      "scope": ss["scope"], "span": span},
                                     side, ids)
                      for rs, ss, span in _find_spans(received)]}


def run(case) -> dict:
    """``case(tracing, side, collector)`` on each side against a
    collector of its own; {side: what it returned}."""
    out = {}
    for side, t in SIDES.items():
        collector = Collector()
        try:
            out[side] = case(t, side, collector)
        finally:
            t.set_provider(t.NoopProvider())
            collector.stop()
    return out


def test_admission_span_lands_in_captured_otlp_post():
    def case(t, side, collector):
        s = Stack(side)
        exporter = t.OtlpHttpExporter(collector.url,
                                      service_name="kubeflow-tpu",
                                      flush_interval_s=0.1)
        try:
            t.set_provider(t.SDKProvider(exporter))
            s.api.install_notebook_crd(s.store)
            webhook = s.wh.Mutating(s.store, s.Config())
            webhook.handle("CREATE", s.api.new_notebook("traced-nb", "ns1"),
                           None)
            exporter.force_flush()
        finally:
            exporter.shutdown()
        received = collector.received
        assert received, "collector received no POST"
        assert received[0]["path"] == "/v1/traces"
        assert received[0]["content_type"] == "application/json"
        matches = _find_spans(received, "notebook-mutating-webhook")
        assert matches, "admission root span missing from OTLP payload"
        rs, ss, span = matches[0]
        res_attrs = {a["key"]: a["value"]
                     for a in rs["resource"]["attributes"]}
        assert res_attrs["service.name"] == {"stringValue": "kubeflow-tpu"}
        assert tracer_name(ss["scope"]["name"]) == \
            "kubeflow_tpu_torch.webhook"
        attrs = {a["key"]: a["value"] for a in span["attributes"]}
        assert attrs["notebook.name"] == {"stringValue": "traced-nb"}
        assert attrs["notebook.namespace"] == {"stringValue": "ns1"}
        assert attrs["admission.operation"] == {"stringValue": "CREATE"}
        assert len(span["traceId"]) == 32 and len(span["spanId"]) == 16
        assert int(span["endTimeUnixNano"]) >= int(span["startTimeUnixNano"])
        assert span["status"]["code"] in (0, 1, 2)
        return normalise_posts(received, side)
    got = run(case)
    assert got["port"] == got["ref"]


def test_child_spans_share_trace_and_parent():
    def case(t, side, collector):
        exporter = t.OtlpHttpExporter(collector.url, flush_interval_s=0.1)
        try:
            t.set_provider(t.SDKProvider(exporter))
            tracer = t.get_tracer("t")
            with tracer.start_span("root"):
                with tracer.start_span("child") as child:
                    child.add_event("evt", {"k": "v", "n": 3, "ok": True})
            exporter.force_flush()
        finally:
            exporter.shutdown()
        received = collector.received
        (_, _, root) = _find_spans(received, "root")[0]
        (_, _, child) = _find_spans(received, "child")[0]
        assert child["traceId"] == root["traceId"]
        assert child["parentSpanId"] == root["spanId"]
        ev = child["events"][0]
        assert {a["key"]: a["value"] for a in ev["attributes"]} == {
            "k": {"stringValue": "v"}, "n": {"intValue": "3"},
            "ok": {"boolValue": True}}
        return normalise_posts(received, side)
    got = run(case)
    assert got["port"] == got["ref"]


def test_dead_collector_never_raises_into_the_hot_path():
    def case(t, side, collector):
        exporter = t.OtlpHttpExporter("http://127.0.0.1:1",  # nothing there
                                      timeout_s=0.2, flush_interval_s=0.05)
        try:
            t.set_provider(t.SDKProvider(exporter))
            tracer = t.get_tracer("t")
            for _ in range(5):
                with tracer.start_span("s"):
                    pass
            exporter.force_flush()   # swallows the connection error
            t.set_provider(t.NoopProvider())
        finally:
            exporter.shutdown()
        assert exporter.failed_total >= 1
        assert exporter.exported_total == 0
        # every span was handed over and none reached a collector
        return exporter.failed_total, exporter.exported_total, \
            collector.received
    got = run(case)
    assert got["port"] == got["ref"] == (5, 0, [])


def test_batching_flushes_on_size():
    def case(t, side, collector):
        exporter = t.OtlpHttpExporter(collector.url, batch_size=3,
                                      flush_interval_s=60.0)
        try:
            t.set_provider(t.SDKProvider(exporter))
            tracer = t.get_tracer("t")
            for i in range(3):
                with tracer.start_span(f"s{i}"):
                    pass
            assert collector.posted.wait(WAIT), \
                "size-triggered flush never fired"
            received = list(collector.received)
        finally:
            exporter.shutdown()
        assert len(_find_spans(received)) == 3
        return normalise_posts(received, side)
    got = run(case)
    assert got["port"] == got["ref"]


# ------------------------------------------------- _encode on seeded spans
_VALUES = (lambda r: r.random() < 0.5,
           lambda r: r.randint(-10**12, 10**12),
           lambda r: r.uniform(-1e3, 1e3),
           lambda r: r.choice(["", "v", "ns/nb", "é ünïcode", "a\nb"]),
           lambda r: None,
           lambda r: [1, 2])


def _attrs(rng: random.Random) -> dict:
    return {f"k{i}": rng.choice(_VALUES)(rng)
            for i in range(rng.randint(0, 4))}


def _span_set(t, rng: random.Random) -> list:
    spans = []
    for i in range(rng.randint(1, 8)):
        start = rng.uniform(1.7e9, 1.8e9)
        status = rng.choice([t.STATUS_UNSET, t.STATUS_OK, t.STATUS_ERROR,
                             "SOMETHING-ELSE"])
        span = t.Span(
            name=rng.choice(["reconcile", "workqueue.wait", "rest.get",
                             f"s{i}"]),
            tracer=rng.choice(["kubeflow_tpu_torch.manager",
                               "kubeflow_tpu_torch.webhook", "t"]),
            trace_id=rng.getrandbits(128) or 1,
            span_id=rng.getrandbits(64) or 1,
            parent_id=None if rng.random() < 0.3 else rng.getrandbits(64),
            attributes=_attrs(rng), status=status,
            status_description=rng.choice(["", "boom"]),
            start_time=start, end_time=start + rng.uniform(0, 5))
        for _ in range(rng.randint(0, 3)):
            span.events.append(t.SpanEvent(
                rng.choice(["exception", "image-swapped", "e"]),
                _attrs(rng), start + rng.uniform(0, 5)))
        spans.append(span)
    return spans


def test_encode_seeded_span_sets_as_the_reference():
    """200 seeded span sets: each side's exporter encodes its own copy of
    the same spans (made from one seed per set) into equal JSON, ids,
    times and all."""
    exporters = {side: t.OtlpHttpExporter("http://127.0.0.1:1",
                                          flush_interval_s=60.0)
                 for side, t in SIDES.items()}
    try:
        for seed in range(200):
            bodies = {}
            for side, t in SIDES.items():
                spans = _span_set(t, random.Random(seed))
                bodies[side] = json.dumps(exporters[side]._encode(spans),
                                          sort_keys=True)
            assert bodies["port"] == bodies["ref"], seed
    finally:
        for exporter in exporters.values():
            exporter.shutdown()
    assert all(e.exported_total == e.failed_total == 0
               for e in exporters.values())
