"""The port's start-span path of the tracing module held against the
reference's (``kubeflow_tpu_torch/utils/tracing.py`` against
``kubeflow_tpu/utils/tracing.py``): the W3C ``traceparent`` carrier on the
same headers, well-formed and malformed; the no-op provider's one shared
context manager; and the recording provider's spans (ids, parentage, an
explicit remote parent winning over the thread's stack, attributes,
events, an exception recorded and re-raised), compared field for field
but the wall-clock times. Each case restores the no-op provider in a
``finally``. Then the recorder's side: ``trace_phase_breakdown`` on 300
seeded span-dict sets (equal floats), and ``FlightRecorder`` fed one
seeded stream of 2000 spans over 50 keys at small bounds (equal
``trace_for`` and ``keys`` after every 100 spans, the bounds held).
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from kubeflow_tpu.utils import tracing as ref_tracing
from kubeflow_tpu_torch.utils import tracing

SIDES = {"ref": ref_tracing, "port": tracing}

HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01\n",
    "00-00000000000000000000000000000001-0000000000000001-01",
    # malformed: restart the trace, never fail
    None, "", "garbage",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-1",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-extra",
]


def _ctx(c):
    return None if c is None else (c.trace_id, c.span_id)


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_and_format_as_the_reference(header):
    got = {side: t.parse_traceparent(header) for side, t in SIDES.items()}
    assert _ctx(got["port"]) == _ctx(got["ref"])
    if got["port"] is not None:
        # a parsed context formats back to the canonical sampled header
        assert tracing.format_traceparent(got["port"]) == \
            ref_tracing.format_traceparent(got["ref"])
        assert tracing.parse_traceparent(
            tracing.format_traceparent(got["port"])) == got["port"]


def test_noop_provider_hands_out_one_shared_context_manager():
    for t in SIDES.values():
        assert not t.is_recording()
        tracer = t.get_tracer("x")
        cm1, cm2 = tracer.start_span("a"), tracer.start_span("b", {"k": 1})
        assert cm1 is cm2
        with cm1 as span:
            span.set_attribute("k", "v")
            span.add_event("e")
            span.record_exception(ValueError("boom"))
            assert span.context() is None


def _record(t):
    """Spans of one scenario on side ``t``'s recording provider, with the
    wall-clock times dropped."""
    exporter = t.InMemorySpanExporter()
    t.set_provider(t.SDKProvider(exporter))
    try:
        assert t.is_recording()
        tracer = t.get_tracer("kubeflow_tpu_torch.slicerepair")
        remote = t.parse_traceparent(
            "00-000000000000000000000000000000aa-00000000000000bb-01")
        with tracer.start_span("root", {"k8s.name": "nb"}) as root:
            root.set_attribute("migration.duration_s", 1.5)
            with tracer.start_span("child") as child:
                child.add_event("step", {"n": 1})
            with tracer.start_span("stitched", parent=remote):
                with tracer.start_span("nested"):
                    pass
        with pytest.raises(RuntimeError):
            with tracer.start_span("failing"):
                raise RuntimeError("boom")
        assert t.format_traceparent(root.context()).startswith("00-")
        spans = exporter.spans
        assert [s.name for s in exporter.by_name("child")] == ["child"]
        exporter.reset()
        assert exporter.spans == []
    finally:
        t.set_provider(t.NoopProvider())
    out = []
    for s in spans:
        d = dataclasses.asdict(s)
        d.pop("start_time"), d.pop("end_time")
        for ev in d["events"]:
            ev.pop("timestamp")
        out.append(d)
    return out


def test_recording_provider_spans_as_the_reference():
    got = {side: _record(t) for side, t in SIDES.items()}
    assert got["port"] == got["ref"]
    by_name = {s["name"]: s for s in got["port"]}
    assert by_name["stitched"]["trace_id"] == 0xaa
    assert by_name["stitched"]["parent_id"] == 0xbb
    assert by_name["nested"]["parent_id"] == by_name["stitched"]["span_id"]
    assert by_name["failing"]["status"] == tracing.STATUS_ERROR
    assert not tracing.is_recording()


def _span_dicts(rng: random.Random) -> list:
    """One trace's span dicts as the recorder renders them: workqueue,
    rest, apf and reconcile legs at seeded times (an empty set now and
    then)."""
    out = []
    for i in range(rng.randint(0, 12)):
        start = rng.uniform(1.7e9, 1.7e9 + 10)
        end = start + rng.choice([0.0, rng.uniform(0, 2), -0.5])
        out.append({
            "name": rng.choice(["reconcile", "workqueue.wait",
                                "workqueue.enqueue", "rest.get",
                                "rest.patch", "apf.wait", "apiserver.handle",
                                "reconcile.read"]),
            "start": start, "end": end,
            "duration_s": max(end - start, 0.0)})
    return out


def test_trace_phase_breakdown_on_seeded_span_sets():
    for seed in range(300):
        got = {side: t.trace_phase_breakdown(_span_dicts(random.Random(seed)))
               for side, t in SIDES.items()}
        assert got["port"] == got["ref"], seed
        assert set(got["port"]) == {"wall", "queue", "apf", "wire",
                                    "reconcile"}


def _stream(t, seed: int, n: int = 2000, keys: int = 50) -> list:
    """``n`` finished spans of side ``t`` over a pool of trace ids, a
    fifth of them carrying one of ``keys`` reconcile keys."""
    rng = random.Random(seed)
    traces = [rng.getrandbits(64) + 1 for _ in range(400)]
    spans = []
    for i in range(n):
        attrs = {}
        if rng.random() < 0.2:
            attrs[t.KEY_ATTRIBUTE] = f"ns-{rng.randrange(5)}/nb-" \
                                     f"{rng.randrange(keys // 5)}"
        start = 1.7e9 + i * 0.001 + rng.uniform(0, 0.5)
        spans.append(t.Span(
            name=rng.choice(["reconcile", "workqueue.wait", "child"]),
            tracer="t", trace_id=rng.choice(traces),
            span_id=i + 1, parent_id=rng.choice([None, i, i // 2 + 1]),
            attributes=attrs, start_time=start,
            end_time=start + rng.uniform(0, 0.1)))
    return spans


@pytest.mark.parametrize("bounds", [
    {"max_traces": 64, "traces_per_key": 3, "max_spans_per_trace": 5},
    {"max_traces": 16, "traces_per_key": 1, "max_spans_per_trace": 2}])
def test_flight_recorder_on_a_seeded_stream(bounds):
    inners = {side: t.InMemorySpanExporter() for side, t in SIDES.items()}
    recs = {side: t.FlightRecorder(inner=inners[side], **bounds)
            for side, t in SIDES.items()}
    streams = {side: _stream(t, seed=11) for side, t in SIDES.items()}
    all_keys = sorted({s.attributes[tracing.KEY_ATTRIBUTE]
                       for s in streams["port"]
                       if tracing.KEY_ATTRIBUTE in s.attributes})
    assert len(all_keys) == 50
    for i in range(len(streams["port"])):
        for side in SIDES:
            recs[side].export(streams[side][i])
        if (i + 1) % 100:
            continue
        got = {side: (rec.keys(),
                      [rec.trace_for(*k.split("/")) for k in all_keys])
               for side, rec in recs.items()}
        assert got["port"] == got["ref"], i
        rec = recs["port"]
        assert len(rec._traces) <= bounds["max_traces"]
        assert all(len(ring) <= bounds["traces_per_key"]
                   for ring in rec._by_key.values())
        assert all(len(t["spans"]) <= bounds["max_spans_per_trace"]
                   for traces in got["port"][1] for t in traces)
    # the decorator tees every span, held or not
    assert len(inners["port"].spans) == len(inners["ref"].spans) == 2000
