"""The port's start-span path of the tracing module held against the
reference's (``kubeflow_tpu_torch/utils/tracing.py`` against
``kubeflow_tpu/utils/tracing.py``): the W3C ``traceparent`` carrier on the
same headers, well-formed and malformed; the no-op provider's one shared
context manager; and the recording provider's spans (ids, parentage, an
explicit remote parent winning over the thread's stack, attributes,
events, an exception recorded and re-raised), compared field for field
but the wall-clock times. Each case restores the no-op provider in a
``finally``.
"""

from __future__ import annotations

import dataclasses

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
