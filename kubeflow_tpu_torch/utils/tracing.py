"""Spans for the control plane, stdlib only.

The port's copy of ``kubeflow_tpu/utils/tracing.py``: an OTel-like API
(``get_tracer(name).start_span(...)`` as a context manager, attributes,
events, status) over a pluggable provider, and the W3C ``traceparent``
carrier (``format_traceparent``/``parse_traceparent``) that stitches a
span onto a notebook's lifecycle trace. The default provider is a no-op
that hands out one shared context manager, so the tracing-off path
allocates nothing; ``set_provider(SDKProvider(exporter))`` installs a
recording one. ``exporter`` is anything with ``export(span)``:

- ``InMemorySpanExporter`` collects spans in memory;
- ``OtlpHttpExporter`` posts them, buffered, as OTLP/HTTP JSON to a
  collector's ``/v1/traces`` (the reference's wire format and default
  ``service_name``), and never raises into the traced path;
- ``FlightRecorder`` keeps the last traces of each notebook (bound by
  the ``reconcile.key`` attribute the manager sets on its reconcile
  roots), optionally teeing every span to an ``inner`` exporter; the
  health server's ``/debug/notebooks/<ns>/<name>/trace`` reads it.

``Tracer.emit_span`` exports a span already finished (the manager's
``workqueue.*`` and ``reconcile.read``/``reconcile.write`` legs);
``current_context``/``current_exemplar`` give the innermost open span's
context, for a carrier or a histogram exemplar;
``trace_phase_breakdown`` splits one trace's wall time into queue, wire
and reconcile. Plain ``threading`` locks stand in for the reference's
tracked ones.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time
import urllib.request
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

STATUS_UNSET = "UNSET"
STATUS_OK = "OK"
STATUS_ERROR = "ERROR"

# the span attribute that binds a trace to a notebook for the flight
# recorder (set on reconcile root spans by the manager)
KEY_ATTRIBUTE = "reconcile.key"


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: what crosses process and
    controller boundaries, as a W3C ``traceparent`` header on the wire and
    as an object annotation between controllers."""

    trace_id: int
    span_id: int


# W3C trace-context: version "00", 16-byte trace-id, 8-byte parent-id,
# 1-byte flags, all lowercase hex. All-zero ids are invalid per spec.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id:032x}-{ctx.span_id:016x}-01"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Strict W3C traceparent parse; a malformed header yields None (the
    propagation spec says restart the trace, never fail the request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    trace_id = int(m.group(1), 16)
    span_id = int(m.group(2), 16)
    if trace_id == 0 or span_id == 0:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


@dataclass
class SpanEvent:
    name: str
    attributes: dict[str, object]
    timestamp: float


@dataclass
class Span:
    name: str
    tracer: str
    trace_id: int
    span_id: int
    parent_id: int | None
    attributes: dict[str, object] = field(default_factory=dict)
    events: list[SpanEvent] = field(default_factory=list)
    status: str = STATUS_UNSET
    status_description: str = ""
    start_time: float = 0.0
    end_time: float = 0.0

    def set_attribute(self, key: str, value: object) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: dict | None = None) -> None:
        self.events.append(SpanEvent(name, dict(attributes or {}),
                                     time.time()))

    def set_status(self, status: str, description: str = "") -> None:
        self.status = status
        self.status_description = description

    def record_exception(self, exc: BaseException) -> None:
        self.add_event("exception", {
            "exception.type": type(exc).__name__,
            "exception.message": str(exc),
        })
        self.set_status(STATUS_ERROR, str(exc))

    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)


class _NoopSpan:
    """Attribute/event sink that records nothing: the span of the default
    provider, like OTel's no-op TracerProvider."""

    def set_attribute(self, key: str, value: object) -> None: ...

    def add_event(self, name: str, attributes: dict | None = None) -> None: ...

    def set_status(self, status: str, description: str = "") -> None: ...

    def record_exception(self, exc: BaseException) -> None: ...

    def context(self) -> None:
        return None


_NOOP_SPAN = _NoopSpan()


class _NoopSpanCM:
    """Reusable no-op context manager: ``NoopProvider.span`` hands out ONE
    shared instance, so the tracing-off path allocates nothing per call
    (a @contextmanager would build a fresh generator each time)."""

    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN_CM = _NoopSpanCM()


class InMemorySpanExporter:
    """Collects finished spans in memory (OTel's in-memory test exporter)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def export(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


class OtlpHttpExporter:
    """Exports spans as OTLP/HTTP JSON to a collector, stdlib only: POST
    ``{endpoint}/v1/traces`` with an ExportTraceServiceRequest body
    (resourceSpans → scopeSpans → spans, ids as hex, times in unix
    nanos), the reference's wire format.

    Spans buffer and a daemon thread flushes them in batches (when
    ``batch_size`` are waiting, else every ``flush_interval_s``), so the
    traced path never blocks on the collector; a dead collector drops
    its batches with one stderr note every 30 s, never an exception."""

    def __init__(self, endpoint: str, service_name: str = "kubeflow-tpu",
                 timeout_s: float = 5.0, batch_size: int = 64,
                 flush_interval_s: float = 2.0) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.timeout_s = timeout_s
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self._buf: list[Span] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._last_error_t = 0.0
        self.exported_total = 0
        self.failed_total = 0
        self._thread = threading.Thread(target=self._flusher, daemon=True,
                                        name="kubeflow-tpu-torch-otlp")
        self._thread.start()

    def export(self, span: Span) -> None:
        with self._lock:
            if self._closed:
                return
            self._buf.append(span)
            full = len(self._buf) >= self.batch_size
        if full:
            self._wake.set()

    def force_flush(self) -> None:
        self._flush()

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        # the flusher may be mid-POST (up to timeout_s) and still owe the
        # final flush (another timeout_s)
        self._thread.join(timeout=2 * self.timeout_s + 1)
        self._flush()

    def _flusher(self) -> None:
        while True:  # returns after observing _closed
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            with self._lock:
                closed = self._closed
            self._flush()
            if closed:
                return

    def _flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        body = json.dumps(self._encode(batch)).encode()
        req = urllib.request.Request(
            self.endpoint + "/v1/traces", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception as e:  # noqa: BLE001 — telemetry must never raise
            # the flusher and a force_flush caller may both count
            with self._lock:
                self.failed_total += len(batch)
            now = time.time()
            if now - self._last_error_t > 30:
                self._last_error_t = now
                sys.stderr.write(
                    f"otlp: export of {len(batch)} spans to "
                    f"{self.endpoint} failed: {e}\n")
            return
        with self._lock:
            self.exported_total += len(batch)

    @staticmethod
    def _attr_value(value: object) -> dict:
        if isinstance(value, bool):
            return {"boolValue": value}
        if isinstance(value, int):
            return {"intValue": str(value)}
        if isinstance(value, float):
            return {"doubleValue": value}
        return {"stringValue": str(value)}

    @classmethod
    def _attrs(cls, attributes: dict) -> list[dict]:
        return [{"key": k, "value": cls._attr_value(v)}
                for k, v in attributes.items()]

    def _encode(self, batch: list[Span]) -> dict:
        by_tracer: dict[str, list[Span]] = {}
        for span in batch:
            by_tracer.setdefault(span.tracer, []).append(span)
        status_code = {STATUS_UNSET: 0, STATUS_OK: 1, STATUS_ERROR: 2}
        scope_spans = []
        for tracer, spans in by_tracer.items():
            scope_spans.append({
                "scope": {"name": tracer},
                "spans": [{
                    "traceId": f"{span.trace_id:032x}",
                    "spanId": f"{span.span_id:016x}",
                    **({"parentSpanId": f"{span.parent_id:016x}"}
                       if span.parent_id is not None else {}),
                    "name": span.name,
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(int(span.start_time * 1e9)),
                    "endTimeUnixNano": str(int(span.end_time * 1e9)),
                    "attributes": self._attrs(span.attributes),
                    "events": [{
                        "timeUnixNano": str(int(ev.timestamp * 1e9)),
                        "name": ev.name,
                        "attributes": self._attrs(ev.attributes),
                    } for ev in span.events],
                    "status": {
                        "code": status_code.get(span.status, 0),
                        **({"message": span.status_description}
                           if span.status_description else {}),
                    },
                } for span in spans],
            })
        return {"resourceSpans": [{
            "resource": {"attributes": self._attrs(
                {"service.name": self.service_name})},
            "scopeSpans": scope_spans,
        }]}


class NoopProvider:
    recording = False

    def span(self, tracer: str, name: str, attributes: dict | None = None,
             parent: SpanContext | None = None) -> _NoopSpanCM:
        return _NOOP_SPAN_CM

    def emit(self, tracer: str, name: str, start_time: float, end_time: float,
             attributes: dict | None = None,
             parent: SpanContext | None = None) -> _NoopSpan:
        return _NOOP_SPAN


class SDKProvider:
    """Recording provider: spans export when they end, parentage through
    a thread-local stack (as OTel's context propagation). ``exporter`` is
    anything with ``export(span)``."""

    recording = True

    def __init__(self, exporter) -> None:
        self.exporter = exporter
        self._local = threading.local()
        self._lock = threading.Lock()
        self._next_id = 1

    def _ids(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
            return i

    @contextmanager
    def span(self, tracer: str, name: str, attributes: dict | None = None,
             parent: SpanContext | None = None) -> Iterator[Span]:
        stack: list[Span] = getattr(self._local, "stack", None) or []
        self._local.stack = stack
        if parent is None:
            top = stack[-1] if stack else None
            parent = top.context() if top is not None else None
        # an explicit parent (a remote SpanContext from a traceparent
        # header or an annotation) wins over the thread's stack: a span
        # opened mid-reconcile joins ANOTHER object's trace, and its
        # children still nest under it through the stack
        span = Span(name=name, tracer=tracer,
                    trace_id=parent.trace_id if parent else self._ids(),
                    span_id=self._ids(),
                    parent_id=parent.span_id if parent else None,
                    attributes=dict(attributes or {}),
                    start_time=time.time())
        stack.append(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.end_time = time.time()
            stack.pop()
            self.exporter.export(span)

    def emit(self, tracer: str, name: str, start_time: float, end_time: float,
             attributes: dict | None = None,
             parent: SpanContext | None = None) -> Span:
        """Export an already finished span with explicit times, for a
        phase measured before a span could be opened (the workqueue wait,
        the phase collector's read and write totals). The parent defaults
        to the thread's innermost open span."""
        if parent is None:
            stack = getattr(self._local, "stack", None)
            parent = stack[-1].context() if stack else None
        span = Span(name=name, tracer=tracer,
                    trace_id=parent.trace_id if parent else self._ids(),
                    span_id=self._ids(),
                    parent_id=parent.span_id if parent else None,
                    attributes=dict(attributes or {}),
                    start_time=start_time, end_time=end_time)
        self.exporter.export(span)
        return span


_provider: NoopProvider | SDKProvider = NoopProvider()
_provider_lock = threading.Lock()


def set_provider(provider: NoopProvider | SDKProvider) -> None:
    global _provider
    with _provider_lock:
        _provider = provider


def get_provider() -> NoopProvider | SDKProvider:
    return _provider


def is_recording() -> bool:
    """True when the installed provider records spans. Call sites guard
    building attribute dicts on it, so the no-op path stays
    allocation-free."""
    return _provider.recording


def current_span():
    """The innermost open recording span on this thread (OTel's
    ``trace.SpanFromContext``); a no-op sink when the provider does not
    record or no span is open, so callers add events unconditionally."""
    provider = _provider
    if isinstance(provider, SDKProvider):
        stack = getattr(provider._local, "stack", None)
        if stack:
            return stack[-1]
    return _NOOP_SPAN


def current_context() -> SpanContext | None:
    """The context of the innermost open span on this thread, or None when
    the provider does not record: what a carrier (a traceparent header,
    an annotation) serialises."""
    provider = _provider
    if isinstance(provider, SDKProvider):
        stack = getattr(provider._local, "stack", None)
        if stack:
            return stack[-1].context()
    return None


def current_exemplar() -> dict[str, str] | None:
    """The exemplar labels of the open trace (``{"trace_id": ...,
    "span_id": ...}``), or None when not recording: what a histogram's
    ``observe(..., exemplar=)`` takes."""
    ctx = current_context()
    if ctx is None:
        return None
    return {"trace_id": f"{ctx.trace_id:032x}",
            "span_id": f"{ctx.span_id:016x}"}


class Tracer:
    """Named tracer handle, cheap and safe to cache: the provider is
    looked up when a span starts, so one installed later is picked up."""

    def __init__(self, name: str) -> None:
        self.name = name

    def start_span(self, name: str, attributes: dict | None = None,
                   parent: SpanContext | None = None):
        return _provider.span(self.name, name, attributes, parent=parent)

    def emit_span(self, name: str, start_time: float, end_time: float,
                  attributes: dict | None = None,
                  parent: SpanContext | None = None):
        return _provider.emit(self.name, name, start_time, end_time,
                              attributes, parent=parent)


def get_tracer(name: str) -> Tracer:
    return Tracer(name)


# ------------------------------------------------------------ flight recorder

def _span_dict(span: Span) -> dict:
    return {
        "name": span.name,
        "tracer": span.tracer,
        "trace_id": f"{span.trace_id:032x}",
        "span_id": f"{span.span_id:016x}",
        "parent_id": (f"{span.parent_id:016x}"
                      if span.parent_id is not None else None),
        "start": span.start_time,
        "end": span.end_time,
        "duration_s": max(span.end_time - span.start_time, 0.0),
        "status": span.status,
        "attributes": dict(span.attributes),
        "events": [{"name": ev.name, "ts": ev.timestamp,
                    "attributes": dict(ev.attributes)}
                   for ev in span.events],
    }


def trace_phase_breakdown(spans: list[dict]) -> dict[str, float]:
    """Wall-clock decomposition of one trace (span dicts as ``_span_dict``
    makes them): ``queue`` is the workqueue legs (enqueue → delivery, and
    the wait), ``wire`` the client's REST time, ``apf`` the server's
    priority-and-fairness wait (part of ``wire``, reported apart and not
    summed), and ``reconcile`` the rest of the wall. ``queue + wire +
    reconcile == wall`` by construction: one worker thread runs a
    reconcile serially, so the child spans do not overlap."""
    if not spans:
        return {"wall": 0.0, "queue": 0.0, "apf": 0.0, "wire": 0.0,
                "reconcile": 0.0}
    start = min(s["start"] for s in spans)
    end = max(s["end"] for s in spans)
    wall = max(end - start, 0.0)
    queue = sum(s["duration_s"] for s in spans
                if s["name"].startswith("workqueue."))
    apf = sum(s["duration_s"] for s in spans
              if s["name"].startswith("apf."))
    wire = sum(s["duration_s"] for s in spans
               if s["name"].startswith("rest."))
    reconcile = max(wall - queue - wire, 0.0)
    return {"wall": wall, "queue": queue, "apf": apf, "wire": wire,
            "reconcile": reconcile}


class FlightRecorder:
    """Bounded in-process trace store: the last ``traces_per_key``
    lifecycle traces of each notebook, which the health server's
    ``/debug/notebooks/<ns>/<name>/trace`` serves.

    An exporter, or a decorator in front of one (``inner`` receives
    every span). Spans group by trace id; a trace binds to a notebook key
    the first time one of its spans carries ``reconcile.key`` (the
    manager's reconcile roots). Children export before their root, so a
    trace not yet bound waits in an LRU buffer of ``max_traces`` until
    its keyed root arrives. Both the per-key ring and the buffer are
    bounded, so a recorder left on stays O(keys · traces_per_key)."""

    def __init__(self, inner=None, max_traces: int = 512,
                 traces_per_key: int = 8,
                 max_spans_per_trace: int = 256) -> None:
        self.inner = inner
        self.max_traces = max_traces
        self.traces_per_key = traces_per_key
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: OrderedDict[int, list[Span]] = OrderedDict()
        self._trace_key: dict[int, str] = {}
        self._by_key: dict[str, list[int]] = {}

    def export(self, span: Span) -> None:
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = []
                self._traces[span.trace_id] = spans
                while len(self._traces) > self.max_traces:
                    self._evict_oldest_locked()
            else:
                self._traces.move_to_end(span.trace_id)
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)
            key = span.attributes.get(KEY_ATTRIBUTE)
            if key is not None and span.trace_id not in self._trace_key:
                self._bind_locked(span.trace_id, str(key))
        if self.inner is not None:
            self.inner.export(span)

    def _bind_locked(self, trace_id: int, key: str) -> None:
        self._trace_key[trace_id] = key
        ring = self._by_key.setdefault(key, [])
        ring.append(trace_id)
        while len(ring) > self.traces_per_key:
            old = ring.pop(0)
            self._trace_key.pop(old, None)
            self._traces.pop(old, None)

    def _evict_oldest_locked(self) -> None:
        old, _ = self._traces.popitem(last=False)
        key = self._trace_key.pop(old, None)
        if key is not None:
            ring = self._by_key.get(key)
            if ring and old in ring:
                ring.remove(old)
                if not ring:
                    del self._by_key[key]

    def trace_for(self, namespace: str, name: str) -> list[dict]:
        """Every held trace bound to ``namespace/name``, oldest first,
        each ``{"trace_id": hex, "spans": [span dicts by start]}``: the
        debug endpoint's JSON body."""
        key = f"{namespace}/{name}"
        with self._lock:
            ring = list(self._by_key.get(key, ()))
            out = []
            for trace_id in ring:
                spans = self._traces.get(trace_id)
                if not spans:
                    continue
                out.append({
                    "trace_id": f"{trace_id:032x}",
                    "spans": [_span_dict(s) for s in
                              sorted(spans, key=lambda s: s.start_time)],
                })
        return out

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._by_key)
