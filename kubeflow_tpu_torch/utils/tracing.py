"""Spans for the control plane, stdlib only.

The port's copy of the start-span path of ``kubeflow_tpu/utils/tracing.py``:
an OTel-like API (``get_tracer(name).start_span(...)`` as a context
manager, attributes, events, status) over a pluggable provider, and the
W3C ``traceparent`` carrier (``format_traceparent``/``parse_traceparent``)
that stitches a span onto a notebook's lifecycle trace. The default
provider is a no-op that hands out one shared context manager, so the
tracing-off path allocates nothing; ``set_provider(SDKProvider(exporter))``
installs a recording one (``InMemorySpanExporter`` collects its spans).

This is what the slice-repair reconciler's migration spans and the
mutating webhook's admission spans reach (``controllers/slicerepair.py``,
``webhook/mutating.py``, which adds events to ``current_span()``). Not
here yet (ROADMAP.md queue A item 7): the OTLP/HTTP exporter,
exemplars, the flight recorder, finished-span ``emit`` and the
manager's reconcile spans. Plain ``threading`` locks
stand in for the reference's tracked ones.
"""

from __future__ import annotations

import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

STATUS_UNSET = "UNSET"
STATUS_OK = "OK"
STATUS_ERROR = "ERROR"


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


class NoopProvider:
    recording = False

    def span(self, tracer: str, name: str, attributes: dict | None = None,
             parent: SpanContext | None = None) -> _NoopSpanCM:
        return _NOOP_SPAN_CM


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


class Tracer:
    """Named tracer handle, cheap and safe to cache: the provider is
    looked up when a span starts, so one installed later is picked up."""

    def __init__(self, name: str) -> None:
        self.name = name

    def start_span(self, name: str, attributes: dict | None = None,
                   parent: SpanContext | None = None):
        return _provider.span(self.name, name, attributes, parent=parent)


def get_tracer(name: str) -> Tracer:
    return Tracer(name)
