"""Structured logging set-up, the zap analog.

The port's copy of ``kubeflow_tpu/utils/logging.py``. The reference's
managers configure zap with RFC3339 timestamps and a ``--debug-log``
verbosity flag (odh main.go:161-169); zap's two encoders (production
JSON, development console) map to the ``json`` and ``text`` formats
here. A JSON line carries ts/level/logger/msg, the exception text, and,
through ``CorrelationFilter``, the open span's trace and span ids and
the reconcile key the manager's worker is processing
(``reconcile_key_var``, set by ``Manager._process``), so a log line
joins its trace.
"""

from __future__ import annotations

import contextvars
import json
import logging
import time

from . import tracing

# the reconcile key ("namespace/name") of the item a worker thread is
# processing: set by Manager._process, read by the correlation filter so
# every log line written mid-reconcile names its object
reconcile_key_var: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("kubeflow_tpu_torch_reconcile_key", default=None)


class CorrelationFilter(logging.Filter):
    """Stamps trace_id/span_id (of the open span) and the current
    reconcile key onto each record, so JSON logs join against traces.
    Always passes the record; the attributes are None when there is
    nothing to correlate (tracing off, not a worker thread)."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = tracing.current_context()
        record.trace_id = f"{ctx.trace_id:032x}" if ctx else None
        record.span_id = f"{ctx.span_id:016x}" if ctx else None
        record.reconcile_key = reconcile_key_var.get()
        return True


class JsonFormatter(logging.Formatter):
    """zap production-encoder analog: one JSON object per line; a
    correlation key with nothing to say is left out, not null."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                time.gmtime(record.created)),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key in ("trace_id", "span_id", "reconcile_key"):
            value = getattr(record, key, None)
            if value is not None:
                entry[key] = value
        if record.exc_info:
            entry["error"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def setup_logging(debug: bool = False, fmt: str = "text") -> None:
    """Configure the root logger (idempotent: replaces its handlers)."""
    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
    handler = logging.StreamHandler()
    if fmt == "json":
        # correlation rides on the JSON handler only: the text format's
        # line shape stays byte for byte the classic one
        handler.addFilter(CorrelationFilter())
        handler.setFormatter(JsonFormatter())
    else:
        formatter = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%SZ")
        # UTC on this formatter only: setting the logging.Formatter class
        # attribute would change every other formatter in the process
        formatter.converter = time.gmtime
        handler.setFormatter(formatter)
    root.addHandler(handler)
    root.setLevel(logging.DEBUG if debug else logging.INFO)
