"""Minimal Prometheus metrics registry (text exposition format).

A copy of the surface of ``kubeflow_tpu/utils/metrics.py`` that the
port uses (the port imports nothing of the JAX package): counters,
gauges and histograms, ``on_scrape`` callbacks and ``expose``. The
serving endpoint registers its own series; the controller manager
registers the workqueue family and the two reconcile-phase histograms,
the read cache its index counters, and the registry carries the
reference's five notebook series (components/notebook-controller/pkg/
metrics/metrics.go:13-99): ``notebook_running`` (a gauge computed at
scrape time), ``notebook_create_total``, ``notebook_create_failed_total``,
``notebook_culling_total`` and ``last_notebook_culling_timestamp_seconds``
(``record_culling``). The phase collector below splits each reconcile's
wall time into client reads and writes.
Plain ``threading.Lock``s stand in for the reference's tracked locks.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


def _escape_label_value(value: object) -> str:
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(key: tuple) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)


def _labels_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class _Metric:
    def __init__(self, name: str, help_: str, type_: str):
        self.name = name
        self.help = help_
        self.type = type_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: dict[str, str] | None = None,
            by: float = 1.0) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def set(self, value: float, labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = value

    def get(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label combination."""
        with self._lock:
            return sum(self._values.values())

    def sum_where(self, match: dict[str, str]) -> float:
        """Sum over every label combination whose labels include
        ``match``."""
        want = set(match.items())
        with self._lock:
            return sum(v for key, v in self._values.items()
                       if want <= set(key))

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, value in items:
            label_s = _format_labels(key)
            suffix = f"{{{label_s}}}" if label_s else ""
            lines.append(f"{self.name}{suffix} {value:g}")
        return "\n".join(lines)


# workqueue latencies span sub-ms (in-process store) to tens of seconds;
# client-go's exponential buckets cover the same range
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0)


class _Histogram:
    """Prometheus histogram (cumulative ``_bucket{le=...}`` + ``_sum`` +
    ``_count`` exposition). Fixed buckets, chosen at registration."""

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.type = "histogram"
        self.buckets = tuple(sorted(buckets))
        # labels key → [per-bucket counts..., +Inf count, sum]
        self._series: dict[tuple, list[float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float,
                labels: dict[str, str] | None = None) -> None:
        key = _labels_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [0.0] * (len(self.buckets) + 2)
            for i, le in enumerate(self.buckets):
                if value <= le:
                    series[i] += 1
            series[-2] += 1          # +Inf / _count
            series[-1] += value      # _sum

    def count(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            series = self._series.get(_labels_key(labels))
        return series[-2] if series else 0.0

    def sum(self, labels: dict[str, str] | None = None) -> float:
        """The ``_sum`` of one series (0 where it has no sample)."""
        with self._lock:
            series = self._series.get(_labels_key(labels))
        return series[-1] if series else 0.0

    def total_count(self) -> float:
        """Sum of ``_count`` over every label combination."""
        with self._lock:
            return sum(series[-2] for series in self._series.values())

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        for key, series in items:
            base = _format_labels(key)
            for i, le in enumerate(self.buckets):
                label_s = (base + "," if base else "") + f'le="{le:g}"'
                lines.append(f"{self.name}_bucket{{{label_s}}} {series[i]:g}")
            label_s = (base + "," if base else "") + 'le="+Inf"'
            lines.append(f"{self.name}_bucket{{{label_s}}} {series[-2]:g}")
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {series[-1]:g}")
            lines.append(f"{self.name}_count{suffix} {series[-2]:g}")
        return "\n".join(lines)


# --------------------------------------------------------- phase collector
# Per-reconcile read/write wall decomposition: the manager opens a window
# on the worker thread (phase_collect_start), the echo client attributes
# each verb's duration to "read" or "write" (phase_record), and the
# manager observes the totals into reconcile_read_seconds /
# reconcile_write_seconds at the end. Thread-local, so concurrent workers
# never mix phases; recording outside a window (watch threads, scrape
# callbacks) is a no-op.
_phase_tls = threading.local()


def phase_collect_start() -> None:
    _phase_tls.acc = {"read": 0.0, "write": 0.0}


def phase_record(phase: str, seconds: float) -> None:
    acc = getattr(_phase_tls, "acc", None)
    if acc is not None:
        acc[phase] = acc.get(phase, 0.0) + seconds


def phase_collect_finish() -> dict[str, float]:
    acc = getattr(_phase_tls, "acc", None) or {}
    _phase_tls.acc = None
    return acc


class MetricsRegistry:
    """Get-or-create registry of counters, gauges and histograms, plus
    the reference's notebook series unless ``include_notebook_metrics``
    is False (a serving process); ``on_scrape`` callbacks run before
    every exposition."""

    def __init__(self, include_notebook_metrics: bool = True) -> None:
        self._metrics: dict[str, _Metric | _Histogram] = {}
        self._scrape_callbacks: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        if not include_notebook_metrics:
            return
        self.notebook_create_total = self.counter(
            "notebook_create_total", "Total times of creating notebooks")
        self.notebook_create_failed_total = self.counter(
            "notebook_create_failed_total",
            "Total failure times of creating notebooks")
        self.notebook_culling_total = self.counter(
            "notebook_culling_total", "Total times of culling notebooks")
        self.last_culling_timestamp = self.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling in seconds")
        self.notebook_running = self.gauge(
            "notebook_running", "Current running notebooks in the cluster")

    def _get_or_create(self, name: str, make):
        # prometheus registration semantics: re-registering returns the
        # live metric, never a reset one
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            return m

    def counter(self, name: str, help_: str) -> _Metric:
        return self._get_or_create(
            name, lambda: _Metric(name, help_, "counter"))

    def gauge(self, name: str, help_: str) -> _Metric:
        return self._get_or_create(name, lambda: _Metric(name, help_, "gauge"))

    def histogram(self, name: str, help_: str,
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> _Histogram:
        return self._get_or_create(
            name, lambda: _Histogram(name, help_, buckets))

    def on_scrape(self, fn: Callable[[], None]) -> None:
        self._scrape_callbacks.append(fn)

    def record_culling(self, namespace: str, name: str) -> None:
        self.notebook_culling_total.inc({"namespace": namespace, "name": name})
        self.last_culling_timestamp.set(time.time())

    def expose(self) -> str:
        for fn in list(self._scrape_callbacks):
            fn()
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose() for m in metrics) + "\n"
