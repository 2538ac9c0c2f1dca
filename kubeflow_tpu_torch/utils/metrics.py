"""Minimal Prometheus metrics registry (text exposition format).

The port's copy of ``kubeflow_tpu/utils/metrics.py`` (the port imports
nothing of the JAX package): counters, gauges and histograms,
``on_scrape`` callbacks and ``expose``. The serving endpoint registers
its own series; the controller manager registers the workqueue family
and the two reconcile-phase histograms, the read cache its index
counters (and the store's ring and lock-hold families), the HTTP
apiserver its watch fan-out, cache-LIST and priority-and-fairness
families, the HTTP client its ``rest_client_*`` and watch-resume
families, the circuit breaker its ``apiserver_*`` availability families
and the shard coordinator its ownership families, and the registry carries the reference's five notebook series
(components/notebook-controller/pkg/metrics/metrics.go:13-99):
``notebook_running`` (a gauge computed at scrape time),
``notebook_create_total``, ``notebook_create_failed_total``,
``notebook_culling_total`` and ``last_notebook_culling_timestamp_seconds``
(``record_culling``). The phase collector below splits each reconcile's
wall time into client reads and writes.

A histogram observation may carry an exemplar (``observe(...,
exemplar=tracing.current_exemplar())``): the series' latest one is
rendered as an OpenMetrics comment on the bucket its value fell into,
which plain text-format parsers skip. ``METRIC_FAMILY_CATALOG`` and
``METRIC_FAMILY_LABELS`` name every family the port registers and its
label names, each entry equal to the reference's for the same family.
Plain ``threading.Lock``s stand in for the reference's tracked locks.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

# Every metric family name the port registers (one dynamic exception:
# runtime/server.py's scrape-mirrored ``serving_engine_<counter>``
# gauges, whose names come from the engine). A new family is a
# deliberate addition to the exposition surface: it goes here, with the
# reference's entry for the same family.
METRIC_FAMILY_CATALOG = frozenset({
    # the reference's notebook metrics (metrics.go:13-99)
    "notebook_create_total",
    "notebook_create_failed_total",
    "notebook_culling_total",
    "last_notebook_culling_timestamp_seconds",
    "notebook_running",
    # controller-runtime analogs (manager)
    "controller_runtime_reconcile_total",
    "workqueue_adds_total",
    "workqueue_retries_total",
    "workqueue_queue_duration_seconds",
    "workqueue_work_duration_seconds",
    "workqueue_depth",
    "workqueue_unfinished_work_seconds",
    "workqueue_longest_running_processor_seconds",
    "reconcile_read_seconds",
    "reconcile_write_seconds",
    # slice pool / repair
    "slicepool_bind_latency_seconds",
    "slicepool_bind_misses_total",
    "slicepool_size",
    "slice_repairs_total",
    "slice_repair_duration_seconds",
    "slice_quarantines_total",
    "slice_degraded",
    "notebook_migrations_total",
    "elastic_resizes_total",
    # fleet scheduler
    "scheduler_admissions_total",
    "scheduler_preemptions_total",
    "scheduler_gang_wait_seconds",
    "scheduler_quota_used",
    # serving
    "serving_http_requests_total",
    "serving_generate_seconds_sum",
    "serving_generate_seconds_count",
    # read cache
    "cache_index_lookups_total",
    "cache_full_scans_total",
    # the wire's server half: API priority & fairness, the store's
    # watch ring and lock holds, the apiserver's watch fan-out
    "apf_dispatched_total",
    "apf_rejected_total",
    "apf_current_inqueue",
    "watch_cache_evictions_total",
    "store_list_lock_seconds",
    "store_write_lock_seconds",
    "watch_queue_coalesced_total",
    "watch_fanout_bytes_total",
    "watch_frames_sent_total",
    "apiserver_cache_lists_total",
    # the wire's client half (cluster/http_client.py)
    "rest_client_requests_total",
    "rest_client_retries_total",
    "rest_client_request_duration_seconds",
    "rest_client_connections_opened_total",
    "watch_resumes_total",
    # the binaries: sharded ownership and the apiserver circuit breaker
    "shard_ownership",
    "shard_rebalance_total",
    "apiserver_available",
    "apiserver_breaker_state",
    "apiserver_breaker_transitions_total",
})

# Label names per family: the cardinality contract that goes with the
# names above. Every literal label dict passed to ``.inc``/``.set``/
# ``.observe`` in the port uses only these keys; ``()`` is a single
# unlabeled series.
METRIC_FAMILY_LABELS = {
    "apf_current_inqueue": ("priority_level",),
    "apf_dispatched_total": ("priority_level",),
    "apf_rejected_total": ("priority_level",),
    "apiserver_available": (),
    "apiserver_breaker_state": (),
    "apiserver_breaker_transitions_total": ("to",),
    "apiserver_cache_lists_total": (),
    "cache_full_scans_total": ("kind",),
    "cache_index_lookups_total": ("index", "kind"),
    "controller_runtime_reconcile_total": ("controller", "result"),
    "elastic_resizes_total": ("namespace", "outcome"),
    "last_notebook_culling_timestamp_seconds": (),
    "notebook_create_failed_total": (),
    "notebook_create_total": (),
    "notebook_culling_total": ("name", "namespace"),
    "notebook_migrations_total": ("outcome",),
    "notebook_running": (),
    "reconcile_read_seconds": ("controller",),
    "reconcile_write_seconds": ("controller",),
    "rest_client_connections_opened_total": ("type",),
    "rest_client_request_duration_seconds": ("verb",),
    "rest_client_requests_total": ("code", "method"),
    "rest_client_retries_total": ("reason", "verb"),
    "scheduler_admissions_total": ("outcome", "tenant"),
    "scheduler_gang_wait_seconds": ("tenant",),
    "scheduler_preemptions_total": ("outcome", "tier"),
    "scheduler_quota_used": ("tenant",),
    "serving_generate_seconds_count": (),
    "serving_generate_seconds_sum": (),
    "serving_http_requests_total": ("code", "method", "route"),
    "shard_ownership": ("manager", "shard"),
    "shard_rebalance_total": ("manager",),
    "slice_degraded": ("namespace", "state"),
    "slice_quarantines_total": ("namespace",),
    "slice_repair_duration_seconds": ("namespace",),
    "slice_repairs_total": ("namespace", "reason"),
    "slicepool_bind_latency_seconds": ("pool",),
    "slicepool_bind_misses_total": ("reason",),
    "slicepool_size": ("pool", "state"),
    "store_list_lock_seconds": ("kind",),
    "store_write_lock_seconds": ("kind",),
    "watch_cache_evictions_total": ("kind",),
    "watch_fanout_bytes_total": ("encoding",),
    "watch_frames_sent_total": ("encoding",),
    "watch_queue_coalesced_total": (),
    "watch_resumes_total": ("kind", "mode"),
    "workqueue_adds_total": ("name",),
    "workqueue_depth": ("name",),
    "workqueue_longest_running_processor_seconds": ("name",),
    "workqueue_queue_duration_seconds": ("name",),
    "workqueue_retries_total": ("name",),
    "workqueue_unfinished_work_seconds": ("name",),
    "workqueue_work_duration_seconds": ("name",),
}


def _escape_label_value(value: object) -> str:
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(key: tuple) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)


def _format_exemplar(exemplar: dict[str, str], value: float,
                     timestamp: float) -> str:
    """An OpenMetrics exemplar as an exposition comment, ``# {trace_id=
    "..."} <value> <ts>`` after the sample: plain Prometheus text parsers
    read everything after ``#`` as a comment, so the format stays
    0.0.4-compatible."""
    labels = _format_labels(tuple(sorted(exemplar.items())))
    return f" # {{{labels}}} {value:g} {timestamp:.3f}"


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
        # labels key → (exemplar labels, observed value, unix ts): the
        # latest exemplared observation, put at exposition on the bucket
        # its value fell into (OpenMetrics exemplar semantics)
        self._exemplars: dict[tuple, tuple[dict[str, str], float,
                                           float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float,
                labels: dict[str, str] | None = None,
                exemplar: dict[str, str] | None = None) -> None:
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
            if exemplar:
                self._exemplars[key] = (dict(exemplar), value, time.time())

    def count(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            series = self._series.get(_labels_key(labels))
        return series[-2] if series else 0.0

    def sum(self, labels: dict[str, str] | None = None) -> float:
        """The ``_sum`` of one series (0 where it has no sample)."""
        with self._lock:
            series = self._series.get(_labels_key(labels))
        return series[-1] if series else 0.0

    def total_sum(self) -> float:
        """Sum of ``_sum`` over every label combination (e.g. every
        controller of reconcile_read_seconds)."""
        with self._lock:
            return sum(series[-1] for series in self._series.values())

    def total_count(self) -> float:
        """Sum of ``_count`` over every label combination."""
        with self._lock:
            return sum(series[-2] for series in self._series.values())

    def _exemplar_bucket(self, value: float) -> int:
        """Index of the lowest bucket holding ``value`` (len(buckets) is
        +Inf)."""
        for i, le in enumerate(self.buckets):
            if value <= le:
                return i
        return len(self.buckets)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
            exemplars = dict(self._exemplars)
        for key, series in items:
            base = _format_labels(key)
            ex = exemplars.get(key)
            ex_bucket = self._exemplar_bucket(ex[1]) if ex else -1
            for i, le in enumerate(self.buckets):
                label_s = (base + "," if base else "") + f'le="{le:g}"'
                tail = (_format_exemplar(*ex)
                        if ex and i == ex_bucket else "")
                lines.append(f"{self.name}_bucket{{{label_s}}} "
                             f"{series[i]:g}{tail}")
            label_s = (base + "," if base else "") + 'le="+Inf"'
            tail = (_format_exemplar(*ex)
                    if ex and ex_bucket == len(self.buckets) else "")
            lines.append(f"{self.name}_bucket{{{label_s}}} "
                         f"{series[-2]:g}{tail}")
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
