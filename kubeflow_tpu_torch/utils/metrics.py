"""Minimal Prometheus metrics registry (text exposition format).

A small copy of the surface of ``kubeflow_tpu/utils/metrics.py`` that the
serving endpoint uses — ``counter``, ``gauge``, ``on_scrape`` and
``expose`` — so that the port imports nothing of the JAX package. Plain
``threading.Lock``s stand in for the control plane's tracked locks.
"""

from __future__ import annotations

import threading
from typing import Callable


def _escape_label_value(value: object) -> str:
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_: str, type_: str):
        self.name = name
        self.help = help_
        self.type = type_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: dict[str, str] | None) -> tuple:
        return tuple(sorted((labels or {}).items()))

    def inc(self, labels: dict[str, str] | None = None,
            by: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def set(self, value: float, labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def get(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, value in items:
            label_s = ",".join(f'{k}="{_escape_label_value(v)}"'
                               for k, v in key)
            suffix = f"{{{label_s}}}" if label_s else ""
            lines.append(f"{self.name}{suffix} {value:g}")
        return "\n".join(lines)


class MetricsRegistry:
    """Get-or-create registry of counters and gauges; ``on_scrape``
    callbacks run before every exposition."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._scrape_callbacks: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, help_: str, type_: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = _Metric(name, help_, type_)
            return m

    def counter(self, name: str, help_: str) -> _Metric:
        return self._get_or_create(name, help_, "counter")

    def gauge(self, name: str, help_: str) -> _Metric:
        return self._get_or_create(name, help_, "gauge")

    def on_scrape(self, fn: Callable[[], None]) -> None:
        self._scrape_callbacks.append(fn)

    def expose(self) -> str:
        for fn in list(self._scrape_callbacks):
            fn()
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose() for m in metrics) + "\n"
