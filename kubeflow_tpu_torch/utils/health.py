"""Health-probe, metrics and trace-debug HTTP endpoints.

The port's copy of ``kubeflow_tpu/utils/health.py``. The reference's
managers expose healthz/readyz on :8081 (notebook-controller
main.go:125-133, wired to the manager's AddHealthzCheck/AddReadyzCheck)
and Prometheus metrics on :8080; the deployment manifests point the
liveness and readiness probes at them. One stdlib HTTP server serves:

- ``/healthz``: process liveness, 200 while every healthz check passes
  (500 otherwise);
- ``/readyz``: readiness, 200 once every healthz and readyz check
  passes, 503 (route traffic away) otherwise;
- ``/metrics``: the MetricsRegistry's Prometheus text exposition
  (``text/plain; version=0.0.4``);
- ``/debug/notebooks/<ns>/<name>/trace``: the flight recorder's last
  lifecycle traces of one notebook as JSON; 404 when no recorder is
  attached or no trace is held.

A plain lock stands in for the reference's tracked one. ``port=0``
binds a free port (``port`` reads it back).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

log = logging.getLogger("kubeflow_tpu_torch.health")


class HealthServer:
    def __init__(self, metrics_registry=None, host: str = "0.0.0.0",
                 port: int = 0, flight_recorder=None) -> None:
        self.metrics_registry = metrics_registry
        # a tracing.FlightRecorder (or None): serves the per-notebook
        # trace endpoint
        self.flight_recorder = flight_recorder
        self._checks: dict[str, Callable[[], bool]] = {}
        self._ready_checks: dict[str, Callable[[], bool]] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("health: " + fmt, *args)

            def do_GET(self) -> None:
                status, body, ctype = outer._get(self.path)
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    # -------------------------------------------------------------- checks
    def add_healthz_check(self, name: str, fn: Callable[[], bool]) -> None:
        with self._lock:
            self._checks[name] = fn

    def add_readyz_check(self, name: str, fn: Callable[[], bool]) -> None:
        with self._lock:
            self._ready_checks[name] = fn

    def _run_checks(self, checks: dict[str, Callable[[], bool]]
                    ) -> tuple[bool, str]:
        lines = []
        ok = True
        with self._lock:
            items = list(checks.items())
        for name, fn in items:
            try:
                passed = bool(fn())
            except Exception as exc:  # noqa: BLE001 — a raising check
                passed = False        # fails, never the probe server
                log.warning("check %s raised: %s", name, exc)
            ok = ok and passed
            lines.append(f"[{'+' if passed else '-'}]{name} "
                         f"{'ok' if passed else 'failed'}")
        return ok, "\n".join(lines) + ("\n" if lines else "ok\n")

    def _get(self, path: str) -> tuple[int, str, str]:
        if path.startswith("/healthz"):
            ok, body = self._run_checks(self._checks)
            return (200 if ok else 500), body, "text/plain"
        if path.startswith("/readyz"):
            with self._lock:
                checks = {**self._checks, **self._ready_checks}
            ok, body = self._run_checks(checks)
            # not ready is 503 ServiceUnavailable (route traffic away),
            # not 500 (something crashed)
            return (200 if ok else 503), body, "text/plain"
        if path.startswith("/metrics"):
            if self.metrics_registry is None:
                return 404, "no metrics registry\n", "text/plain"
            return 200, self.metrics_registry.expose(), \
                "text/plain; version=0.0.4"
        if path.startswith("/debug/notebooks/"):
            return self._get_trace(path)
        return 404, "not found\n", "text/plain"

    def _get_trace(self, path: str) -> tuple[int, str, str]:
        """``/debug/notebooks/<ns>/<name>/trace`` → the recorder's held
        traces of that notebook, newest last."""
        if self.flight_recorder is None:
            return 404, "no flight recorder attached\n", "text/plain"
        parts = path.strip("/").split("/")
        # ["debug", "notebooks", ns, name, "trace"]
        if len(parts) != 5 or parts[4] != "trace":
            return 404, "not found\n", "text/plain"
        namespace, name = parts[2], parts[3]
        traces = self.flight_recorder.trace_for(namespace, name)
        if not traces:
            return (404, f"no traces recorded for {namespace}/{name}\n",
                    "text/plain")
        body = json.dumps({"namespace": namespace, "name": name,
                           "traces": traces}, indent=2) + "\n"
        return 200, body, "application/json"

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="kubeflow-tpu-torch-health")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            # shutdown() deadlocks unless serve_forever() runs, so only
            # when start() did
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()
