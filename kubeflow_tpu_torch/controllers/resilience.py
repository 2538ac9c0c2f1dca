"""Manager-side resilience: overall rate limiting + apiserver circuit breaker.

The port's copy of ``kubeflow_tpu/controllers/resilience.py``. Two
client-go-shaped pieces the concurrent worker pool needs once the
transport is allowed to fail:

- ``TokenBucket``: the workqueue's overall rate limiter
  (``workqueue.DefaultControllerRateLimiter`` composes a 10 qps / 100
  burst ``BucketRateLimiter`` with the per-item exponential one via
  ``MaxOfRateLimiter``). The per-key exponential backoff lives in
  ``Manager._process``; the bucket caps the aggregate error-requeue rate,
  so a mass failure (an apiserver brownout failing every key at once)
  cannot turn the backoff floor into a thundering retry herd.

- ``CircuitBreaker``: an apiserver health tracker. The HTTP client
  reports every transport-level outcome (an HTTP error response counts
  as success: the server answered). After ``failure_threshold``
  consecutive transport failures the breaker opens: workers park (the
  queue keeps accumulating watch and timed work), readyz flips through
  the registered check, and ``apiserver_available`` drops to 0. While
  open, a half-open probe runs at an exponentially growing interval; the
  first probe success, or any organic request success (a watch thread
  reconnecting), closes the breaker, which calls ``on_resume`` (the
  manager's full resync) and un-parks the pool.

States::

                 N consecutive transport failures
        CLOSED ────────────────────────────────────▶ OPEN
          ▲                                           │ probe interval
          │ probe ok / any request success            ▼ elapsed
          └──────────────────────────────────── HALF_OPEN
                      (probe fails → OPEN, interval doubles)

The port's locks are plain ``threading`` locks (no sanitizer).
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger("kubeflow_tpu_torch.resilience")

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"
_STATE_GAUGE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class TokenBucket:
    """Reserving token bucket (client-go's BucketRateLimiter shape):
    ``next_delay()`` always admits the caller but returns how long it must
    wait, going into token debt, so a burst beyond ``burst`` spaces out at
    ``qps`` instead of being dropped. Thread-safe."""

    def __init__(self, qps: float = 10.0, burst: int = 100,
                 clock=time.monotonic) -> None:
        if qps <= 0:
            raise ValueError("qps must be positive")
        self.qps = float(qps)
        self.burst = float(max(burst, 1))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def next_delay(self) -> float:
        """Reserve one token; seconds the caller should wait before acting
        (0.0 while the burst lasts)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            self._tokens -= 1.0
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self.qps


class CircuitBreaker:
    """Apiserver availability tracker and worker-pool gate (the module
    docstring has the state machine). ``probe`` is an optional callable
    returning bool (``HttpApiClient.ping``); without one the breaker still
    closes on the first organic request success: watch reconnect attempts
    keep arriving while the pool is parked."""

    def __init__(self, probe=None, failure_threshold: int = 5,
                 probe_interval_s: float = 1.0,
                 probe_interval_max_s: float = 30.0,
                 on_resume=None, on_open=None,
                 clock=time.monotonic) -> None:
        self.probe = probe
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_interval_s = probe_interval_s
        self.probe_interval_max_s = probe_interval_max_s
        self.on_resume = on_resume
        self.on_open = on_open
        self._clock = clock
        self._lock = threading.Lock()
        self._probe_lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._next_probe_at = 0.0
        self._probe_backoff = probe_interval_s
        # attach_metrics: the availability and state gauges and the
        # transition counter
        self._available_metric = None
        self._state_metric = None
        self._transitions_metric = None

    # --------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def available(self) -> bool:
        """The readyz answer: False whenever the breaker is not closed."""
        with self._lock:
            return self._state == STATE_CLOSED

    def allow_dispatch(self) -> bool:
        """Workers consult this before popping work; False = park."""
        return self.available

    # ------------------------------------------------------------- records
    def record_success(self) -> None:
        """A request reached the apiserver (any HTTP status)."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == STATE_CLOSED:
                return
            self._transition_locked(STATE_CLOSED)
        self._resume()

    def record_failure(self) -> None:
        """A transport-level failure (refused, reset, truncated)."""
        with self._lock:
            self._consecutive_failures += 1
            if self._state != STATE_CLOSED or \
                    self._consecutive_failures < self.failure_threshold:
                return
            self._transition_locked(STATE_OPEN)
            self._opened_at = self._clock()
            self._probe_backoff = self.probe_interval_s
            self._next_probe_at = self._clock() + self._probe_backoff
            on_open = self.on_open
        log.warning("apiserver circuit breaker OPEN after %d consecutive "
                    "transport failures; parking the worker pool",
                    self._consecutive_failures)
        if on_open is not None:
            try:
                on_open()
            except Exception:  # noqa: BLE001 — a callback must not wedge the breaker
                log.exception("breaker on_open callback failed")

    # --------------------------------------------------------------- probe
    def maybe_probe(self) -> bool:
        """Run the half-open probe if one is due; returns whether a probe
        ran. One caller probes at a time (a non-blocking acquire): every
        parked worker calls this in its park loop."""
        if self.probe is None:
            return False
        with self._lock:
            if self._state == STATE_CLOSED or \
                    self._clock() < self._next_probe_at:
                return False
            self._transition_locked(STATE_HALF_OPEN)
        if not self._probe_lock.acquire(blocking=False):
            return False
        try:
            ok = False
            try:
                ok = bool(self.probe())
            except Exception:  # noqa: BLE001 — a raising probe is a failed probe
                log.exception("breaker probe raised; treating as down")
            changed = False
            with self._lock:
                if ok:
                    self._consecutive_failures = 0
                    # a ping through the instrumented client has already
                    # recorded a success and resumed; resume here only if
                    # this call makes the transition
                    changed = self._transition_locked(STATE_CLOSED)
                else:
                    self._transition_locked(STATE_OPEN)
                    self._probe_backoff = min(self._probe_backoff * 2,
                                              self.probe_interval_max_s)
                    self._next_probe_at = self._clock() + self._probe_backoff
            if ok and changed:
                self._resume()
            return True
        finally:
            self._probe_lock.release()

    # ------------------------------------------------------------ plumbing
    def _transition_locked(self, to_state: str) -> bool:
        if self._state == to_state:
            return False
        self._state = to_state
        if self._transitions_metric is not None:
            self._transitions_metric.inc({"to": to_state})
        if self._available_metric is not None:
            self._available_metric.set(1.0 if to_state == STATE_CLOSED
                                       else 0.0)
        if self._state_metric is not None:
            self._state_metric.set(_STATE_GAUGE[to_state])
        return True

    def _resume(self) -> None:
        outage = ""
        if self._opened_at is not None:
            outage = f" after {self._clock() - self._opened_at:.1f}s outage"
            self._opened_at = None
        log.warning("apiserver circuit breaker CLOSED%s; resuming with a "
                    "full resync", outage)
        on_resume = self.on_resume
        if on_resume is not None:
            try:
                on_resume()
            except Exception:  # noqa: BLE001 — a failed resync must not
                # wedge the pool; the watch reconnect's RV diff covers it
                log.exception("breaker on_resume (resync) failed")

    def attach_metrics(self, registry) -> None:
        self._available_metric = registry.gauge(
            "apiserver_available",
            "1 while the apiserver circuit breaker is closed (transport "
            "healthy), 0 while open/half-open.")
        self._state_metric = registry.gauge(
            "apiserver_breaker_state",
            "Circuit breaker state: 0=closed, 1=half_open, 2=open.")
        self._transitions_metric = registry.counter(
            "apiserver_breaker_transitions_total",
            "Circuit breaker state transitions, by target state.")
        self._available_metric.set(1.0)
        self._state_metric.set(float(_STATE_GAUGE[self.state]))
