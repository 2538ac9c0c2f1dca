"""The manager's error backoff, its overall rate limiter, the resync and
the apiserver circuit breaker held against the reference's.

All 13 cases of tests/test_manager_backoff.py run through both packages,
each case's own body and assertions on each side's ``Manager``,
``Request``, ``_QueueItem``, ``TokenBucket`` (``controllers/
resilience.py``, where the reference keeps it), ``CircuitBreaker``,
``ClusterStore`` and ``MetricsRegistry`` (``torch_wire.binaries_case``).
What each case leaves must be equal: every manager's per-key failure
counts, its queued keys and whether it rate-limits; every breaker's
state; every registry's exposition (timing samples dropped,
``torch_wire.normalise_exposition``: the ``workqueue_retries_total`` and
``apiserver_*`` families among them); every store's objects. Then the
token bucket on 200 seeded schedules of reservations on a fake clock:
equal delays.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_manager_backoff as ref_cases
from kubeflow_tpu.controllers.resilience import TokenBucket as RefBucket
from kubeflow_tpu_torch.controllers.resilience import TokenBucket
from torch_wire import (SIDES, binaries_case, normalise_exposition,
                        store_views)

SEED = 24
CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))
KEEP = ("ClusterStore", "Manager", "CircuitBreaker", "MetricsRegistry")


def test_every_reference_case_is_run():
    assert len(CASES) == 13


def _view(made: dict, side: str) -> dict:
    return {
        "managers": [(sorted((c, r.namespace, r.name, n)
                             for (c, r), n in m._failures.items()),
                      sorted((c, r.namespace, r.name)
                             for c, r in m._queued),
                      m.rate_limiter is None)
                     for m in made["Manager"]],
        "breakers": [b.state for b in made["CircuitBreaker"]],
        "registries": [normalise_exposition(r.expose())
                       for r in made["MetricsRegistry"]],
        "stores": store_views(made, side, False)}


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp, keep=KEEP)
        got[side] = _view(made, side)
    assert got["port"] == got["ref"]


def test_token_bucket_on_seeded_schedules():
    rng = np.random.default_rng(SEED)
    for _ in range(200):
        qps = float(rng.uniform(0.5, 50.0))
        burst = int(rng.integers(0, 20))
        now = [0.0]
        mine = TokenBucket(qps=qps, burst=burst, clock=lambda: now[0])
        theirs = RefBucket(qps=qps, burst=burst, clock=lambda: now[0])
        for _ in range(int(rng.integers(1, 60))):
            now[0] += float(rng.exponential(1.0 / qps))
            assert mine.next_delay() == theirs.next_delay()
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            TokenBucket(qps=bad)


def test_breaker_families_exported_as_the_reference():
    """The breaker's three families on each side's registry through an
    open and a close: ``apiserver_available`` (1, 0, 1),
    ``apiserver_breaker_state`` (0, 2, 0) and
    ``apiserver_breaker_transitions_total`` by target state; equal
    expositions at each step."""
    got = {}
    for side, s in SIDES.items():
        registry = s.metrics.MetricsRegistry()
        breaker = s.resilience.CircuitBreaker(failure_threshold=2)
        breaker.attach_metrics(registry)
        steps = [registry.expose()]
        breaker.record_failure()
        breaker.record_failure()
        steps.append(registry.expose())
        breaker.record_success()
        steps.append(registry.expose())
        got[side] = steps
        assert "apiserver_available 0" in steps[1]
        assert "apiserver_breaker_state 2" in steps[1]
        assert 'apiserver_breaker_transitions_total{to="open"} 1' in steps[2]
        assert 'apiserver_breaker_transitions_total{to="closed"} 1' in \
            steps[2]
    assert got["port"] == got["ref"]
