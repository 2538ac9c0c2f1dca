"""The port's API priority and fairness held against the reference's.

The six ``test_apf_*`` cases of tests/test_shard_map.py run through both
packages: the case's own body and assertions on each side's
``APFDispatcher``, ``PriorityLevel``, ``FlowSchema`` and
``RejectedError``. Every dispatcher a case builds is kept with a metrics
registry of its side attached; once the case's threads have let go of
their seats, its seats (in flight, queued, limit per level) must be equal, and on the cases that run on one
thread so must its ``apf_*`` exposition lines. Then classification and
the shuffle-sharded queue choice of both packages on 500 flows drawn
with numpy from one seed, and the port's ``fnv1a`` against the
reference's.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import test_shard_map as ref_cases
from kubeflow_tpu.cluster import apf as ref_apf
from kubeflow_tpu.controllers.sharding import fnv1a as ref_fnv1a
from kubeflow_tpu_torch.cluster import apf
from kubeflow_tpu_torch.controllers.sharding import fnv1a
from torch_wire import normalise_exposition, run_both, side_globals

SEED = 22

CASES = {
    "test_apf_classifies_by_user_agent_and_kind": False,
    "test_apf_starved_tenant_isolation": True,
    "test_apf_idle_level_borrowing": False,
    "test_apf_queue_full_rejects_with_retry_after": True,
    "test_apf_fair_dispatch_across_flows_within_a_level": True,
    "test_apf_exempt_watches_and_health_bypass": False,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case(name):
    def run(s, mp):
        made = []
        with side_globals(mp, ref_cases, s.side, errors=True):
            cls = ref_cases.APFDispatcher
            assert cls is s.apf.APFDispatcher

            def init(self, *a, **kw):
                cls.__init__(self, *a, **kw)
                self.registry = s.metrics.MetricsRegistry()
                self.attach_metrics(self.registry)
                made.append(self)
            mp.setattr(ref_cases, "APFDispatcher",
                       type("APFDispatcher", (cls,), {"__init__": init}))
            getattr(ref_cases, name)()
        if CASES[name]:
            # the case returns with its last waiters still leaving
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and any(
                    lv["in_flight"] or lv["queued"]
                    for d in made for lv in d.snapshot().values()):
                time.sleep(0.01)
        out = [d.snapshot() for d in made]
        if not CASES[name]:
            out += [[ln for ln in normalise_exposition(d.registry.expose())
                     if "apf_" in ln] for d in made]
        return out
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_classification_and_shuffle_sharding_equal_the_reference():
    rng = np.random.default_rng(SEED)
    mine, theirs = apf.APFDispatcher(), ref_apf.APFDispatcher()
    agents = ["kubeflow-tpu-manager/m0", "tenant", "dashboard", "",
              "kubeflow-tpu-culler", "kubectl/v1.30"]
    for i in range(500):
        meta = {"user_agent": agents[rng.integers(len(agents))]
                + str(rng.integers(100)),
                "verb": ["get", "list", "watch", "update"][rng.integers(4)],
                "kind": ["Pod", "Lease", "Notebook"][rng.integers(3)]}
        assert mine.classify(meta) == theirs.classify(meta), meta
        flow = f"flow-{rng.integers(10**9)}-{i}"
        assert fnv1a(flow) == ref_fnv1a(flow)
        level = ["leader-election", "workload-high",
                 "global-default"][rng.integers(3)]
        lv, rlv = mine._levels[level], theirs._levels[level]
        assert (lv.limit, repr(lv.config)) == (rlv.limit, repr(rlv.config))
        q = mine._shuffle_queue_locked(lv, flow)
        rq = theirs._shuffle_queue_locked(rlv, flow)
        assert lv.queues.index(q) == rlv.queues.index(rq), flow
