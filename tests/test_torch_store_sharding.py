"""The port's sharded store held against the reference's.

Every case of tests/test_store_sharding.py runs through both packages:
the case's own body and assertions, on the reference's ``ClusterStore``
and then on the port's (``torch_wire.side_globals`` swaps the store,
its error classes and the metrics registry the case names). Each store
and registry the case builds is kept, and what they hold after it is
compared after ``torch_wire``'s normalisation: the objects, the last
issued resourceVersion, every resume ring (each frame's type, rv and
object, in order) and the exposition lines. The concurrent-writers case
interleaves threads differently on every run, so there the rings are
compared as sets of (type, object) and the rvs are left out.

Then ``_shard_index`` of both packages on 1000 keys drawn with numpy
from one seed, for 1, 3, 8 and 16 shards: the same shard for every key.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_store_sharding as ref_cases
from kubeflow_tpu.cluster.store import _shard_index as ref_shard_index
from kubeflow_tpu_torch.cluster.store import _shard_index
from torch_wire import (normalise_exposition, recorded_instances, run_both,
                        side_globals, store_state)

SEED = 22
CASES = [
    "test_shard_index_deterministic_and_bounded",
    "test_shard_index_spreads_namespace_fleets",
    "test_kind_contributes_to_shard_key",
    "test_store_shard_structures_distinct",
    "test_concurrent_writers_rv_unique_and_ring_ordered",
    "test_rv_anchor_semantics_at_the_edge",
    "test_cascade_gc_sees_dependents_on_every_shard",
    "test_cascade_honors_dependent_finalizer_across_shards",
    "test_write_lock_metric_observed_per_kind",
    "test_metric_registration_is_eager",
]


def _run(name, **kwargs):
    def run(s, mp):
        stores, registries = [], []
        with side_globals(mp, ref_cases, s.side, errors=True):
            recorded_instances(mp, ref_cases, "ClusterStore", stores)
            recorded_instances(mp, ref_cases, "MetricsRegistry", registries)
            getattr(ref_cases, name)(**kwargs)
        assert all(isinstance(st, s.ClusterStore) for st in stores)
        assert all(isinstance(r, s.metrics.MetricsRegistry)
                   for r in registries)
        rvs = name != "test_concurrent_writers_rv_unique_and_ring_ordered"
        return ([store_state(st, s.side, rvs=rvs) for st in stores],
                [normalise_exposition(r.expose()) for r in registries])
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    _run(name)


@pytest.mark.parametrize("nshards", [1, 3])
def test_non_default_shard_counts_full_semantics(nshards):
    _run("test_non_default_shard_counts_full_semantics", nshards=nshards)


@pytest.mark.parametrize("nshards", [1, 3, 8, 16])
def test_shard_index_equals_the_reference(nshards):
    rng = np.random.default_rng(SEED)
    kinds = ("Notebook", "ConfigMap", "StatefulSet", "Pod", "Service",
             "Event", "Secret", "Namespace", "TPUQuota", "Lease")
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-"))
    for _ in range(1000):
        kind = kinds[rng.integers(len(kinds))]
        ns = "".join(alphabet[rng.integers(len(alphabet),
                                           size=rng.integers(0, 24))])
        assert _shard_index(kind, ns, nshards) == \
            ref_shard_index(kind, ns, nshards), (kind, ns)
