"""Sharded reconcile ownership held against the reference's: the shard
map, the balanced assignment, the per-shard lease coordinator and the
manager's shard filter and handoff resync.

The 13 cases of tests/test_shard_map.py that are not API priority and
fairness (``tests/test_torch_apf.py`` runs those six) run through both
packages, each case's own body and assertions on each side's
``ShardMap``, ``assign_shards``, ``fnv1a``, ``jump_hash``,
``ShardCoordinator``, ``Manager``, ``Request``, ``Result`` and
``ClusterStore`` (``torch_wire.binaries_case``). What each case leaves
must be equal: every coordinator's owned shards; every store's objects,
the Leases' renew times masked (wall-clock stamps), with its last
resourceVersion; every manager's queued keys. Then ``jump_hash`` and
``assign_shards`` on 500 seeded inputs each: equal buckets, equal
assignments.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import test_shard_map as ref_cases
from kubeflow_tpu.controllers import sharding as ref_sharding
from kubeflow_tpu_torch.controllers import sharding
from torch_wire import SIDES, binaries_case, normalise_object

SEED = 24
CASES = sorted(n for n in vars(ref_cases)
               if n.startswith("test_") and not n.startswith("test_apf_"))
KEEP = ("ClusterStore", "ShardCoordinator", "Manager")


def test_every_reference_case_is_run():
    assert len(CASES) == 13


def _lease_masked(obj: dict) -> dict:
    spec = obj.get("spec")
    if obj.get("kind") == "Lease" and spec and spec.get("renewTime"):
        obj = {**obj, "spec": {**spec, "renewTime": "<renewed>"}}
    return obj


def _view(made: dict, side: str) -> dict:
    return {
        "owned": [sorted(c.owned_shards())
                  for c in made["ShardCoordinator"]],
        "stores": [(sorted((_lease_masked(normalise_object(o, side))
                            for o in st.all_objects()), key=json.dumps),
                    st._last_rv) for st in made["ClusterStore"]],
        "queued": [sorted((c, r.namespace, r.name) for c, r in m._queued)
                   for m in made["Manager"]]}


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp, keep=KEEP,
                                 inline=("errors",))
        got[side] = _view(made, side)
    assert got["port"] == got["ref"]


def test_jump_hash_and_assignment_on_seeded_inputs():
    rng = np.random.default_rng(SEED)
    for _ in range(500):
        key = int(rng.integers(0, 2**63)) * 2 + int(rng.integers(2))
        buckets = int(rng.integers(0, 300))
        assert sharding.jump_hash(key, buckets) == \
            ref_sharding.jump_hash(key, buckets)
        ns = "ns-" + "".join(chr(int(c)) for c in
                             rng.integers(97, 123, size=rng.integers(0, 12)))
        assert sharding.ShardMap(buckets).shard_for(ns) == \
            ref_sharding.ShardMap(buckets).shard_for(ns)
    for _ in range(500):
        shards = int(rng.integers(0, 64))
        members = [f"mgr-{int(i)}" for i in
                   rng.integers(0, 20, size=int(rng.integers(0, 8)))]
        assert sharding.assign_shards(shards, members) == \
            ref_sharding.assign_shards(shards, members)
