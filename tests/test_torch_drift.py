"""The port's drift detector held against the reference's, case for case.

Every case of tests/test_drift.py runs on both sides: the same seeded
random trees and StatefulSets go through each side's ``diff_merge_patch``,
``minimal_update_patch`` (over each side's ``copy_statefulset_fields`` and
``copy_service_fields``) and ``semantic_equal``. Each side makes the
case's own assertions, and every patch, verdict and merged object it
computed must equal the other side's.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

from kubeflow_tpu.controllers import notebook as ref_notebook
from kubeflow_tpu.utils import drift as ref_drift
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu_torch.controllers import notebook
from kubeflow_tpu_torch.utils import drift, k8s

SIDES = {
    "ref": SimpleNamespace(
        drift=ref_drift, k8s=ref_k8s,
        copy_statefulset_fields=ref_notebook.copy_statefulset_fields,
        copy_service_fields=ref_notebook.copy_service_fields),
    "port": SimpleNamespace(
        drift=drift, k8s=k8s,
        copy_statefulset_fields=notebook.copy_statefulset_fields,
        copy_service_fields=notebook.copy_service_fields),
}

# ------------------------------------------------------------ generators
_KEYS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]


def _rand_scalar(rng: random.Random):
    return rng.choice([
        rng.randint(0, 99), f"s{rng.randint(0, 9)}", True, False,
        [rng.randint(0, 9) for _ in range(rng.randint(0, 3))],
    ])


def _rand_tree(rng: random.Random, depth: int = 0) -> dict:
    out = {}
    for key in rng.sample(_KEYS, rng.randint(1, len(_KEYS))):
        if depth < 3 and rng.random() < 0.4:
            out[key] = _rand_tree(rng, depth + 1)
        else:
            out[key] = _rand_scalar(rng)
    return out


def _mutate(m, rng: random.Random, obj: dict, depth: int = 0) -> dict:
    """A randomly edited deepcopy: keys added, deleted and replaced,
    dicts recursed into; sometimes the object comes back unchanged."""
    out = m.k8s.deepcopy(obj)
    for key in list(out):
        roll = rng.random()
        if roll < 0.15:
            del out[key]
        elif roll < 0.3:
            out[key] = _rand_scalar(rng)
        elif isinstance(out[key], dict) and depth < 3 and roll < 0.6:
            out[key] = _mutate(m, rng, out[key], depth + 1)
    if rng.random() < 0.3:
        out[f"new{rng.randint(0, 4)}"] = _rand_scalar(rng)
    return out


def _assert_minimal(patch, before, after):
    """Every path the patch carries is a real difference."""
    assert isinstance(patch, dict)
    for key, val in patch.items():
        if val is None:
            assert key in before and key not in after
        elif isinstance(val, dict) and isinstance(before.get(key), dict):
            _assert_minimal(val, before[key], after[key])
        else:
            assert key not in before or before[key] != after.get(key)


def _sts(image="img:a", replicas=2, labels=None, annotations=None,
         server_side=False):
    sts = {
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": "nb", "namespace": "ns",
                     "labels": dict(labels or {"statefulset": "nb"})},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"statefulset": "nb"}},
            "serviceName": "nb",
            "template": {
                "metadata": {"labels": dict(labels or
                                            {"statefulset": "nb"})},
                "spec": {"containers": [{"name": "nb", "image": image}]},
            },
        },
    }
    if annotations is not None:
        sts["metadata"]["annotations"] = dict(annotations)
    if server_side:
        # what the apiserver adds on persist: never desired state
        sts["metadata"].update({
            "uid": "uid-9", "resourceVersion": "42", "generation": 3,
            "creationTimestamp": "2026-01-01T00:00:00Z",
        })
        sts["status"] = {"replicas": replicas, "readyReplicas": replicas}
    return sts


# ---------------------------------------------------------------- diffing
def equal_objects_produce_no_patch(m):
    rng = random.Random(7)
    out = []
    for _ in range(50):
        obj = _rand_tree(rng)
        out.append(m.drift.diff_merge_patch(obj, m.k8s.deepcopy(obj)))
        assert out[-1] is None
    return out


def apply_reproduces_after_exactly(m):
    rng = random.Random(11)
    out = []
    for _ in range(200):
        before = _rand_tree(rng)
        after = _mutate(m, rng, before)
        patch = m.drift.diff_merge_patch(before, after)
        out.append(patch)
        if patch is None:
            assert before == after
        else:
            assert m.k8s.json_merge_patch(before, patch) == after
    return out


def patch_is_minimal(m):
    rng = random.Random(13)
    out = []
    for _ in range(200):
        before = _rand_tree(rng)
        after = _mutate(m, rng, before)
        patch = m.drift.diff_merge_patch(before, after)
        out.append(patch)
        if patch is not None:
            _assert_minimal(patch, before, after)
    return out


def deleted_key_patches_to_null(m):
    patch = m.drift.diff_merge_patch({"a": 1, "b": 2}, {"a": 1})
    assert patch == {"b": None}
    return patch


def lists_replace_wholesale(m):
    patch = m.drift.diff_merge_patch(
        {"ports": [{"port": 80}, {"port": 1}]}, {"ports": [{"port": 80}]})
    assert patch == {"ports": [{"port": 80}]}  # RFC 7386: no splicing
    return patch


def inputs_never_aliased_into_patch(m):
    after = {"spec": {"items": [1, 2]}}
    patch = m.drift.diff_merge_patch({}, after)
    patch["spec"]["items"].append(3)
    assert after["spec"]["items"] == [1, 2]
    return after


# ------------------------------------------- Copy*Fields drift repair
def server_defaulted_object_is_a_noop(m):
    got = m.drift.minimal_update_patch(_sts(annotations={}),
                                       _sts(server_side=True),
                                       m.copy_statefulset_fields)
    assert got is None
    return got


def found_is_not_mutated(m):
    found = _sts(server_side=True)
    snapshot = m.k8s.deepcopy(found)
    patch = m.drift.minimal_update_patch(_sts(image="img:b"), found,
                                         m.copy_statefulset_fields)
    assert found == snapshot
    return patch


def patch_carries_only_drifted_paths_and_converges(m):
    desired = _sts(image="img:b")
    found = _sts(server_side=True)
    patch = m.drift.minimal_update_patch(desired, found,
                                         m.copy_statefulset_fields)
    assert set(patch) == {"spec"}              # metadata untouched
    assert set(patch["spec"]) == {"template"}  # replicas untouched
    patched = m.k8s.json_merge_patch(found, patch)
    assert m.k8s.get_in(patched, "spec", "template", "spec",
                        "containers")[0]["image"] == "img:b"
    assert m.drift.minimal_update_patch(
        desired, patched, m.copy_statefulset_fields) is None
    return patch, patched


def server_owned_fields_never_enter_the_patch(m):
    rng = random.Random(17)
    out = []
    for _ in range(50):
        desired = _sts(image=f"img:{rng.randint(0, 3)}",
                       replicas=rng.randint(0, 4),
                       labels={"statefulset": "nb",
                               f"l{rng.randint(0, 2)}": "v"})
        found = _sts(server_side=True)
        patch = m.drift.minimal_update_patch(desired, found,
                                             m.copy_statefulset_fields)
        out.append(patch)
        if patch is None:
            continue
        flat = str(patch)
        for field in ("resourceVersion", "uid", "creationTimestamp",
                      "managedFields", "status"):
            assert field not in flat
        patched = m.k8s.json_merge_patch(found, patch)
        assert m.drift.minimal_update_patch(
            desired, patched, m.copy_statefulset_fields) is None
    return out


def service_clusterip_survives_drift_repair(m):
    desired = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "nb", "namespace": "ns"},
        "spec": {"selector": {"statefulset": "nb"},
                 "ports": [{"name": "http", "port": 80}]},
    }
    found = m.k8s.deepcopy(desired)
    found["spec"]["clusterIP"] = "10.0.0.7"
    found["spec"]["ports"] = [{"name": "http", "port": 8080}]
    patch = m.drift.minimal_update_patch(desired, found,
                                         m.copy_service_fields)
    assert patch == {"spec": {"ports": [{"name": "http", "port": 80}]}}
    assert m.k8s.json_merge_patch(found, patch)["spec"]["clusterIP"] == \
        "10.0.0.7"
    return patch


# -------------------------------------------------------- semantic equal
def ignores_server_fields_and_empty_maps(m):
    got = m.drift.semantic_equal(_sts(annotations={}),
                                 _sts(server_side=True))
    assert got
    return got


def detects_real_drift(m):
    got = m.drift.semantic_equal(_sts(image="img:a"),
                                 _sts(image="img:b", server_side=True))
    assert not got
    return got


CASES = {fn.__name__: fn for fn in (
    equal_objects_produce_no_patch, apply_reproduces_after_exactly,
    patch_is_minimal, deleted_key_patches_to_null, lists_replace_wholesale,
    inputs_never_aliased_into_patch, server_defaulted_object_is_a_noop,
    found_is_not_mutated, patch_carries_only_drifted_paths_and_converges,
    server_owned_fields_never_enter_the_patch,
    service_clusterip_survives_drift_repair,
    ignores_server_fields_and_empty_maps, detects_real_drift)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drift_case_on_both_sides(case):
    assert CASES[case](SIDES["port"]) == CASES[case](SIDES["ref"])
