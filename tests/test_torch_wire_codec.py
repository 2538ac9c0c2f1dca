"""The port's binary wire codec and its negotiation held against the
reference's.

The eight codec cases of tests/test_wire_codec.py run through both
packages (the case's own body on each side's ``codec``), and every
``encode`` a case makes is recorded: both sides must produce the same
bytes for the same values. Then the cross-decoding the wire rests on:
500 Kubernetes-shaped objects drawn with numpy from one seed, encoded
by each package, decoded by the other, with equal bytes and equal
frames.

The six wire cases run twice with the reference's ``HttpApiClient``:
against the reference's apiserver and against the port's, each with
the case's own assertions. What each server answered (status,
``Content-Type``, bodies decoded by format, watch frames) is compared
after ``torch_wire``'s normalisation; on the mixed-fleet case, whose
watch threads race the test's writes, the frames compared are the
fleet's events on each stream, in order.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import test_wire_codec as ref_cases
from kubeflow_tpu.cluster import codec as ref_codec
from kubeflow_tpu_torch.cluster import codec
from torch_wire import SIDES, run_both, side_globals, store_state, wire_case

SEED = 22

CODEC_CASES = [
    "test_roundtrip_property_seeded",
    "test_roundtrip_k8s_shaped_object",
    "test_every_truncation_raises_codec_error",
    "test_trailing_garbage_and_bad_envelope_rejected",
    "test_unencodable_values_rejected",
    "test_static_table_is_pinned_wire_format",
    "test_frame_event_parse_event_roundtrip",
    "test_accepts_binary_negotiation",
]


class _RecordingCodec:
    """A side's codec module that keeps every (value, bytes) it encodes."""

    def __init__(self, mod) -> None:
        self._mod = mod
        self.encoded: list = []

    def encode(self, value):
        out = self._mod.encode(value)
        self.encoded.append((repr(value), out))
        return out

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.mark.parametrize("name", CODEC_CASES)
def test_codec_case(name):
    def run(s, mp):
        with side_globals(mp, ref_cases, s.side, errors=True):
            assert ref_cases.codec is s.codec
            rec = _RecordingCodec(s.codec)
            mp.setattr(ref_cases, "codec", rec)
            getattr(ref_cases, name)()
        return rec.encoded
    out = run_both(run)
    assert out["port"] == out["ref"]


def _k8s_object(rng, i: int) -> dict:
    """A Kubernetes-shaped object: static-table keys, repeated names,
    ints across varint widths, floats, nulls, nested lists."""
    words = ["nb", "team-a", "jupyter", "trainer", "cuda", "v5e", "h100",
             "ready", "é☃", "", "x" * int(rng.integers(1, 300))]
    name = f"obj-{i}-{words[rng.integers(len(words))]}"
    ns = ["default", "team-a", "team-b", "kubeflow"][rng.integers(4)]
    kind = ["Notebook", "Pod", "ConfigMap", "StatefulSet", "Lease",
            "Service"][rng.integers(6)]
    labels = {f"l{j}": words[rng.integers(len(words))]
              for j in range(rng.integers(0, 5))}
    labels["notebook-name"] = name
    obj = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": name, "namespace": ns,
                        "resourceVersion": str(rng.integers(1, 10**6)),
                        "generation": int(rng.integers(1, 50)),
                        "labels": labels,
                        "ownerReferences": [{
                            "kind": "Notebook", "name": name,
                            "controller": bool(rng.integers(2))}]},
           "spec": {"replicas": int(rng.integers(0, 9)),
                    "template": {"spec": {"containers": [
                        {"name": name, "image": words[rng.integers(11)],
                         "env": [{"name": f"E{j}",
                                  "value": str(rng.integers(-2**40, 2**40))}
                                 for j in range(rng.integers(0, 6))],
                         "resources": {"limits": {
                             "cpu": str(rng.integers(1, 64)),
                             "memory": f"{rng.integers(1, 512)}Gi"}}}]}}},
           "status": {"readyReplicas": int(rng.integers(0, 9)),
                      "ratio": float(rng.random()),
                      "big": int(rng.integers(0, 2**62)) * 2**20,
                      "neg": -int(rng.integers(0, 2**31)),
                      "missing": None,
                      "conditions": [{"type": "Ready", "status": "True"}]}}
    return obj


def test_cross_decoding_equal_bytes():
    rng = np.random.default_rng(SEED)
    for i in range(500):
        obj = _k8s_object(rng, i)
        mine, theirs = codec.encode(obj), ref_codec.encode(obj)
        assert mine == theirs, i
        assert ref_codec.decode(mine) == obj
        assert codec.decode(theirs) == obj
        frame = codec.frame_event("MODIFIED", mine)
        assert frame == ref_codec.frame_event("MODIFIED", theirs)
        assert ref_codec.parse_event(frame[4:]) == ("MODIFIED", obj)
        assert codec.parse_event(frame[4:]) == ("MODIFIED", obj)
    assert codec.STATIC_STRINGS == ref_codec.STATIC_STRINGS
    assert codec.BINARY_CONTENT_TYPE == ref_codec.BINARY_CONTENT_TYPE
    assert codec.BINARY_PATCH_CONTENT_TYPE == \
        ref_codec.BINARY_PATCH_CONTENT_TYPE


WIRE_CASES = [
    "test_every_verb_binary_json_equivalence",
    "test_update_status_subresource_over_binary",
    "test_response_content_type_negotiated",
    "test_malformed_binary_request_body_is_422",
    "test_mixed_fleet_watch_same_ring",
]


def _fleet_frames(records: list) -> list:
    """Each stream's fleet-* events, in order; the rest as it stands."""
    out = []
    for rec in records:
        if "frames" in rec:
            rec = {**rec, "frames": [
                f for f in rec["frames"]
                if f[0] != "BOOKMARK"
                and f[1]["metadata"]["name"].startswith("fleet-")]}
            if not rec["frames"]:
                continue
        elif rec["method"] == "GET" and "configmaps?" in rec["path"]:
            continue   # the watchers' resync LISTs race the writes
        out.append(rec)
    return sorted(out, key=json.dumps)


@pytest.mark.parametrize("name", WIRE_CASES)
def test_wire_case(name):
    def run(s, mp):
        tap, st = wire_case(ref_cases, name, s, mp)
        records = tap.normalised(s), store_state(st, s.side)
        if name == "test_mixed_fleet_watch_same_ring":
            records = _fleet_frames(records[0]), records[1]
        return records
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_malformed_binary_response_is_retryable_transport_error():
    """A client case: a body claiming either side's binary media type
    that does not decode takes the transport-retry path."""
    def run(s, mp):
        with side_globals(mp, ref_cases, s.side):
            assert ref_cases.codec is s.codec
            ref_cases.test_malformed_binary_response_is_retryable_transport_error()
        return ref_cases._GarbageBinaryHandler.hits
    out = run_both(run)
    assert out["port"] == out["ref"] == 3
    assert SIDES["port"].codec.BINARY_CONTENT_TYPE == \
        SIDES["ref"].codec.BINARY_CONTENT_TYPE
