"""The stable hash of sharded reconcile ownership.

The port's copy of ``fnv1a`` from ``kubeflow_tpu/controllers/sharding.py``,
which the apiserver's priority and fairness (``cluster/apf.py``) hashes
flows with for shuffle sharding. The rest of that module (the namespace
shard map, ``assign_shards`` and the per-shard lease coordinator) waits
for the manager's sharding and the binaries (ROADMAP queue A, item 9).
"""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: str) -> int:
    """64-bit FNV-1a over the UTF-8 bytes, finished with the murmur3
    fmix64 avalanche: stable across processes (Python's ``hash`` is
    salted per process), and full-width even for short near-identical
    keys, which raw FNV-1a barely diffuses."""
    h = _FNV_OFFSET
    for byte in data.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h
