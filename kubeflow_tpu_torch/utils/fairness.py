"""Shared fair-share and bin-packing primitives for slice capacity.

The port's copy of ``kubeflow_tpu/utils/fairness.py`` (the port imports
nothing of the JAX package). The slice-pool controller's admission and
the fleet scheduler arbitrate contention with the SAME policy (weighted
max-min fair share, Hadoop-fair-scheduler shape) instead of two drifting
copies. The bin-packing helper generalizes the pool's first-fit across
mixed H100 topologies for gang placement.
"""

from __future__ import annotations

from . import k8s


def fair_share_admit(pending: list[dict], weights: dict[str, int],
                     capacity: int) -> tuple[list[dict], list[dict]]:
    """Weighted max-min admission over a contended pool: repeatedly grant
    one slice to the namespace with the highest ``weight / (granted + 1)``
    (ties by namespace name), FIFO within a namespace. Returns
    (admitted, rejected) preserving each namespace's arrival order —
    the Hadoop-fair-scheduler shape, deterministic for tests."""
    queues: dict[str, list[dict]] = {}
    for nb in pending:
        queues.setdefault(k8s.namespace(nb), []).append(nb)
    granted = {ns: 0 for ns in queues}
    admitted: list[dict] = []
    while capacity > 0 and any(queues.values()):
        ns = min((ns for ns in queues if queues[ns]),
                 key=lambda n: (-(weights.get(n, 1) / (granted[n] + 1)), n))
        admitted.append(queues[ns].pop(0))
        granted[ns] += 1
        capacity -= 1
    rejected = [nb for ns in sorted(queues) for nb in queues[ns]]
    return admitted, rejected


def first_fit_pack(requests: list[tuple[str, int]],
                   bins: dict[str, int]) -> tuple[dict[str, str],
                                                  list[str]]:
    """First-fit gang placement over mixed-topology capacity bins — the
    generalization of the pool's lowest-named-pool-with-capacity rule.
    ``requests`` is ``[(gang_key, slices_needed), ...]`` in arrival
    order; ``bins`` maps a bin name (accelerator topology or pool) to
    its free slice count. Each gang lands whole in the lowest-named bin
    that still fits it (gangs never split across bins — that is the
    atomicity the scheduler's reservation protects). Returns
    ``(placements {gang_key: bin}, unplaced [gang_key, ...])``; ``bins``
    is not mutated."""
    free = dict(bins)
    placements: dict[str, str] = {}
    unplaced: list[str] = []
    for key, need in requests:
        chosen = None
        for name in sorted(free):
            if free[name] >= need:
                chosen = name
                break
        if chosen is None:
            unplaced.append(key)
        else:
            free[chosen] -= need
            placements[key] = chosen
    return placements, unplaced
