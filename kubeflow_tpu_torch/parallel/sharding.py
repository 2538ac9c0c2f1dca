"""Partition rules: logical axis names → mesh axes → placements.

Port of ``kubeflow_tpu/parallel/sharding.py``. Rules map the logical
axes of a tensor ("vocab", "embed", "mlp", "heads", "batch", "seq", ...)
to mesh axes, so a model declares its layout once and any mesh lays it
out. A spec is the port's ``PartitionSpec``: a tuple with one entry per
tensor dim, each None (replicated), a mesh axis name, or a tuple of
names (sharded over their product, the first outermost).

The compute runs on local tensors: a rank holds the slice of each tensor
that its mesh coordinates select (``Sharding.shard``), and the code
places the collectives that GSPMD would insert. ``Sharding.placements``
gives the same layout as DTensor placements (``Shard(d)`` /
``Replicate()`` per mesh axis), for code that wants a ``DTensor`` view;
the port's own kernels and autograd Functions take the local tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import comm

# Megatron TP + ZeRO-3 FSDP + sequence parallelism, the reference's:
# column-parallel weights shard their output dim on tp, row-parallel their
# input dim; the other big dim on fsdp; batch over (dp, fsdp); sequence
# over sp; experts over ep.
DEFAULT_RULES: tuple[tuple[str, str | tuple | None], ...] = (
    ("vocab", "tp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("experts", "ep"),
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("layers", None),
    ("stages", "pp"),
    ("norm", None),
)


@dataclass(frozen=True)
class PartitionRules:
    rules: tuple = DEFAULT_RULES

    def spec(self, *logical_axes: str | None) -> tuple:
        mapping = dict(self.rules)
        out = []
        for ax in logical_axes:
            if ax is not None and ax not in mapping:
                raise KeyError(f"no partition rule for logical axis {ax!r}")
            out.append(None if ax is None else mapping[ax])
        return tuple(out)

    def sharding(self, mesh, *logical_axes: str | None) -> "Sharding":
        return Sharding(mesh, self.spec(*logical_axes))


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: tuple) -> set[str]:
    """Every mesh axis a spec shards over."""
    return {a for entry in spec for a in spec_axes(entry)}


def shard_tensor(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a contiguous copy;
    ``full`` itself on a mesh of size 1)."""
    out = full
    for dim, entry in enumerate(spec):
        n = comm.axis_size(mesh, spec_axes(entry))
        if n == 1:
            continue
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {full.shape[dim]} does not "
                             f"divide over {spec_axes(entry)} ({n} ranks)")
        out = out.chunk(n, dim=dim)[comm.axis_rank(mesh, spec_axes(entry))]
    return out if out is full else out.contiguous()


def unshard_tensor(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor of the slices ``local`` of every rank (all-gather
    over each sharded dim; not differentiated)."""
    for dim, entry in enumerate(spec):
        local = comm.gather_dim(local, mesh, spec_axes(entry), dim)
    return local.contiguous()


def gather_for_compute(w: torch.Tensor, spec: tuple, mesh,
                       keep: tuple = ("tp",)) -> torch.Tensor:
    """``w`` gathered over every sharded axis but ``keep``, differentiated
    (the backward reduce-scatters): an fsdp-sharded weight made whole
    for the matmul that uses it, its tp shard kept."""
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if a not in keep)
        w = comm.all_gather(w, mesh, axes, dim)
    return w


class Sharding(NamedTuple):
    """A mesh and a spec: the port's ``NamedSharding``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The layout as DTensor placements, one per mesh axis."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec)
                    if name in spec_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return shard_tensor(full, self.spec, self.mesh)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return unshard_tensor(local, self.spec, self.mesh)


def batch_sharding(mesh, accum: bool = False,
                   rules: PartitionRules | None = None) -> Sharding:
    """Input batches shard over the data axes and the sequence axis; with
    ``accum`` the leading microbatch axis stays whole (looped over)."""
    spec = (rules or PartitionRules()).spec("batch", "seq")
    return Sharding(mesh, ((None,) if accum else ()) + spec)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def spec_tree(param_specs, rules: PartitionRules | None = None):
    """A tree of logical-axis tuples as the same tree of mesh specs."""
    rules = rules or PartitionRules()
    if isinstance(param_specs, dict):
        return {k: spec_tree(v, rules) for k, v in param_specs.items()}
    if not _is_logical(param_specs):
        raise TypeError(f"not a logical spec: {param_specs!r}")
    return rules.spec(*param_specs)


def param_shardings(mesh, param_specs, rules: PartitionRules | None = None):
    """A tree of logical-axis tuples as the same tree of ``Sharding``."""
    specs = spec_tree(param_specs, rules)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return Sharding(mesh, node)
    return build(specs)

