"""LoRA finetuning: low-rank adapters over a frozen base model.

Port of ``kubeflow_tpu/models/lora.py``. Each target weight W trains a
rank-r delta
W + (alpha/r)·A@B; the base stays frozen, so the optimizer state covers
the adapters only and a finetune's checkpoint is megabytes.

The adapters merge into the base weights inside the step (``merge_lora``),
so the forward and backward are the base model's own: the flash kernels,
the remat policies and the chunked CE apply unchanged. The base enters the
merge detached, so autograd computes no base-weight gradient. Adapter
weights carry the stacked ``layers`` axis like every block weight. Serving
needs no LoRA code: ``merge_lora`` once, then the merged tree is a plain
model.

B starts at zero, so a fresh adapter reproduces the base model exactly.

On a mesh (``make_sharded_lora_step``) an adapter shards like its base
weight's input and output axes, the rank axis whole
(``lora_logical_specs``): ``A_local @ B_local`` is then exactly the
local block of the merged delta, so the merge needs no communication.
``A``'s grad contracts over the output axes, ``B``'s over the input
axes, so each is summed over the axes the other side is sharded on that
it is not (tp for ``A`` of wq, fsdp for ``B`` of wq), as well as over
the data axes: each adapter leaf's grad is summed over every axis of
(dp, fsdp, sp, tp) it is not sharded on.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from .. import resolve_device
from .transformer import TransformerConfig

# per target: (input logical axes, output logical axes) of the base weight
# (without the leading "layers")
_TARGET_AXES = {
    "wq": (("embed",), ("heads", "head_dim")),
    "wk": (("embed",), ("kv_heads", "head_dim")),
    "wv": (("embed",), ("kv_heads", "head_dim")),
    "wo": (("heads", "head_dim"), ("embed",)),
    "w_gate": (("embed",), ("mlp",)),
    "w_up": (("embed",), ("mlp",)),
    "w_down": (("mlp",), ("embed",)),
}


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        unknown = set(self.targets) - set(_TARGET_AXES)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)}; "
                             f"valid: {sorted(_TARGET_AXES)}")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _axis_dim(config: TransformerConfig, axis: str) -> int:
    """Logical axis name → its dimension on this config."""
    return {"embed": config.d_model, "heads": config.n_heads,
            "kv_heads": config.n_kv_heads, "head_dim": config.d_head,
            "mlp": config.d_ff}[axis]


def _target_dims(config: TransformerConfig, name: str):
    """(in_shape, out_shape) of one layer's base weight, without the layer
    axis."""
    in_axes, out_axes = _TARGET_AXES[name]
    return (tuple(_axis_dim(config, a) for a in in_axes),
            tuple(_axis_dim(config, a) for a in out_axes))


def init_lora_params(generator: torch.Generator, config: TransformerConfig,
                     lora: LoRAConfig, device="cuda") -> dict:
    """{"blocks": {target: {"A": (L, *in, r), "B": (L, r, *out)}}}, drawn
    from ``generator`` (on its own device) in sorted target order and
    placed on ``device``. A ~ N(0, 1/in_features), B = 0: the initial
    delta is exactly zero."""
    c = config
    dev = resolve_device(device)
    pdt = c.torch_param_dtype
    blocks = {}
    for name in sorted(lora.targets):
        in_shape, out_shape = _target_dims(c, name)
        a = torch.randn((c.n_layers, *in_shape, lora.rank),
                        generator=generator, dtype=pdt,
                        device=generator.device)
        blocks[name] = {
            "A": (a / math.sqrt(math.prod(in_shape))).to(dev),
            "B": torch.zeros((c.n_layers, lora.rank, *out_shape), dtype=pdt,
                             device=dev),
        }
    return {"blocks": blocks}


def lora_logical_specs(config: TransformerConfig, lora: LoRAConfig) -> dict:
    """Logical-axis names per adapter leaf: the base weight's rules on
    the input/output axes, the rank axis unsharded — feed to the
    partition rules like any other spec tree."""
    blocks = {}
    for name in sorted(lora.targets):
        in_axes, out_axes = _TARGET_AXES[name]
        blocks[name] = {
            "A": ("layers", *in_axes, None),
            "B": ("layers", None, *out_axes),
        }
    return {"blocks": blocks}


def lora_specs(config: TransformerConfig, lora: LoRAConfig,
               rules=None) -> dict:
    """The mesh spec of each adapter leaf under ``rules`` (default
    ``DEFAULT_RULES``)."""
    from ..parallel.sharding import spec_tree
    return spec_tree(lora_logical_specs(config, lora), rules)


def merge_lora(params: dict, lora_params: dict, lora: LoRAConfig) -> dict:
    """Base params + (alpha/r)·A@B per target: the effective weights. The
    delta is cast to the base weight's dtype before the add, as in the
    reference, so a bf16 base merges as the reference's does."""
    blocks = dict(params["blocks"])
    for name, ab in lora_params["blocks"].items():
        delta = _rank_contract(ab["A"], ab["B"])
        blocks[name] = blocks[name] + lora.scale * \
            delta.to(blocks[name].dtype)
    return {**params, "blocks": blocks}


def _rank_contract(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L, *in, r) × (L, r, *out) → (L, *in, *out) as one batched
    matmul."""
    L, r = A.shape[0], A.shape[-1]
    in_shape, out_shape = A.shape[1:-1], B.shape[2:]
    return torch.matmul(A.reshape(L, -1, r), B.reshape(L, r, -1)).reshape(
        L, *in_shape, *out_shape)


def make_lora_step(config: TransformerConfig, lora: LoRAConfig, tc=None,
                   device="cuda"):
    """The one-device counterpart of ``make_sharded_lora_step``:
    ``(init_fn(generator), step_fn(base, lora_params, opt_state, tokens,
    targets))``.

    - ``init_fn`` draws the adapters onto ``device`` and returns them with
      their AdamW state;
    - ``step_fn`` merges the adapters into the detached ``base`` and runs
      ``train_step`` over the adapters alone (gradients, clipping and
      AdamW): it returns (lora_params, opt_state, loss), updated in place;
      ``base`` is never written.

    Adapters are small, so they stay in full precision: ``bf16_params`` (a
    dense-step lever) is refused rather than ignored."""
    from .train import (TrainConfig, build_loss, make_optimizer, tree_map,
                        train_step)
    tc = tc or TrainConfig()
    if tc.bf16_params:
        raise ValueError(
            "bf16_params is a dense-step lever (f32 master copies of the "
            "full weights); LoRA adapters are small enough to keep in "
            "full precision — drop the flag for the lora step")
    dev = resolve_device(device)
    optimizer = make_optimizer(tc)
    loss = build_loss(config, tc)

    def init_fn(generator: torch.Generator):
        lp = tree_map(lambda p: p.requires_grad_(),
                      init_lora_params(generator, config, lora, dev))
        return lp, optimizer.init(lp)

    def _loss(base, lora_params, tokens, targets):
        frozen = tree_map(torch.Tensor.detach, base)
        return loss(merge_lora(frozen, lora_params, lora), tokens, targets)

    def step_fn(base, lora_params, opt_state, tokens, targets):
        return train_step(lora_params, opt_state, tokens, targets,
                          loss=functools.partial(_loss, base),
                          optimizer=optimizer)

    return init_fn, step_fn


def make_sharded_lora_step(mesh, config: TransformerConfig,
                           lora: LoRAConfig, tc=None, rules=None):
    """``(init_fn, step_fn)`` for adapter-only training on ``mesh``, run
    by every rank (SPMD).

    - ``init_fn(generator)`` draws the full adapters from ``generator``
      (seeded alike on every rank) and returns the rank's shards
      (``lora_logical_specs`` under ``rules``) with their AdamW state;
    - ``step_fn(base, lora_params, opt_state, tokens, targets)`` takes
      the base as the rank's shards (``param_specs``; frozen: it enters
      the merge detached and is never written) and the rank's batch
      slice, and returns (lora_params, opt_state, loss), updated in
      place, the loss the global token mean.

    ``bf16_params`` and a pp mesh are refused, as in the reference. On a
    mesh of one rank it is ``make_lora_step``'s step, op for op."""
    from ..parallel import comm
    from ..parallel.sharding import PartitionRules, sharded_axes
    from .train import (TrainConfig, build_loss, data_axes,
                        grad_reduce_axes, make_optimizer, sharded_update,
                        tree_leaves, tree_map, tree_unflatten)
    from .transformer import check_mesh
    tc = tc or TrainConfig()
    if tc.bf16_params:
        raise ValueError(
            "bf16_params is a dense-step lever (f32 master copies of the "
            "full weights); LoRA adapters are small enough to keep in "
            "full precision — drop the flag for the lora step")
    if comm.axis_size(mesh, "pp") > 1:
        raise ValueError(
            "LoRA uses the scanned (non-pipelined) forward; a pp>1 mesh "
            "would silently waste its pipeline axis and disagree with "
            "evaluation's pipelined path — finetune on a tp/fsdp/dp mesh "
            "(adapters are small; pipeline parallelism buys nothing here)")
    rules = rules or PartitionRules()
    check_mesh(config, mesh, rules)
    leaf_specs = tree_leaves(lora_specs(config, lora, rules))
    optimizer = make_optimizer(
        tc, mesh, [tuple(sorted(sharded_axes(s))) for s in leaf_specs])
    loss = build_loss(config, tc, mesh=mesh, rules=rules)
    dev = comm.mesh_device(mesh)
    from ..parallel.sharding import shard_tensor

    def init_fn(generator: torch.Generator):
        full = init_lora_params(generator, config, lora, dev)
        lp = tree_unflatten(full, [
            shard_tensor(p, s, mesh).requires_grad_()
            for p, s in zip(tree_leaves(full), leaf_specs)])
        return lp, optimizer.init(lp)

    def _loss(base, lora_params, tokens, targets):
        frozen = tree_map(torch.Tensor.detach, base)
        return loss(merge_lora(frozen, lora_params, lora), tokens, targets)

    step = sharded_update(
        mesh, _loss, optimizer,
        grad_reduce_axes(leaf_specs, data_axes(rules) + ("tp",)), rules)

    def step_fn(base, lora_params, opt_state, tokens, targets):
        return step(lora_params, opt_state, tokens, targets,
                    loss=functools.partial(_loss, base))

    return init_fn, step_fn


def lora_num_params(config: TransformerConfig, lora: LoRAConfig) -> int:
    total = 0
    for name in lora.targets:
        in_shape, out_shape = _target_dims(config, name)
        total += config.n_layers * lora.rank * (
            math.prod(in_shape) + math.prod(out_shape))
    return total
