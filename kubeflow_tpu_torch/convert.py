"""Params between the JAX package and the port: numpy arrays ↔ tensors.

The JAX package's params are a nested dict of arrays whose layer weights
are stacked on a leading (L, ...) axis, with quantized weights as
``{"q": int8, "s": f32}`` nodes (models/quant.py). The port keeps that
exact tree, so conversion is leaf by leaf and the round trip is exact:
``to_numpy(to_torch(tree))`` equals ``tree`` bit for bit. The caller hands
over numpy arrays (``jax.tree.map(np.asarray, params)``); this module
imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _bf16_numpy_dtype():
    import ml_dtypes  # numpy's bfloat16, as JAX arrays convert to
    return np.dtype(ml_dtypes.bfloat16)


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays → the same tree of tensors on
    ``device``. bfloat16 arrays keep their bits."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    arr = np.array(tree)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(tree):
    """Nested dict of tensors → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_numpy_dtype())
    return t.numpy()


def _adam_leaves(state):
    """The (count, mu, nu) node of an AdamW state: the fused form's
    ``FusedAdamWState`` itself, or the ``ScaleByAdamState`` inside an
    ``optax.chain(clip_by_global_norm, adamw)`` state (nested tuples)."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, tuple):
        for part in state:
            found = _adam_leaves(part)
            if found is not None:
                return found
    return None


def opt_state_to_torch(state, device="cpu"):
    """The reference's AdamW state, with numpy leaves
    (``jax.tree.map(np.asarray, opt_state)``), as the port's
    ``FusedAdamWState`` (count, mu, nu) — or, for a ``MasterOptState``
    (``inner``, ``master``), the port's ``MasterOptState`` with the f32
    masters. The count becomes a host int."""
    from .models.train import FusedAdamWState, MasterOptState

    if hasattr(state, "inner") and hasattr(state, "master"):
        return MasterOptState(inner=opt_state_to_torch(state.inner, device),
                              master=to_torch(state.master, device))
    adam = _adam_leaves(state)
    if adam is None:
        raise ValueError(f"no AdamW (count, mu, nu) state in "
                         f"{type(state).__name__}")
    return FusedAdamWState(count=int(np.asarray(adam.count)),
                           mu=to_torch(adam.mu, device),
                           nu=to_torch(adam.nu, device))


def to_torch_sharded(tree, mesh, config, rules=None, specs=None):
    """The reference's params (numpy, as for ``to_torch``) as this rank's
    shards on ``mesh`` under ``rules`` (default ``DEFAULT_RULES``), on the
    mesh's device: the same weights on any mesh. ``specs`` (a spec tree
    shaped like ``tree``) lays out another tree, such as LoRA adapters
    (``models.lora.lora_specs``); by default the model's
    ``param_specs`` (an MoE's for an ``MoEConfig``)."""
    from .models.transformer import param_specs
    from .parallel.comm import mesh_device
    from .parallel.partition_rules import shard_tree
    return shard_tree(to_torch(tree, mesh_device(mesh)),
                      specs or param_specs(config, rules), mesh)
