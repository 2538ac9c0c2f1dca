"""Int8 weight-only quantization for the serving path.

Port of ``kubeflow_tpu/models/quant.py``. A quantized
weight is a plain ``{"q": int8, "s": f32}`` dict whose scale keeps the
reduced dims, so slicing the stacked layer axis slices ``q`` and ``s``
together; ``wcast`` dequantizes at the point of use. Only matmul weights
quantize: the embedding (a gather), the norm vectors and the MoE router
stay as they are.

On params sharded for decode (``runtime.sharded_decode.ShardedParams``)
each scale is taken over the GLOBAL contraction axes, as the reference's
``jnp.max`` over a sharded array is: a max all-reduce over the mesh axes
the contraction dims are split on (tp for ``wo``'s heads and
``w_down``'s mlp). Each rank's result is its slice of the unsharded
tree's ``quantize_params``, bit for bit (a max is exact).
"""

from __future__ import annotations

import torch

from ..parallel import comm
from ..parallel.sharding import spec_axes

# contraction axes per weight leaf: the scale is taken over the axes the
# matmul reduces, one scale per OUTPUT channel (keepdim)
BLOCK_AXES = {
    "wq": (1,),        # (L, d, h, k)   contracts d
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),      # (L, h, k, d)   contracts (h, k)
    "w_gate": (1,),    # (L, d, f)      contracts d
    "w_up": (1,),
    "w_down": (1,),    # (L, f, d)      contracts f
}

# MoE expert weights carry an (L, E, ...) experts axis: one scale per
# expert and output channel. The router stays full precision: its top-k
# picks are more sensitive to rounding than the expert values, and it is
# small (d x E).
MOE_BLOCK_AXES = {
    **BLOCK_AXES,      # the attention weights are the dense model's
    "w_gate": (2,),    # (L, E, d, f)   contracts d
    "w_up": (2,),
    "w_down": (2,),    # (L, E, f, d)   contracts f
}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_weight(w: torch.Tensor, axes: tuple[int, ...], mesh=None,
                    spec: tuple | None = None) -> dict:
    """Symmetric int8 over ``axes`` with per-output-channel scales. With
    ``mesh`` and ``spec`` (``w`` is the rank's shard under ``spec``) the
    max runs over the whole of each contraction axis."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axes, keepdim=True)
    if mesh is not None:
        comm.all_reduce_(amax, mesh, [a for d in axes
                                      for a in spec_axes(spec[d])], op="max")
    scale = amax / 127.0
    scale = scale.clamp_min(1e-12)  # all-zero channels stay zero
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_params(params: dict) -> dict:
    """Serving params → int8 weight-only serving params; the f32 masters
    of the quantized leaves are dropped. Idempotent. MoE params (a
    ``router`` in the blocks) take ``MOE_BLOCK_AXES``. Sharded params
    (a ``mesh`` and ``specs`` on the tree) quantize with global scales
    and come back sharded: every rank of the mesh calls it."""
    if is_quantized(params.get("lm_head")):
        return params
    mesh = getattr(params, "mesh", None)
    specs = getattr(params, "specs", None) if mesh is not None else None

    def spec(*path):
        node = specs
        for k in path:
            node = None if node is None else node[k]
        return node
    blocks = params["blocks"]
    axes = MOE_BLOCK_AXES if "router" in blocks else BLOCK_AXES
    out = dict(params)
    out["blocks"] = {
        name: quantize_weight(w, axes[name], mesh, spec("blocks", name))
        if name in axes else w
        for name, w in blocks.items()
    }
    out["lm_head"] = quantize_weight(params["lm_head"], (0,), mesh,
                                     spec("lm_head"))           # (d, v)
    return out if mesh is None else params.with_tree(out)


def wcast(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight for compute: plain tensors cast, quantized nodes
    dequantize as ``q * s`` in ``dtype``."""
    if is_quantized(w):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)
