"""Tensor-parallel serving: run decode on a sharded mesh.

Port of ``kubeflow_tpu/runtime/sharded_decode.py`` for the dense family.
A model whose weights exceed one card's memory serves by sharding over
the ``tp`` axis of a mesh: attention heads, the MLP hidden and the vocab
split across ranks (``DEFAULT_RULES``), the KV cache holds each rank's
own kv heads, and each layer sums ``wo``'s and ``w_down``'s partial
products over tp.

In the reference the placement is data: GSPMD propagates the input
shardings through the unchanged jitted decode functions. Here
``shard_decode_params`` returns this rank's shards in a ``ShardedParams``
(a dict that also carries its mesh and rules), and models/decode.py
reads the placement from it, so ``generate``, ``decode_step``,
``decode_window`` and ``speculative_generate`` take the sharded tree
unchanged. They are SPMD: every rank of the mesh calls them with the
same inputs, and every rank returns the same ids.

``decode_rules`` replicates ``embed`` (the reference's choice for a
serving mesh that keeps a real fsdp axis: fsdp-sharded weights would
cost an all-gather per token). The serving engines and the HTTP server
over a tp mesh need one rank to broadcast each tick's admissions to the
others; they are not ported yet (ROADMAP queue A, multi-device part 2).
"""

from __future__ import annotations

from ..models.quant import is_quantized
from ..models.train import tree_leaves, tree_unflatten
from ..models.transformer import TransformerConfig, check_mesh, param_specs
from ..parallel import comm
from ..parallel.sharding import DEFAULT_RULES, PartitionRules, shard_tensor


class ShardedParams(dict):
    """This rank's shards of a params tree, with the ``mesh`` and
    ``rules`` that placed them."""

    def __init__(self, tree: dict, mesh, rules: PartitionRules):
        super().__init__(tree)
        self.mesh = mesh
        self.rules = rules


def decode_rules() -> PartitionRules:
    """DEFAULT_RULES with ``embed`` replicated: serving keeps its weights
    resident instead of gathering them over fsdp every token."""
    return PartitionRules(rules=tuple((k, None) if k == "embed" else (k, v)
                                      for k, v in DEFAULT_RULES))


def shard_decode_params(params: dict, mesh, config: TransformerConfig,
                        rules: PartitionRules | None = None) -> ShardedParams:
    """This rank's shards of the full ``params`` on ``mesh`` (on the
    mesh's device) under ``rules`` (default ``decode_rules()``), for the
    decode functions of models/decode.py. Every rank calls it with the
    same full params."""
    from ..models.moe import MoEConfig
    if isinstance(config, MoEConfig):
        raise NotImplementedError(
            "sharded decode of the MoE family is not ported yet (ROADMAP "
            "queue A, multi-device part 2)")
    if any(is_quantized(w) for w in params["blocks"].values()) or \
            is_quantized(params["lm_head"]):
        raise NotImplementedError("sharded decode takes unquantized params")
    rules = rules or decode_rules()
    check_mesh(config, mesh, rules)
    specs = param_specs(config, rules)
    dev = comm.mesh_device(mesh)
    local = [shard_tensor(p.detach().to(dev), s, mesh)
             for p, s in zip(tree_leaves(params), tree_leaves(specs))]
    return ShardedParams(tree_unflatten(params, local), mesh, rules)
