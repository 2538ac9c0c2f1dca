"""Tensor-parallel serving: run decode on a sharded mesh.

Port of ``kubeflow_tpu/runtime/sharded_decode.py``, for both model
families. A model whose weights exceed one card's memory serves by
sharding over the ``tp`` axis of a mesh: attention heads, the MLP hidden
and the vocab split across ranks (``DEFAULT_RULES``), the KV cache holds
each rank's own kv heads, and each layer sums ``wo``'s and ``w_down``'s
partial products over tp. An MoE's experts go over ``ep``
(``moe_param_logical_specs``): at decode every rank holds the whole
batch, routes all of its rows, runs its own experts' slots and sums the
combine over (tp, ep).

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
cost an all-gather per token). Both serving engines take a
``ShardedParams``: every rank of the mesh builds the engine, the mesh's
first rank takes the requests and broadcasts each iteration's plan
(runtime/serving.py).
"""

from __future__ import annotations

from ..models.quant import is_quantized
from ..models.train import tree_leaves, tree_unflatten
from ..models.transformer import TransformerConfig, check_mesh, param_specs
from ..parallel import comm
from ..parallel.sharding import DEFAULT_RULES, PartitionRules, shard_tensor


class ShardedParams(dict):
    """This rank's shards of a params tree, with the ``mesh`` and
    ``rules`` that placed them and the ``specs`` (the spec tree) they
    were sharded by."""

    def __init__(self, tree: dict, mesh, rules: PartitionRules,
                 specs: dict | None = None):
        super().__init__(tree)
        self.mesh = mesh
        self.rules = rules
        self.specs = specs

    def with_tree(self, tree: dict) -> "ShardedParams":
        """``tree`` (this one's leaves transformed) on the same
        placement."""
        return ShardedParams(tree, self.mesh, self.rules, self.specs)


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
    same full params. Quantized params are refused (``wo``'s scale has a
    size-1 heads axis that cannot shard, in the reference too): pass
    ``quantize=True`` to the engine, which quantizes the shards with
    global scales."""
    if any(is_quantized(w) for w in params["blocks"].values()) or \
            is_quantized(params["lm_head"]):
        raise NotImplementedError(
            "sharded decode takes unquantized params; shard the full "
            "weights and pass quantize=True to the engine instead")
    rules = rules or decode_rules()
    check_mesh(config, mesh, rules)
    specs = param_specs(config, rules)
    dev = comm.mesh_device(mesh)
    local = [shard_tensor(p.detach().to(dev), s, mesh)
             for p, s in zip(tree_leaves(params), tree_leaves(specs))]
    return ShardedParams(tree_unflatten(params, local), mesh, rules, specs)
