"""Regex partition rules: tree-path patterns → specs for any tree.

Port of ``kubeflow_tpu/parallel/partition_rules.py``. An ordered list of
``(regex, spec)`` rules is matched (``re.search``, first match wins)
against the '/'-joined path of each leaf of a tree, so one table lays out
the params and any optimizer state that embeds them: the port's AdamW
moments sit at ``mu/blocks/wq`` (or ``inner/mu/blocks/wq`` inside a
``MasterOptState``), the f32 masters at ``master/blocks/wq``, each ending
with the param's own path ``blocks/wq``. Scalars, size-1 tensors and host
values (the step count) are replicated.

``TRANSFORMER_RULES`` / ``MOE_RULES`` (``rules_for`` picks by config)
reproduce ``param_specs`` of each family under ``DEFAULT_RULES``
(tests/test_torch_parallel.py and tests/test_torch_sharded_moe.py hold
them to it): a tree laid out by either table is laid out as the sharded
steps and their checkpoints lay it out.
"""

from __future__ import annotations

import functools
import re

import torch

from .sharding import shard_tensor, unshard_tensor

TRANSFORMER_RULES: tuple[tuple[str, tuple], ...] = (
    (r"w[qkv]$", (None, "fsdp", "tp", None)),
    (r"wo$", (None, "tp", None, "fsdp")),
    (r"(w_gate|w_up)$", (None, "fsdp", "tp")),
    (r"w_down$", (None, "tp", "fsdp")),
    (r"(attn_norm|mlp_norm)$", (None, None)),
    (r"final_norm$", (None,)),
    (r"lm_head$", ("fsdp", "tp")),
    (r"embed$", ("tp", "fsdp")),
)

MOE_RULES: tuple[tuple[str, tuple], ...] = (
    (r"w[qkv]$", (None, "fsdp", "tp", None)),
    (r"wo$", (None, "tp", None, "fsdp")),
    (r"router$", (None, "fsdp", "ep")),
    (r"(w_gate|w_up)$", (None, "ep", "fsdp", "tp")),
    (r"w_down$", (None, "ep", "tp", "fsdp")),
    (r"(attn_norm|mlp_norm)$", (None, None)),
    (r"final_norm$", (None,)),
    (r"lm_head$", ("fsdp", "tp")),
    (r"embed$", ("tp", "fsdp")),
)


def rules_for(config) -> tuple[tuple[str, tuple], ...]:
    """Rule table for a model config (MoEConfig subclasses dense)."""
    from ..models.moe import MoEConfig
    return MOE_RULES if isinstance(config, MoEConfig) else TRANSFORMER_RULES


def _children(node) -> list[tuple[str, object]] | None:
    """(key, child) pairs of a dict or NamedTuple node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    return None


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of a tree of dicts and
    NamedTuples, in the tree's shape; ``path`` is '/'-joined."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = {k: map_with_path(fn, v, f"{path}/{k}" if path else k)
           for k, v in kids}
    if isinstance(tree, dict):
        return out
    return type(tree)(**out)


def match_partition_rules(rules, tree):
    """A tree of specs, shaped like ``tree``. Scalars, size-1 tensors and
    host values get ``()`` (replicated); every other tensor must match a
    rule, or the call raises: a large tensor silently replicated is the
    memory blow-up partition rules exist to prevent."""
    def spec(name, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0 \
                or leaf.numel() == 1:
            return ()
        for pattern, s in rules:
            if re.search(pattern, name):
                return s
        raise ValueError(f"no partition rule matches leaf {name!r} "
                         f"(shape {tuple(leaf.shape)})")
    return map_with_path(spec, tree)


def make_shard_and_gather_fns(mesh, spec_tree):
    """Per-leaf (shard_fns, gather_fns) trees: ``shard`` takes a full
    tensor to this rank's slice on ``mesh``, ``gather`` a rank's slice
    back to the full tensor (a collective: every rank calls it)."""
    def fns(fn):
        return map_with_path(
            lambda _, spec: functools.partial(fn, spec=spec, mesh=mesh),
            spec_tree)
    return fns(shard_tensor), fns(unshard_tensor)


def _zip_map(fn, tree, specs):
    kids = _children(tree)
    if kids is None:
        return fn(tree, specs)
    out = {k: _zip_map(fn, v, specs[k] if isinstance(specs, dict)
                       else getattr(specs, k)) for k, v in kids}
    return out if isinstance(tree, dict) else type(tree)(**out)


def shard_tree(tree, specs, mesh):
    """Each tensor of a full ``tree`` as this rank's slice under its spec
    in ``specs`` (a tree of the same shape); host values as they are."""
    return _zip_map(lambda x, s: shard_tensor(x, s, mesh)
                    if isinstance(x, torch.Tensor) else x, tree, specs)


def gather_tree(tree, specs, mesh):
    """The full tensors of a tree of this rank's slices (a collective)."""
    return _zip_map(lambda x, s: unshard_tensor(x, s, mesh)
                    if isinstance(x, torch.Tensor) else x, tree, specs)
