"""Mixture-of-Experts transformer LM: the second model family.

Port of ``kubeflow_tpu/models/moe.py`` for one device (the expert-axis
shardings, ``moe_param_logical_specs``, ``pipelined_moe_forward_hidden``
and the sharded step come with the multi-device slice of the port: ROADMAP
queue A, multi-device). The attention stack, norms and RoPE are the dense
model's; only the MLP is replaced by E experts with top-k routing.

Routing is the reference's exactly: a float32 router (TF32 must stay off on
the card, or picks flip), softmax, top-k with the lower expert first on
ties, gates normalised over the k picks before any drop, and per-group
capacity filled first-come in (batch, seq) order, every top-1 pick before
any top-2 pick. A pick over capacity keeps weight 0; the residual carries
its token.

The reference contracts dense one-hot (G, g, E, C) dispatch/combine
tensors, which at b8 x s1024 cost about a third of the expert FFN's
operations. The port keeps the same assignment in index form instead: each
(token, pick) has an expert, a slot and a gate weight; the tokens are
gathered into a (G, E, C, D) buffer, the three expert products run as
batched matmuls over E, and each token gathers its k outputs back and adds
them, gate-weighted, in pick order. Nothing adds with atomics in an order
that can change between runs: each slot holds one token, so the backward
of the combine gather writes one addend into each slot, and the backward
of the dispatch gather adds at most k addends into a token (k = 2 in every
configuration here, and a sum of two floats does not depend on their
order). ``route_tokens`` keeps the reference's dense ``(combine, dispatch,
aux)`` signature, built from the indices, so the routing can be held to
the JAX package element by element.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from .quant import wcast
from .transformer import (TransformerConfig, attention_block, lm_head_logits,
                          resolve_layer_remat, resolve_remat_mlp, rms_norm,
                          rope_frequencies, unstack_layers)


@dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    experts_per_token: int = 2       # top-k routing
    capacity_factor: float = 1.25    # expert capacity ~ group/E * factor * k
    router_aux_coef: float = 0.01    # weight of the load-balance loss
    # tokens are routed in groups of at most this many, each with its own
    # capacity (GShard's grouping)
    route_group_size: int = 2048


# ------------------------------------------------------------------ params
def init_moe_params(generator: torch.Generator, config: MoEConfig,
                    device="cuda") -> dict:
    """Random params drawn from ``generator`` (on its own device), placed
    on ``device``. Same shapes, dtypes and scales as the JAX package's
    ``init_moe_params``; the numbers differ (another RNG). Expert weights
    carry a leading (L, E, ...) axis; ``router`` is (L, d_model, E)."""
    c = config
    dev = resolve_device(device)
    pdt = c.torch_param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pdt,
                        device=generator.device)
        return (w / math.sqrt(fan_in)).to(dev)

    L, E = c.n_layers, c.n_experts
    embed = torch.randn((c.vocab_size, c.d_model), generator=generator,
                        dtype=pdt, device=generator.device).to(dev)
    blocks = {
        "attn_norm": torch.ones((L, c.d_model), dtype=pdt, device=dev),
        "wq": dense((L, c.d_model, c.n_heads, c.d_head), c.d_model),
        "wk": dense((L, c.d_model, c.n_kv_heads, c.d_head), c.d_model),
        "wv": dense((L, c.d_model, c.n_kv_heads, c.d_head), c.d_model),
        "wo": dense((L, c.n_heads, c.d_head, c.d_model),
                    c.n_heads * c.d_head),
        "mlp_norm": torch.ones((L, c.d_model), dtype=pdt, device=dev),
        "router": dense((L, c.d_model, E), c.d_model),
        "w_gate": dense((L, E, c.d_model, c.d_ff), c.d_model),
        "w_up": dense((L, E, c.d_model, c.d_ff), c.d_model),
        "w_down": dense((L, E, c.d_ff, c.d_model), c.d_ff),
    }
    return {
        "embed": embed,
        "blocks": blocks,
        "final_norm": torch.ones((c.d_model,), dtype=pdt, device=dev),
        "lm_head": dense((c.d_model, c.vocab_size), c.d_model),
    }


# ------------------------------------------------------------------ routing
def expert_capacity(n_tokens: int, config: MoEConfig) -> int:
    """Per-expert capacity of one routing group:
    ceil(group/E * factor * k), at least 4."""
    c = config
    cap = math.ceil(n_tokens / c.n_experts * c.capacity_factor
                    * c.experts_per_token)
    return max(4, cap)


def num_route_groups(n_tokens: int, group_size: int) -> int:
    """Smallest group count G with N % G == 0 and N/G <= group_size (G = 1
    when N fits in one group)."""
    groups = max(1, math.ceil(n_tokens / group_size))
    while n_tokens % groups:
        groups += 1
    return groups


def route_indices(router_logits: torch.Tensor, config: MoEConfig,
                  capacity: int):
    """Top-k assignment of each group's tokens, in index form.

    router_logits: (G, g, E) float32 →
      expert (G, g, k) int64 — the expert of each pick, best first;
      slot   (G, g, k) int64 — its slot in that expert (>= capacity when
                               dropped);
      weight (G, g, k) f32   — the normalised gate, 0 where dropped;
      aux    (G,)      f32   — each group's Switch load-balance loss.
    """
    c = config
    E, k = router_logits.shape[-1], c.experts_per_token
    probs = torch.softmax(router_logits, dim=-1)
    # lax.top_k's order: largest first, the lower expert first on a tie
    # (torch.topk promises no order among ties)
    expert = torch.sort(probs, dim=-1, descending=True,
                        stable=True).indices[..., :k]
    gate = probs.gather(-1, expert)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # slots: first-come over the group's tokens, all of pick j's before
    # any of pick j+1's (the reference's ``filled`` carried across j)
    mask = F.one_hot(expert, E)                          # (G, g, k, E)
    taken = mask.sum(dim=1).clamp(max=capacity)         # (G, k, E)
    filled = taken.cumsum(dim=1) - taken                 # before pick j
    pos = mask.cumsum(dim=1) - mask + filled[:, None]
    slot = pos.gather(-1, expert[..., None])[..., 0]     # (G, g, k)
    weight = gate * (slot < capacity)

    # Switch aux: E * sum_e fraction_routed(e) * mean_prob(e), per group
    fraction = mask[:, :, 0].float().mean(dim=1)         # top-1 picks
    aux = E * (fraction * probs.mean(dim=1)).sum(dim=-1)
    return expert, slot, weight, aux


def route_tokens(router_logits: torch.Tensor, config: MoEConfig,
                 capacity: int):
    """The reference's dense form of one group's routing, built from
    ``route_indices``: router_logits (N, E) float32 → combine (N, E, C)
    float32 (the gate where token n holds slot c of expert e), dispatch
    (N, E, C) bool (combine > 0), aux () float32."""
    N, E = router_logits.shape
    expert, slot, weight, aux = route_indices(router_logits[None], config,
                                              capacity)
    flat = torch.where(weight[0] > 0, expert[0] * capacity + slot[0],
                       E * capacity)                      # dropped → spare
    combine = torch.zeros((N, E * capacity + 1), dtype=torch.float32,
                          device=router_logits.device)
    combine.scatter_(1, flat, weight[0])
    combine = combine[:, :-1].reshape(N, E, capacity)
    return combine, combine > 0.0, aux[0]


def _gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table (G, R, D), index (G, ...) into R → (G, ..., D)."""
    G, R, D = table.shape
    offset = (torch.arange(G, device=index.device) * R).reshape(
        (G,) + (1,) * (index.dim() - 1))
    flat = (index + offset).reshape(-1)
    rows = table.reshape(G * R, D).index_select(0, flat)
    return rows.reshape(index.shape + (D,))


def moe_mlp_block(x: torch.Tensor, layer: dict, config: MoEConfig):
    """Sparse MLP: group → route → gather into expert slots → per-expert
    gated FFN → gate-weighted gather back. Returns (x + out, aux).

    Tokens split into G groups of g <= route_group_size in (batch, seq)
    order, each routed with its own capacity."""
    c = config
    h = rms_norm(x, layer["mlp_norm"])
    B, S, D = h.shape
    N = B * S
    groups = num_route_groups(N, c.route_group_size)
    g = N // groups
    hg = h.reshape(groups, g, D)
    router_logits = torch.matmul(hg.float(),
                                 wcast(layer["router"], torch.float32))
    C = expert_capacity(g, c)
    E, k = c.n_experts, c.experts_per_token
    expert, slot, weight, aux = route_indices(router_logits, c, C)
    aux = aux.mean()  # per-group losses → scalar

    dt = h.dtype
    # the slot a (token, pick) holds, or the spare row E*C: a zero row in
    # the dispatch gather, and a zero output in the combine gather. A
    # dispatched slot is one whose combine weight is > 0, as the
    # reference's ``dispatch = combine > 0``
    held = weight > 0
    flat = torch.where(held, expert * C + slot, E * C)   # (G, g, k)
    tokens = torch.arange(g, device=h.device).reshape(1, g, 1)
    slot_token = torch.full((groups, E * C + 1), g, dtype=torch.long,
                            device=h.device)
    slot_token.scatter_(1, flat.reshape(groups, g * k),
                        tokens.expand(groups, g, k).reshape(groups, g * k))
    hg_pad = torch.cat([hg, hg.new_zeros(groups, 1, D)], dim=1)
    expert_in = _gather_rows(hg_pad, slot_token[:, :E * C]).reshape(
        groups, E, C, D)

    gate = torch.einsum("gecd,edf->gecf", expert_in,
                        wcast(layer["w_gate"], dt))
    up = torch.einsum("gecd,edf->gecf", expert_in, wcast(layer["w_up"], dt))
    expert_out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                              wcast(layer["w_down"], dt))

    out_pad = torch.cat([expert_out.reshape(groups, E * C, D),
                         expert_out.new_zeros(groups, 1, D)], dim=1)
    picked = _gather_rows(out_pad, flat)                 # (G, g, k, D)
    # the reference's ``combine.astype(dt)``: gates rounded to the compute
    # dtype before they scale the expert outputs; the k products summed
    # in f32, in pick order, and rounded once
    w = weight.to(dt).float()
    out = picked[:, :, 0].float() * w[:, :, 0, None]
    for j in range(1, k):
        out = out + picked[:, :, j].float() * w[:, :, j, None]
    return x + out.to(dt).reshape(B, S, D), aux


def moe_forward_hidden(params: dict, tokens: torch.Tensor, config: MoEConfig,
                       positions: torch.Tensor | None = None):
    """tokens (batch, seq) → (final-norm hidden (b, s, d), aux scalar, the
    mean of the layers' aux losses)."""
    c = config
    x = params["embed"].to(c.compute_dtype)[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions[None, :].expand(tokens.shape)
    cos, sin = rope_frequencies(c, positions)
    # remat="mlp" checkpoints only the expert FFN; the layer policies
    # (True, "attn") as in the dense model
    mlp = resolve_remat_mlp(c, moe_mlp_block)
    body = resolve_layer_remat(
        c, lambda x, layer: attention_block(x, layer, c, cos, sin),
        lambda x, layer: mlp(x, layer, c))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in unstack_layers(params["blocks"]):
        x, layer_aux = body(x, layer)
        aux = aux + layer_aux
    return rms_norm(x, params["final_norm"]), aux / c.n_layers


def moe_forward(params: dict, tokens: torch.Tensor, config: MoEConfig,
                positions: torch.Tensor | None = None):
    """tokens (batch, seq) → (logits (b, s, vocab) f32, aux scalar)."""
    x, aux = moe_forward_hidden(params, tokens, config, positions=positions)
    return lm_head_logits(x, params["lm_head"]), aux


# ----------------------------------------------------------------- training
def moe_loss_fn(params, tokens, targets, config: MoEConfig,
                ce_chunk_tokens: int = 0):
    """Next-token CE + router_aux_coef x the load-balance aux.
    ``ce_chunk_tokens`` > 0 takes the chunked CE (models/train.py
    ``chunked_softmax_ce``), so the (b, s, vocab) logits never
    materialise."""
    from .train import chunked_softmax_ce, token_ce
    x, aux = moe_forward_hidden(params, tokens, config)
    if ce_chunk_tokens:
        ce = chunked_softmax_ce(x, params["lm_head"], targets,
                                ce_chunk_tokens)
    else:
        ce = token_ce(lm_head_logits(x, params["lm_head"]), targets)
    return ce + config.router_aux_coef * aux


def make_moe_train_step(config: MoEConfig, tc=None, device="cuda",
                        accum_steps: int = 1):
    """The one-device counterpart of ``make_sharded_moe_train_step``:
    ``(init_fn(generator), step_fn(params, opt_state, tokens, targets))``
    through ``train_step`` with ``build_loss``'s MoE loss (aux included).

    As in the reference, the MoE step keeps no f32 master copies: params
    train in their ``param_dtype`` (f32) whatever ``tc.bf16_params`` says,
    and the forward casts them to the compute dtype."""
    from .train import (TrainConfig, build_loss, make_optimizer, tree_map,
                        train_step)
    tc = tc or TrainConfig()
    dev = resolve_device(device)
    optimizer = make_optimizer(tc)

    def init_fn(generator: torch.Generator):
        params = tree_map(lambda p: p.requires_grad_(),
                          init_moe_params(generator, config, dev))
        return params, optimizer.init(params)

    return init_fn, functools.partial(
        train_step, loss=build_loss(config, tc), optimizer=optimizer,
        accum_steps=accum_steps)


def count_active_params(config: MoEConfig) -> float:
    """Per-token active parameter count (k of E experts)."""
    c = config
    attn = c.n_layers * (c.d_model * c.n_heads * c.d_head * 2
                         + c.d_model * c.n_kv_heads * c.d_head * 2)
    mlp_active = c.n_layers * c.experts_per_token * 3 * c.d_model * c.d_ff
    embed = 2 * c.vocab_size * c.d_model
    return attn + mlp_active + embed
