"""Mixture-of-Experts transformer LM: the second model family.

Port of ``kubeflow_tpu/models/moe.py``. The attention stack, norms and
RoPE are the dense model's; only the MLP is replaced by E experts with
top-k routing.

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

On a mesh (``moe_param_logical_specs`` under the partition rules) the
reference's GSPMD layout is placed by hand:

- routing groups are global, as the reference's over the global
  (batch, seq) order: each rank's f32 router logits (N_local x E) are
  all-gathered over the data axes (the sequence over sp, then the rows
  over dp and fsdp; the backward reduce-scatters), every rank routes the
  whole batch alike and keeps its own tokens' picks; each rank adds
  1/(data ranks) of the aux, so the shares sum to it once;
- ep shards experts, not tokens (the batch is not sharded over ep):
  each ep rank runs the slots of its E/ep experts, and the tokens' k
  outputs, partial over ep and over tp (``w_down`` is row-parallel), are
  summed over both by all-reduces after the combine; the FFN's input and
  the gates go in through ``copy_to`` over (tp, ep), so their grads are
  summed over both;
- the expert weights gather over fsdp in each layer; the router over
  fsdp (a data axis: its grads reduce-scatter) and over ep (replicated
  computation: each rank keeps its own columns' grad);
- an expert slot's FFN runs on the rank whose token holds it: a rank
  runs the slots of the groups its tokens touch, the other ranks'
  tokens there as zero rows, so a group spanning data ranks is computed
  on each of them.

With pp > 1, ``pipelined_moe_forward_hidden`` carries {x, aux} through
the stages of parallel/pipeline.py.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel import comm
from ..parallel.sharding import PartitionRules, spec_axes
from .quant import wcast
from .transformer import (TransformerConfig, _layer_specs, attention_block,
                          block_positions, embed_tokens, layer_weights,
                          lm_head_logits, resolve_layer_remat,
                          resolve_remat_mlp, rms_norm, rope_frequencies,
                          unstack_layers)


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
def moe_param_logical_specs(config: MoEConfig) -> dict:
    """Same attention weights as the dense model; MLP weights gain a
    leading 'experts' axis (→ ep), plus the router projection."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", "norm"),
            "router": ("layers", "embed", "experts"),
            "w_gate": ("layers", "experts", "embed", "mlp"),
            "w_up": ("layers", "experts", "embed", "mlp"),
            "w_down": ("layers", "experts", "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


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


def _batch_axes(rules) -> tuple:
    """(the mesh axes of the batch rows, those of the sequence)."""
    rows, seq = (rules or PartitionRules()).spec("batch", "seq")
    return spec_axes(rows), spec_axes(seq)


def _mlp_weights(layer: dict, config: MoEConfig, mesh, rules) -> dict:
    """The layer's MLP weights as the rank computes with them: gathered
    over fsdp (``layer_weights``), its experts and mlp slice kept, and
    the router whole (its ep columns gathered for the replicated
    routing: the backward keeps the rank's own columns' grad)."""
    if mesh is None:
        return layer
    layer = layer_weights(layer, ("mlp_norm", "router", "w_gate", "w_up",
                                  "w_down"), config, mesh, rules)
    router = layer["router"]
    for dim, entry in enumerate(_layer_specs(config, rules)["router"]):
        if "ep" in spec_axes(entry):
            router = comm.gather_replicated(router, mesh, "ep", dim)
    return {**layer, "router": router}


def moe_mlp_block(x: torch.Tensor, layer: dict, config: MoEConfig,
                  mesh=None, rules: PartitionRules | None = None, *,
                  replicated: bool = False):
    """Sparse MLP: group → route → gather into expert slots → per-expert
    gated FFN → gate-weighted gather back. Returns (x + out, aux).

    Tokens split into G groups of g <= route_group_size in (batch, seq)
    order, each routed with its own capacity. On a mesh ``x`` is the
    rank's rows and sequence block and the groups are the global batch's
    (see the module's notes). ``replicated``: ``x`` is the whole batch on
    every rank (decode), so the router logits are not gathered over the
    data axes, which would count each row once per data rank; the ep
    slots and the (tp, ep) sum are as in training."""
    c = config
    layer = _mlp_weights(layer, c, mesh, rules)
    h = rms_norm(x, layer["mlp_norm"])
    b, s, D = h.shape
    E, k = c.n_experts, c.experts_per_token
    logits = torch.matmul(h.float(), wcast(layer["router"], torch.float32))
    rows, seq = ((), ()) if replicated else _batch_axes(rules)
    full = comm.all_gather(comm.all_gather(logits, mesh, seq, 1), mesh,
                           rows, 0)
    Bg, Sg = full.shape[:2]
    N = Bg * Sg
    groups = num_route_groups(N, c.route_group_size)
    g = N // groups
    C = expert_capacity(g, c)
    expert, slot, weight, aux = route_indices(full.reshape(groups, g, E), c,
                                              C)
    aux = aux.mean()  # per-group losses → scalar

    # this rank's tokens, in its (b, s) order, as global token ids; the
    # groups they touch, [g0, g0 + Gt)
    r0, c0 = comm.axis_rank(mesh, rows) * b, comm.axis_rank(mesh, seq) * s
    g0 = (r0 * Sg + c0) // g
    Gt = ((r0 + b - 1) * Sg + c0 + s - 1) // g - g0 + 1
    n = b * s
    if n == N:
        expert, slot, weight = (t.reshape(N, k) for t in (expert, slot,
                                                           weight))
        group = torch.arange(N, device=h.device) // g
    else:
        own = ((r0 + torch.arange(b, device=h.device))[:, None] * Sg
               + c0 + torch.arange(s, device=h.device)).reshape(n)
        expert, slot, weight = (t.reshape(N, k)[own] for t in (expert, slot,
                                                                weight))
        group = own // g - g0
    # this rank's experts, [e0, e0 + El)
    El = E // comm.axis_size(mesh, "ep")
    e0 = comm.axis_rank(mesh, "ep") * El

    dt = h.dtype
    # the slot a (token, pick) holds, or the spare slot Gt*El*C: a zero row
    # in the dispatch gather, and a zero output in the combine gather. A
    # dispatched slot is one whose combine weight is > 0, as the
    # reference's ``dispatch = combine > 0``; a pick of another ep rank's
    # expert is that rank's
    held = (weight > 0) & (expert >= e0) & (expert < e0 + El)
    spare = Gt * El * C
    flat = torch.where(held, (group[:, None] * El + expert - e0) * C + slot,
                       spare)                              # (n, k)
    slot_token = torch.full((spare + 1,), n, dtype=torch.long,
                            device=h.device)
    slot_token.scatter_(0, flat.reshape(n * k), torch.arange(
        n, device=h.device).repeat_interleave(k))
    hc = comm.copy_to(h.reshape(n, D), mesh, ("tp", "ep"))
    h_pad = torch.cat([hc, hc.new_zeros(1, D)], dim=0)
    expert_in = h_pad.index_select(0, slot_token[:spare]).reshape(
        Gt, El, C, D)

    gate = torch.einsum("gecd,edf->gecf", expert_in,
                        wcast(layer["w_gate"], dt))
    up = torch.einsum("gecd,edf->gecf", expert_in, wcast(layer["w_up"], dt))
    expert_out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                              wcast(layer["w_down"], dt))

    out_pad = torch.cat([expert_out.reshape(spare, D),
                         expert_out.new_zeros(1, D)], dim=0)
    picked = out_pad.index_select(0, flat.reshape(n * k)).reshape(n, k, D)
    # the reference's ``combine.astype(dt)``: gates rounded to the compute
    # dtype before they scale the expert outputs; the k products summed
    # in f32, in pick order, summed over tp and ep, and rounded once
    w = comm.copy_to(weight, mesh, ("tp", "ep")).to(dt).float()
    out = picked[:, 0].float() * w[:, 0, None]
    for j in range(1, k):
        out = out + picked[:, j].float() * w[:, j, None]
    out = comm.reduce_from(out, mesh, ("tp", "ep"))
    return x + out.to(dt).reshape(b, s, D), aux


def _moe_layer_body(c: MoEConfig, cos, sin, mesh, rules):
    """``body(x, layer) -> (x, aux)``: attention then the sparse MLP,
    under the remat policies ("mlp" checkpoints only the expert FFN)."""
    mlp = resolve_remat_mlp(
        c, lambda x, layer, c: moe_mlp_block(x, layer, c, mesh, rules))
    return resolve_layer_remat(
        c, lambda x, layer: attention_block(x, layer, c, cos, sin,
                                            mesh=mesh, rules=rules),
        lambda x, layer: mlp(x, layer, c))


def moe_forward_hidden(params: dict, tokens: torch.Tensor, config: MoEConfig,
                       positions: torch.Tensor | None = None, mesh=None,
                       rules: PartitionRules | None = None):
    """tokens (batch, seq) → (final-norm hidden (b, s, d), aux scalar, the
    mean of the layers' aux losses). On a mesh: the rank's rows and
    sequence block, the aux the global batch's."""
    c = config
    x = embed_tokens(params, tokens, c, mesh, rules)
    if positions is None:
        positions = block_positions(tokens, mesh).expand(tokens.shape)
    cos, sin = rope_frequencies(c, positions)
    body = _moe_layer_body(c, cos, sin, mesh, rules)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in unstack_layers(params["blocks"]):
        x, layer_aux = body(x, layer)
        aux = aux + layer_aux
    return rms_norm(x, params["final_norm"]), aux / c.n_layers


def pipelined_moe_forward_hidden(params: dict, tokens: torch.Tensor,
                                 config: MoEConfig, mesh,
                                 n_microbatches: int,
                                 rules: PartitionRules | None = None):
    """MoE forward with the layer stack pipelined over ``pp``, the
    counterpart of ``transformer.pipelined_forward_hidden``. The stage
    activation is {x, aux}: the router's load-balance loss accumulates
    per microbatch as it passes the stages. Each stage routes its
    microbatch globally over the data axes, so the microbatch rows must
    be each data rank's share of a global microbatch
    (``runtime.data.shard_batch`` for ``n_microbatches``). pp x sp for
    the MoE is not supported, as in the reference."""
    from ..parallel.pipeline import pipeline_apply, split_stages

    c = config
    if comm.axis_size(mesh, "sp") > 1:
        raise NotImplementedError("MoE + pp + sp not supported; "
                                  "use pp x ep x tp (+dp/fsdp)")
    # Routing must be MICROBATCH-INVARIANT: groups and capacity follow the
    # token set a stage routes, so a microbatch whose group size differs
    # from the whole batch's would train differently on a pp mesh than
    # off it, with n_microbatches, a parallelism knob, steering the loss
    rows, _ = _batch_axes(rules)
    B, S = tokens.shape[0] * comm.axis_size(mesh, rows), tokens.shape[1]
    mb = B // n_microbatches
    g_full = (B * S) // num_route_groups(B * S, c.route_group_size)
    g_micro = (mb * S) // num_route_groups(mb * S, c.route_group_size)
    if g_full != g_micro:
        raise ValueError(
            f"pipelined MoE routing would not be microbatch-invariant: "
            f"effective group size {g_full} (full batch) vs {g_micro} "
            f"(microbatch of {mb}x{S} tokens). Pick route_group_size so "
            f"groups align within one microbatch — e.g. "
            f"route_group_size=seq_len ({S}) routes per sequence on any "
            f"mesh.")
    x = embed_tokens(params, tokens, c, mesh, rules)
    cos, sin = rope_frequencies(c, block_positions(tokens, mesh))
    body = _moe_layer_body(c, cos, sin, mesh, rules)

    def stage_fn(stage_layers, act):
        h, aux = act["x"], act["aux"]
        for layer in unstack_layers(stage_layers):
            h, layer_aux = body(h, layer)
            aux = aux + layer_aux
        return {"x": h, "aux": aux}

    act = {"x": x, "aux": torch.zeros((tokens.shape[0], 1),
                                      dtype=torch.float32, device=x.device)}
    out = pipeline_apply(split_stages(params["blocks"], 1), act, stage_fn,
                         mesh=mesh, n_microbatches=n_microbatches)
    # each microbatch's aux sum rides its rows, the same on each: the mean
    # over the rows is the mean over the microbatches
    aux = out["aux"].mean() / c.n_layers
    return rms_norm(out["x"], params["final_norm"]), aux


def moe_forward(params: dict, tokens: torch.Tensor, config: MoEConfig,
                positions: torch.Tensor | None = None):
    """tokens (batch, seq) → (logits (b, s, vocab) f32, aux scalar)."""
    x, aux = moe_forward_hidden(params, tokens, config, positions=positions)
    return lm_head_logits(x, params["lm_head"]), aux


# ----------------------------------------------------------------- training
def moe_loss_fn(params, tokens, targets, config: MoEConfig,
                ce_chunk_tokens: int = 0, mesh=None,
                rules: PartitionRules | None = None, hidden_impl=None):
    """Next-token CE + router_aux_coef x the load-balance aux.
    ``ce_chunk_tokens`` > 0 takes the chunked CE (models/train.py
    ``chunked_softmax_ce``), so the (b, s, vocab) logits never
    materialise. ``hidden_impl`` swaps ``moe_forward_hidden`` (the
    pipelined stack on a pp mesh). On a mesh: the rank's share of the
    global loss (its share of the CE's token mean, and of the aux)."""
    from .train import data_axes, hidden_ce
    x, aux = (hidden_impl or moe_forward_hidden)(params, tokens, config,
                                                 mesh=mesh, rules=rules)
    ce = hidden_ce(params, x, targets, config, mesh, rules, ce_chunk_tokens)
    shards = comm.axis_size(mesh, data_axes(rules))
    if shards > 1:
        aux = aux / shards
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


def make_sharded_moe_train_step(mesh, config: MoEConfig, tc=None,
                                rules: PartitionRules | None = None,
                                accum_steps: int = 1,
                                n_microbatches: int | None = None):
    """``(init_fn, step_fn)`` on ``mesh`` over dp/fsdp/tp/sp/ep/pp, run by
    every rank (SPMD): the MoE counterpart of
    ``train.make_sharded_train_step``, whose notes on the batch slice,
    the grads' sums and ``accum_steps`` hold here. ``init_fn`` draws the
    full params from ``generator`` and keeps the rank's shards
    (``moe_param_logical_specs`` under ``rules``: experts over ep); the
    params train in f32, as ``make_moe_train_step``'s. With pp > 1 the
    layer stack shards over pp (``pipeline_rules()`` by default) and the
    forward pipelines over ``n_microbatches`` (default 2·pp). On a mesh of
    one rank it is ``make_moe_train_step``'s step, op for op."""
    from ..parallel.sharding import sharded_axes, shard_tensor
    from .train import (TrainConfig, build_loss, data_axes,
                        grad_reduce_axes, make_optimizer, mesh_rules,
                        sharded_update, tree_leaves, tree_unflatten)
    from .transformer import check_mesh, param_specs
    tc = tc or TrainConfig()
    rules = mesh_rules(mesh, rules)
    check_mesh(config, mesh, rules)
    leaf_specs = tree_leaves(param_specs(config, rules))
    optimizer = make_optimizer(
        tc, mesh, [tuple(sorted(sharded_axes(s))) for s in leaf_specs])
    loss = build_loss(config, tc, mesh=mesh, rules=rules,
                      n_microbatches=n_microbatches)
    dev = comm.mesh_device(mesh)

    def init_fn(generator: torch.Generator):
        full = init_moe_params(generator, config, dev)
        params = tree_unflatten(full, [
            shard_tensor(p, s, mesh).requires_grad_()
            for p, s in zip(tree_leaves(full), leaf_specs)])
        return params, optimizer.init(params)

    return init_fn, sharded_update(
        mesh, loss, optimizer, grad_reduce_axes(leaf_specs, data_axes(rules)),
        rules, accum_steps)


def count_active_params(config: MoEConfig) -> float:
    """Per-token active parameter count (k of E experts)."""
    c = config
    attn = c.n_layers * (c.d_model * c.n_heads * c.d_head * 2
                         + c.d_model * c.n_kv_heads * c.d_head * 2)
    mlp_active = c.n_layers * c.experts_per_token * 3 * c.d_model * c.d_ff
    embed = 2 * c.vocab_size * c.d_model
    return attn + mlp_active + embed
