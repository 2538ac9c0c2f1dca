"""Training step: loss, optimizer and the update, on one device or a mesh.

Port of ``kubeflow_tpu/models/train.py``. The reference jits forward,
backward and optimizer into one XLA program; the step here runs eagerly:
the forward and autograd's backward go through the hand-written
flash-attention kernels on the card, and the optimizer is a few
``torch._foreach_*`` passes over the parameter leaves.

``make_sharded_train_step`` is the step on a mesh, SPMD: every rank runs
it on its own shards and batch slice (the model's collectives are in
models/transformer.py); the loss is the global token mean, the grads of
a weight replicated over a data axis are summed over it, and the clip
norm counts each element once. With pp > 1 the layer stack shards over
pp (``pipeline_rules``) and the forward pipelines
(``pipelined_forward_adapter``); every pp rank computes the LM head and
the loss on the last stage's broadcast output, so no grad is summed over
pp.

Params are the port's stacked dict tree (models/transformer.py). Gradients
come from ``torch.autograd.grad`` over its leaves, so nothing accumulates
in ``.grad``. The optimizer updates the moments, and ``apply_update`` the
params (or the f32 masters), in place: the reference returns new trees,
the port saves one copy of each.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..parallel import comm
from ..parallel.sharding import (DEFAULT_RULES, PartitionRules,
                                 sharded_axes, shard_tensor)
from .transformer import (TransformerConfig, check_mesh, forward,
                          forward_hidden, init_params, lm_head_logits,
                          lm_head_weight, param_specs,
                          pipelined_forward_hidden)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # bf16 model params with f32 master copies in the optimizer state: the
    # forward and backward read and write half the weight and gradient
    # bytes, the update accumulates in f32 on the masters
    bf16_params: bool = False
    # fused cross-entropy: the LM-head logits and their logsumexp per
    # sequence chunk of this many tokens, so the (b, s, vocab) f32 logits
    # never materialise; engaged only above CE_FUSE_THRESHOLD_BYTES of
    # logits; 0 disables it
    ce_chunk_tokens: int = 512
    # kept for config parity with the reference, which offers optax.chain
    # and a single-pass form of the same math: the port has the one
    # implementation, fused_clip_adamw, for both values
    fused_adamw: bool = False


# Above this many bytes of f32 (b, s, vocab) logits the chunked CE engages.
# Measured with chip_smoke.py phase 7 on an NVIDIA H100 80GB HBM3 at
# 700.00 W, flagship at s1024: at b8, b32 and b64 (1.05e9, 4.19e9 and
# 8.39e9 bytes) the chunked (512) step is 5-6% slower than the
# whole-logits one and peaks 0.43, 1.93 and 3.93 GB lower (whole: 11.65,
# 35.71 and 67.79 GB). Chunking buys memory only, so it waits until the
# whole-logits step nears the card's 80 GB: b64 is the first size past
# this value.
CE_FUSE_THRESHOLD_BYTES = 8e9


# --------------------------------------------------------------- optimizer
def warmup_cosine_decay(step: int, peak: float, warmup_steps: int,
                        decay_steps: int = 10_000, init: float = 0.0,
                        end: float = 0.0) -> float:
    """optax.warmup_cosine_decay_schedule written out: linear from
    ``init`` to ``peak`` over ``warmup_steps``, then cosine decay to
    ``end`` over the remaining ``decay_steps - warmup_steps``."""
    if step < warmup_steps:
        return init + (peak - init) * step / warmup_steps
    t = min(step - warmup_steps, decay_steps - warmup_steps)
    alpha = 0.0 if peak == 0.0 else end / peak
    cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
    return peak * ((1 - alpha) * cosine + alpha)


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)`` — the shape of an optax GradientTransformation."""
    init: Callable
    update: Callable


class FusedAdamWState(NamedTuple):
    """Step count (a host int) and the first/second moments, trees shaped
    like the params."""
    count: int
    mu: dict
    nu: dict


class MasterOptState(NamedTuple):
    """bf16-params training: the inner optimizer state + f32 masters."""
    inner: object
    master: dict


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level (JAX's
    order), so trees built in any key order line up leaf by leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``.
    A module-level recursion, not a closure: a recursive closure is a
    reference cycle that would keep the leaves alive until the cyclic
    garbage collector runs."""
    return _build(like, iter(leaves))


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def global_norm(leaves: list[torch.Tensor], mesh=None,
                shard_axes: list | None = None) -> torch.Tensor:
    """‖leaves‖ over every element of the full tensors. On a mesh each
    leaf is a rank's slice, sharded over ``shard_axes[i]``: the squares
    of the slices are summed over the axes a leaf is sharded on and never
    over those it is replicated on, so each element counts once."""
    live = [tuple(a for a in axes if comm.axis_size(mesh, a) > 1)
            for axes in (shard_axes or [()] * len(leaves))]
    norms = torch._foreach_norm(leaves)
    if not any(live):
        return torch.linalg.vector_norm(torch.stack(norms))
    groups: dict[tuple, list] = {}
    for n, axes in zip(norms, live):
        groups.setdefault(tuple(sorted(axes)), []).append(n)
    total = 0
    for axes, ns in groups.items():
        sq = torch.stack(ns).float().square().sum()
        total = total + comm.all_reduce_(sq, mesh, axes)
    return torch.sqrt(total)


def fused_clip_adamw(schedule: Callable[[int], float], *, b1: float,
                     b2: float, weight_decay: float, grad_clip: float,
                     eps: float = 1e-8, mesh=None,
                     shard_axes: list | None = None) -> Optimizer:
    """clip_by_global_norm + adamw in one pass per leaf, the reference's
    per-leaf body (models/train.py:109-137): clip scale
    ``min(1, clip / max(‖g‖, 1e-16))``; lr from the pre-increment count,
    bias correction from the post-increment count. The global norm and
    the clip scale stay on the device (no host sync); ``update`` consumes
    ``state`` (its moments are updated in place) and returns the update
    tree, which ``apply_update`` adds to the params. On a mesh the leaves
    are the rank's slices (``shard_axes`` as in ``global_norm``)."""

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32)
                 for p in tree_leaves(params)]
        return FusedAdamWState(
            count=0, mu=tree_unflatten(params, zeros),
            nu=tree_unflatten(params, [torch.zeros_like(z) for z in zeros]))

    @torch.no_grad()
    def update(grads, state, params):
        if params is None:
            raise ValueError("fused_clip_adamw requires params "
                             "(weight decay)")
        g = tree_leaves(grads)
        mu, nu, p = (tree_leaves(t) for t in (state.mu, state.nu, params))
        gnorm = global_norm(g, mesh, shard_axes)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-16),
                            max=1.0)
        count = state.count + 1
        lr = schedule(state.count)
        c1 = 1.0 / (1.0 - b1 ** count)
        c2 = 1.0 / (1.0 - b2 ** count)
        g = torch._foreach_mul(g, scale)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - b2))
        denom = torch._foreach_mul(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(upd, -lr)
        return tree_unflatten(grads, upd), FusedAdamWState(
            count=count, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


def make_optimizer(tc: TrainConfig, mesh=None,
                   shard_axes: list | None = None) -> Optimizer:
    """The schedule ``warmup_cosine_decay_schedule(0, lr, warmup,
    10_000)`` and clip+AdamW, for either value of ``fused_adamw``; on a
    mesh, over the rank's slices (see ``global_norm``)."""
    def schedule(step: int) -> float:
        return warmup_cosine_decay(step, tc.learning_rate, tc.warmup_steps,
                                   10_000)
    return fused_clip_adamw(schedule, b1=tc.b1, b2=tc.b2,
                            weight_decay=tc.weight_decay,
                            grad_clip=tc.grad_clip, mesh=mesh,
                            shard_axes=shard_axes)


@torch.no_grad()
def apply_update(optimizer: Optimizer, params: dict, opt_state, grads):
    """The shared optimizer tail, in place. A ``MasterOptState`` means
    bf16 params + f32 masters: the update lands on the masters and the
    params become their rounded copies."""
    if isinstance(opt_state, MasterOptState):
        grads32 = tree_map(lambda g: g.float(), grads)
        updates, inner = optimizer.update(grads32, opt_state.inner,
                                          opt_state.master)
        master = tree_leaves(opt_state.master)
        torch._foreach_add_(master, tree_leaves(updates))
        for p, m in zip(tree_leaves(params), master):
            p.copy_(m)
        return params, MasterOptState(inner=inner, master=opt_state.master)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    torch._foreach_add_(tree_leaves(params), tree_leaves(updates))
    return params, opt_state


# -------------------------------------------------------------------- loss
def _token_nll(logits: torch.Tensor, targets: torch.Tensor):
    """Per-token negative log-likelihood of f32 logits by log_softmax, 0
    at -1 targets, and the valid mask (the whole-logits path)."""
    valid = targets >= 0
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0), valid


def _nll(logits: torch.Tensor, targets: torch.Tensor):
    """Per-token negative log-likelihood of f32 logits by logsumexp, 0 at
    -1 targets, and the valid mask (the chunked path)."""
    valid = targets >= 0
    safe = torch.where(valid, targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - target_logit, 0.0), valid


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, mesh):
    """``_nll`` of logits whose vocab is sharded over tp (the rank's
    slice): the max, the sum of exponentials and the target's logit are
    each combined over tp, and no rank holds the whole (b, s, vocab)
    logits. The max is a constant of the logsumexp's gradient."""
    valid = targets >= 0
    rows = logits.shape[-1]
    local = targets.long() - comm.axis_rank(mesh, "tp") * rows
    inside = valid & (local >= 0) & (local < rows)
    m = comm.all_reduce_(logits.detach().amax(dim=-1), mesh, "tp", "max")
    sumexp = comm.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                              mesh, "tp")
    target_logit = logits.gather(-1, local.clamp(0, rows - 1)[..., None])
    target_logit = comm.reduce_from(
        torch.where(inside, target_logit[..., 0], 0.0), mesh, "tp")
    nll = torch.log(sumexp) + m - target_logit
    return torch.where(valid, nll, 0.0), valid


def token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy of f32 logits, mean over non-padding (-1 targets)."""
    nll, valid = _token_nll(logits, targets)
    return nll.sum() / valid.sum().clamp_min(1)


def data_axes(rules: PartitionRules | None = None) -> tuple[str, ...]:
    """The mesh axes the batch is sharded over: (dp, fsdp) and sp."""
    return tuple(sorted(sharded_axes((rules or PartitionRules()).spec(
        "batch", "seq"))))


def _global_count(valid: torch.Tensor, mesh, rules) -> torch.Tensor:
    """The valid tokens of the whole batch (every data shard's)."""
    return comm.all_reduce_(valid.sum(), mesh, data_axes(rules))


def hidden_ce(params, x, targets, config: TransformerConfig, mesh=None,
              rules: PartitionRules | None = None,
              chunk_tokens: int = 0) -> torch.Tensor:
    """The LM head and the cross entropy on final-norm hidden states
    ``x``, mean over non-padding (-1 targets); the chunked CE with
    ``chunk_tokens`` > 0. On a mesh: this rank's share of the global
    token mean (its tokens' nll over every rank's valid count), the
    whole-vocab CE computed vocab-parallel under tp; the shares sum to
    the global mean."""
    if mesh is None:
        if chunk_tokens:
            return chunked_softmax_ce(x, params["lm_head"], targets,
                                      chunk_tokens)
        return token_ce(lm_head_logits(x, params["lm_head"]), targets)
    x = comm.copy_to(x, mesh, "tp")
    head = lm_head_weight(params, config, mesh, rules)
    if chunk_tokens:
        return chunked_softmax_ce(x, head, targets, chunk_tokens, mesh, rules)
    logits = lm_head_logits(x, head)
    if comm.axis_size(mesh, "tp") > 1:
        nll, valid = _vocab_parallel_nll(logits, targets, mesh)
    else:
        nll, valid = _token_nll(logits, targets)
    return nll.sum() / _global_count(valid, mesh, rules).clamp_min(1)


def loss_fn(params, tokens, targets, config: TransformerConfig, mesh=None,
            rules: PartitionRules | None = None, hidden_impl=None):
    """Next-token cross entropy, mean over non-padding (-1 targets); on a
    mesh the rank's share of the global mean (``hidden_ce``).
    ``hidden_impl`` swaps ``forward_hidden`` (the pipelined stack on a pp
    mesh)."""
    if mesh is None:
        return token_ce(forward(params, tokens, config), targets)
    x = (hidden_impl or forward_hidden)(params, tokens, config, mesh=mesh,
                                        rules=rules)
    return hidden_ce(params, x, targets, config, mesh, rules)


def ce_chunk_for(tc: TrainConfig, tokens: torch.Tensor,
                 vocab_size: int) -> int:
    """The fused-CE engagement policy: chunk size to use (0 = the
    whole-logits path), from the f32 logits size against
    CE_FUSE_THRESHOLD_BYTES."""
    logits_bytes = tokens.shape[0] * tokens.shape[1] * vocab_size * 4
    if tc.ce_chunk_tokens and logits_bytes > CE_FUSE_THRESHOLD_BYTES:
        return tc.ce_chunk_tokens
    return 0


def _ce_chunks(seq_len: int, chunk_tokens: int) -> int:
    """Chunk count dividing seq_len with chunks <= chunk_tokens."""
    n = max(1, -(-seq_len // max(chunk_tokens, 1)))
    while seq_len % n:
        n += 1
    return n


def _chunk_nll(xs, lm_head, ts, mesh=None):
    logits = lm_head_logits(xs, lm_head)
    if comm.axis_size(mesh, "tp") > 1:
        nll, valid = _vocab_parallel_nll(logits, ts, mesh)
    else:
        nll, valid = _nll(logits, ts)
    return nll.sum(), valid.sum()


def chunked_softmax_ce(x: torch.Tensor, lm_head, targets: torch.Tensor,
                       chunk_tokens: int, mesh=None,
                       rules: PartitionRules | None = None) -> torch.Tensor:
    """Cross entropy fused with the LM-head projection, chunked over the
    sequence: each chunk projects a (b, chunk, d) slice onto the vocab,
    reduces it to logsumexp and target logit, and drops its logits. The
    chunk body runs under ``torch.utils.checkpoint``, so the backward
    recomputes the chunk's projection instead of keeping its logits.

    The chunk's logits come from ``lm_head_logits``, the whole-logits
    path's projection (in bf16 the product is rounded to bf16 before the
    f32 cast); the reference's chunk asks XLA for an f32 product
    instead. In f32 the two are the same. On a mesh, as ``loss_fn``: the
    rank's share of the global mean, vocab-parallel under tp (``x`` then
    the tp-replicated hidden states, ``lm_head`` the rank's slice)."""
    b, s, _ = x.shape
    n = _ce_chunks(s, chunk_tokens)
    c = s // n
    total = count = 0
    for i in range(n):
        nll, n_valid = checkpoint(_chunk_nll, x[:, i * c:(i + 1) * c],
                                  lm_head, targets[:, i * c:(i + 1) * c],
                                  mesh, use_reentrant=False)
        total = total + nll
        count = count + n_valid
    if mesh is not None:
        count = comm.all_reduce_(count, mesh, data_axes(rules))
    return total / count.clamp_min(1)


def fused_loss_fn(params, tokens, targets, config: TransformerConfig,
                  chunk_tokens: int = 512, mesh=None,
                  rules: PartitionRules | None = None):
    """loss_fn through chunked_softmax_ce."""
    x = forward_hidden(params, tokens, config, mesh=mesh, rules=rules)
    return hidden_ce(params, x, targets, config, mesh, rules, chunk_tokens)


def pipeline_rules() -> PartitionRules:
    """Partition rules for pipeline configs: the stacked layer axis shards
    over pp (contiguous layer blocks per stage)."""
    return PartitionRules(rules=tuple(
        ("layers", "pp") if k == "layers" else (k, v)
        for k, v in DEFAULT_RULES))


def pipelined_forward_adapter(params, tokens, config, mesh=None,
                              rules: PartitionRules | None = None, *,
                              n_microbatches: int):
    """``forward_hidden``'s signature over the pipelined stack: what
    ``loss_fn`` runs on a pp mesh (the port's loss takes hidden states,
    for the vocab-parallel CE)."""
    return pipelined_forward_hidden(params, tokens, config, mesh,
                                    n_microbatches, rules)


def build_loss(config: TransformerConfig, tc: TrainConfig | None = None,
               include_aux: bool = True, mesh=None,
               rules: PartitionRules | None = None,
               n_microbatches: int | None = None):
    """The loss dispatch — pp-aware forward selection and the fused-CE
    gate in one place, shared by the train steps and evaluation. Returns
    ``loss(params, tokens, targets)`` (on a mesh: the rank's share of the
    global mean, see ``loss_fn``). With pp > 1 the forward pipelines over
    ``n_microbatches`` (default 2·pp) and the dense fused CE is off, as
    in the reference. An ``MoEConfig`` takes ``moe_loss_fn``;
    ``include_aux=False`` (evaluation) leaves its router aux out, so
    exp(loss) is a perplexity."""
    from .moe import MoEConfig, moe_loss_fn, pipelined_moe_forward_hidden
    tc = tc or TrainConfig()
    pp = comm.axis_size(mesh, "pp")
    n_micro = n_microbatches or 2 * pp

    if isinstance(config, MoEConfig):
        loss_config = config if include_aux else \
            config.replace(router_aux_coef=0.0)
        hidden_impl = None if pp == 1 else functools.partial(
            pipelined_moe_forward_hidden, n_microbatches=n_micro)

        def _moe_loss(params, tokens, targets):
            chunk = ce_chunk_for(tc, tokens, loss_config.vocab_size)
            return moe_loss_fn(params, tokens, targets, loss_config,
                               ce_chunk_tokens=chunk, mesh=mesh, rules=rules,
                               hidden_impl=hidden_impl)
        return _moe_loss

    hidden = functools.partial(pipelined_forward_adapter,
                               n_microbatches=n_micro) if pp > 1 else None

    def _loss(params, tokens, targets):
        chunk = ce_chunk_for(tc, tokens, config.vocab_size) \
            if pp == 1 else 0
        if chunk:
            return fused_loss_fn(params, tokens, targets, config,
                                 chunk_tokens=chunk, mesh=mesh, rules=rules)
        return loss_fn(params, tokens, targets, config, mesh, rules,
                       hidden_impl=hidden)
    return _loss


def build_eval_loss(config: TransformerConfig,
                    tc: TrainConfig | None = None, mesh=None,
                    rules: PartitionRules | None = None,
                    n_microbatches: int | None = None):
    """What evaluation runs: build_loss with the MoE router aux left
    out."""
    return build_loss(config, tc, include_aux=False, mesh=mesh, rules=rules,
                      n_microbatches=n_microbatches)


# -------------------------------------------------------------------- step
def value_and_grad(loss, params: dict, tokens, targets):
    """(loss, grads tree) of ``loss(params, tokens, targets)`` with
    respect to every param leaf; the loss is detached."""
    with torch.enable_grad():
        value = loss(params, tokens, targets)
        grads = torch.autograd.grad(value, tree_leaves(params))
    return value.detach(), tree_unflatten(params, grads)


def accumulated_value_and_grad(loss, params: dict, tokens, targets):
    """Gradient accumulation over the microbatches on tokens/targets'
    leading axis, one microbatch's activations alive at a time. Loss and
    grads are microbatch means averaged over the actual leading-axis
    length."""
    loss_sum, grads_sum = None, None
    for t, tg in zip(tokens, targets):
        value, grads = value_and_grad(loss, params, t, tg)
        if grads_sum is None:
            loss_sum, grads_sum = value, tree_leaves(grads)
        else:
            loss_sum = loss_sum + value
            torch._foreach_add_(grads_sum, tree_leaves(grads))
    inv = 1.0 / tokens.shape[0]
    return loss_sum * inv, tree_unflatten(
        params, torch._foreach_mul(grads_sum, inv))


def train_step(params, opt_state, tokens, targets, *, loss,
               optimizer: Optimizer, accum_steps: int = 1):
    """One step: the grads of ``loss(params, tokens, targets)`` (with
    ``accum_steps`` > 1, accumulated over the leading axis of
    tokens/targets), then ``apply_update``. Returns (params, opt_state,
    loss). ``make_train_step`` runs it with ``build_loss``'s loss."""
    if accum_steps == 1:
        value, grads = value_and_grad(loss, params, tokens, targets)
    else:
        value, grads = accumulated_value_and_grad(loss, params, tokens,
                                                  targets)
    params, opt_state = apply_update(optimizer, params, opt_state, grads)
    return params, opt_state, value


def init_train_state(params: dict, tc: TrainConfig):
    """(params, opt_state) to train from ``params``: the leaves become
    trainable; with ``bf16_params`` they are bf16 copies and the state is
    a ``MasterOptState`` over f32 masters."""
    optimizer = make_optimizer(tc)
    if tc.bf16_params:
        master = tree_map(lambda p: p.detach().float().clone(), params)
        params = tree_map(lambda p: p.detach().to(torch.bfloat16)
                          .requires_grad_(), master)
        return params, MasterOptState(inner=optimizer.init(master),
                                      master=master)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    return params, optimizer.init(params)


def make_train_step(config: TransformerConfig, tc: TrainConfig | None = None,
                    device="cuda", accum_steps: int = 1):
    """The one-device counterpart of ``make_sharded_train_step``:
    ``(init_fn(generator), step_fn(params, opt_state, tokens, targets))``.

    - ``init_fn`` draws params from ``generator`` onto ``device`` and
      returns ``init_train_state``'s (params, opt_state);
    - ``step_fn`` returns (params, opt_state, loss), updated in place, the
      loss a 0-d tensor on the device (reading it syncs the host);
    - with ``accum_steps`` > 1 it takes (accum, batch, seq) tokens/targets
      and accumulates grads over the microbatches before one update.
    """
    tc = tc or TrainConfig()
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        return init_train_state(init_params(generator, config, dev), tc)

    return init_fn, functools.partial(
        train_step, loss=build_loss(config, tc),
        optimizer=make_optimizer(tc), accum_steps=accum_steps)


# ------------------------------------------------------------- sharded step
def opt_state_shardings(opt_state, p_specs: dict):
    """The spec of each leaf of an optimizer state: a leaf whose path ends
    with a param's path (``mu/blocks/wq``, ``master/blocks/wq``) takes
    that param's spec; everything else (the step count) is replicated."""
    from ..parallel.partition_rules import map_with_path
    by_path: dict[str, tuple] = {}
    map_with_path(lambda path, spec: by_path.__setitem__(path, spec),
                  p_specs)

    def spec(path, leaf):
        if isinstance(leaf, torch.Tensor):
            keys = path.split("/")
            for start in range(len(keys)):
                found = by_path.get("/".join(keys[start:]))
                if found is not None:
                    return found
        return ()
    return map_with_path(spec, opt_state)


def mesh_rules(mesh, rules: PartitionRules | None = None) -> PartitionRules:
    """``rules``, or the default for ``mesh``: ``pipeline_rules()`` when
    pp > 1, else ``DEFAULT_RULES``."""
    if rules is not None:
        return rules
    return pipeline_rules() if comm.axis_size(mesh, "pp") > 1 \
        else PartitionRules()


def grad_reduce_axes(spec_leaves, axes) -> list[tuple[str, ...]]:
    """Per leaf spec, the axes of ``axes`` its grad is summed over: those
    it is not sharded on (a shard's grad is already its own)."""
    return [tuple(a for a in axes if a not in sharded_axes(s))
            for s in spec_leaves]


def sharded_update(mesh, loss, optimizer: Optimizer, reduce_axes: list,
                   rules: PartitionRules | None = None,
                   accum_steps: int = 1):
    """The SPMD step body shared by the sharded steps: ``step(params,
    opt_state, tokens, targets, loss=loss)`` takes the grads of ``loss``
    (accumulated over the leading axis with ``accum_steps`` > 1), sums
    each leaf's over its ``reduce_axes``, the loss over the data axes,
    and applies the update in place."""
    batch_axes = data_axes(rules)

    def step(params, opt_state, tokens, targets, loss=loss):
        if accum_steps == 1:
            value, grads = value_and_grad(loss, params, tokens, targets)
        else:
            value, grads = accumulated_value_and_grad(loss, params, tokens,
                                                      targets)
        for g, axes in zip(tree_leaves(grads), reduce_axes):
            comm.all_reduce_(g, mesh, axes)
        comm.all_reduce_(value, mesh, batch_axes)
        params, opt_state = apply_update(optimizer, params, opt_state, grads)
        return params, opt_state, value
    return step


def make_sharded_train_step(mesh, config: TransformerConfig,
                            tc: TrainConfig | None = None,
                            rules: PartitionRules | None = None,
                            accum_steps: int = 1,
                            n_microbatches: int | None = None):
    """``(init_fn, step_fn)`` on ``mesh``, run by every rank (SPMD).

    - ``init_fn(generator)`` draws the full params from ``generator``
      (seeded alike on every rank) and keeps this rank's shards under
      ``rules`` (default ``DEFAULT_RULES``; ``pipeline_rules()`` when
      pp > 1); moments and bf16 masters are sharded like the params they
      shadow;
    - ``step_fn(params, opt_state, tokens, targets)`` takes this rank's
      batch slice (rows over (dp, fsdp), sequence block over sp:
      ``runtime.data.shard_batch``, laid out for ``n_microbatches`` on a
      pp mesh; with ``accum_steps`` > 1 an (accum, batch, seq) slice)
      and returns (params, opt_state, loss), updated in place, the loss
      the global token mean on every rank.

    fsdp gathers each layer's weights before use and reduce-scatters
    their grads; a grad replicated over a data axis (dp, fsdp, sp) is
    summed over it; the clip norm counts each element once. With pp > 1
    the forward pipelines over ``n_microbatches`` (default 2·pp). An
    ``MoEConfig`` takes ``make_sharded_moe_train_step``. On a mesh of one
    rank it is ``make_train_step``'s step, op for op."""
    tc = tc or TrainConfig()
    rules = mesh_rules(mesh, rules)
    from .moe import MoEConfig, make_sharded_moe_train_step
    if isinstance(config, MoEConfig):
        return make_sharded_moe_train_step(mesh, config, tc, rules,
                                           accum_steps, n_microbatches)
    check_mesh(config, mesh, rules)
    leaf_specs = tree_leaves(param_specs(config, rules))
    optimizer = make_optimizer(
        tc, mesh, [tuple(sorted(sharded_axes(s))) for s in leaf_specs])
    loss = build_loss(config, tc, mesh=mesh, rules=rules,
                      n_microbatches=n_microbatches)
    dev = comm.mesh_device(mesh)

    def init_fn(generator: torch.Generator):
        full = init_params(generator, config, dev)
        return init_train_state(tree_unflatten(full, [
            shard_tensor(p, s, mesh)
            for p, s in zip(tree_leaves(full), leaf_specs)]), tc)

    return init_fn, sharded_update(
        mesh, loss, optimizer, grad_reduce_axes(leaf_specs, data_axes(rules)),
        rules, accum_steps)
