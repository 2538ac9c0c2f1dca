"""Speculative decoding: a small draft model proposes, the target verifies.

Port of ``kubeflow_tpu/models/speculative.py``. A draft model proposes
``k`` tokens one ``decode_step`` at a time, then ONE target
``decode_window`` scores the whole block, so the target's weights are
read once per accepted block instead of once per token.

Two acceptance rules, chosen per row by its temperature:

- temperature 0 (greedy): accept while the draft token equals the
  target's argmax, so the output equals ``generate``'s greedy stream;
- temperature > 0 (sampled): accept draft token x with probability
  min(1, p(x)/q(x)), p and q the temperature-scaled target and draft
  distributions; on a rejection draw the replacement from
  norm(max(p - q, 0)); after a fully accepted block draw the bonus from
  p. Each emitted token is then distributed as target sampling.

``top_k``/``top_p`` warps are not supported (both distributions would
need the warp before the ratio test); ``generate`` stays the path for
them.

Where the JAX package runs one ``lax.while_loop``, ``speculative_generate``
is a host loop that reads one flag back per block (whether any row still
runs) and nothing else. Rejected cache rows are never rolled back: each
row's positions are masked by its live frontier, and the next block's
writes overwrite the stale rows in place. Sampled rows draw from an
explicit ``torch.Generator`` (another RNG than JAX's: their ids differ
from the reference's, their distribution does not).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .decode import decode_step, decode_window, prefill
from .transformer import TransformerConfig


class SpecStats(NamedTuple):
    """The acceptance dynamics. ``drafted``/``accepted`` are per-row
    (batch,) tensors, so a caller that pads the batch sums only the real
    rows; a row stops counting once it is done or has filled
    max_new_tokens (it rides the loop for the stragglers)."""
    blocks: int                # verify iterations run
    drafted: torch.Tensor      # (B,) draft tokens proposed per row
    accepted: torch.Tensor     # (B,) draft tokens accepted per row


def _scaled_probs(logits: torch.Tensor,
                  temperature: torch.Tensor) -> torch.Tensor:
    """softmax(logits / temp), temp broadcast over the trailing axes; the
    temp <= 0 guard keeps the division finite (greedy rows never read
    it)."""
    t = temperature.clamp_min(1e-6)
    while t.dim() < logits.dim():
        t = t[..., None]
    return torch.softmax(logits / t, dim=-1)


def _categorical(probs: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``probs`` (..., V): Gumbel-max over the log
    probabilities, noise from ``generator``; int32."""
    u = torch.rand(probs.shape, generator=generator,
                   device=generator.device).to(probs.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(torch.log(probs + 1e-30) + gumbel,
                        dim=-1).to(torch.int32)


def propose_and_verify(params: dict, draft_params: dict, t_cache: dict,
                       d_cache: dict, last: torch.Tensor,
                       q_pos: torch.Tensor, temp: torch.Tensor,
                       generator: torch.Generator | None,
                       config: TransformerConfig,
                       draft_config: TransformerConfig, k: int):
    """One speculative block without emit bookkeeping: k draft proposals,
    ONE target ``decode_window``, per-row acceptance and the block's
    closing token. Shared by ``speculative_generate`` and the continuous
    engine's speculative tick (runtime/serving.py). Both caches are
    updated in place; nothing is read back to the host.

    last: (B,) newest emitted token, not yet consumed, at positions q_pos
    (B,). ``generator=None`` means no row samples. Returns (t_cache,
    d_cache, drafts (B, k), n_acc (B,) int32, tail (B,) int32): a row's
    emitted block is drafts[:n_acc] then tail."""
    sampling = generator is not None
    sampled = temp > 0.0

    # k+1 draft steps consume [last, d_0 .. d_{k-1}] at q_pos .. q_pos+k.
    # The extra step exists for the cache, not the proposal: when all k
    # drafts are accepted the next block starts at q_pos+k+1, so the
    # draft cache must already hold d_{k-1}'s K/V at q_pos+k, or that row
    # would be a hole the draft attends through. Greedy rows propose the
    # draft's argmax, sampled rows draw from q.
    tok, drafts, q_probs = last, [], []
    for j in range(k + 1):
        logits, d_cache = decode_step(draft_params, d_cache, tok, q_pos + j,
                                      draft_config)
        if j == k:
            break
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if sampling:
            probs = _scaled_probs(logits, temp)
            tok = torch.where(sampled, _categorical(probs, generator), tok)
            q_probs.append(probs)
        drafts.append(tok)
    drafts = torch.stack(drafts, dim=1)                          # (B, k)

    window = torch.cat([last[:, None].to(torch.int32), drafts], dim=1)
    t_logits, t_cache = decode_window(params, t_cache, window, q_pos,
                                      config)
    greedy = torch.argmax(t_logits, dim=-1).to(torch.int32)      # (B, k+1)
    match = drafts == greedy[:, :k]
    if sampling:
        q_probs = torch.stack(q_probs, dim=1)                    # (B, k, V)
        p_probs = _scaled_probs(t_logits, temp)                  # (B, k+1, V)
        p_at_d = p_probs[:, :k].gather(-1, drafts.long()[..., None])[..., 0]
        q_at_d = q_probs.gather(-1, drafts.long()[..., None])[..., 0]
        u = torch.rand(drafts.shape, generator=generator,
                       device=generator.device).to(drafts.device)
        match = torch.where(sampled[:, None], u * q_at_d < p_at_d, match)
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)                                             # [0, k]

    # the closing token: greedy rows take the target's pick at the first
    # mismatch (or the bonus after k accepts: greedy[n_acc] covers both);
    # sampled rows redraw a rejection from the residual and the bonus
    # from p_k
    tail = greedy.gather(1, n_acc.long()[:, None])[:, 0]
    if sampling:
        r = n_acc.clamp(max=k - 1).long()[:, None, None].expand(
            -1, 1, p_probs.shape[-1])
        p_r = p_probs.gather(1, r)[:, 0]
        q_r = q_probs.gather(1, r)[:, 0]
        resid = (p_r - q_r).clamp_min(0.0)
        mass = resid.sum(dim=-1, keepdim=True)
        # p == q leaves no residual; a rejection then cannot happen (its
        # accept probability was 1), but the draw must stay finite
        resid = torch.where(mass > 1e-12, resid / mass, p_r)
        tail_sampled = torch.where(n_acc == k,
                                   _categorical(p_probs[:, k], generator),
                                   _categorical(resid, generator))
        tail = torch.where(sampled, tail_sampled, tail)
    return t_cache, d_cache, drafts, n_acc, tail


def emit_block(out: torch.Tensor, n_out: torch.Tensor, last: torch.Tensor,
               done: torch.Tensor, drafts: torch.Tensor, n_acc: torch.Tensor,
               tail: torch.Tensor, alive: torch.Tensor, target,
               eos_id: int | None = None):
    """Write one verified block into the emit buffer, in place. Each
    ``alive`` row emits its accepted drafts then ``tail`` at its cursor
    ``n_out``, clamped to ``target - n_out`` (an int or a (B,) tensor)
    and cut after its first EOS, which sets ``done``; ``last`` takes the
    row's newest emitted token and ``n_out`` advances. Shared by
    ``speculative_generate`` and the continuous engine's tick.

    The masked cells of a row's k+1-wide window rewrite their own value
    (JAX's scatter drops them; torch would raise past the buffer), so
    ``out`` needs k+1 columns beyond the largest target. Returns (emit
    (B, k+1), emit_len (B,))."""
    k = drafts.shape[1]
    j = torch.arange(k + 1, dtype=torch.int32, device=drafts.device)[None, :]
    rows = torch.arange(drafts.shape[0], device=drafts.device)[:, None]
    emit = torch.where(j < n_acc[:, None],
                       torch.nn.functional.pad(drafts, (0, 1)),
                       tail[:, None])
    emit_len = torch.where(alive, torch.minimum(n_acc + 1, target - n_out),
                           0).to(torch.int32)
    if eos_id is not None:
        # the block ends at its first EOS: nothing after it is written or
        # streamed (the buffer's later cells keep their padding)
        is_eos = (emit == eos_id) & (j < emit_len[:, None])
        any_eos = is_eos.any(dim=1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(
            torch.int32)
        emit_len = torch.where(any_eos, torch.minimum(emit_len, first_eos + 1),
                               emit_len)
        done |= any_eos
    idx = n_out[:, None].long() + j
    out[rows, idx] = torch.where(j < emit_len[:, None], emit, out[rows, idx])
    last.copy_(torch.where(emit_len > 0, emit.gather(
        1, (emit_len - 1).clamp_min(0).long()[:, None])[:, 0], last))
    n_out += emit_len
    return emit, emit_len


def speculative_generate(params: dict, draft_params: dict,
                         prompt: torch.Tensor, config: TransformerConfig,
                         draft_config: TransformerConfig,
                         max_new_tokens: int, k: int = 4, temperature=0.0,
                         generator: torch.Generator | None = None,
                         eos_id: int | None = None, pad_id: int = 0,
                         kv_quant: bool = False):
    """Speculative decode: ((batch, max_new_tokens) int32 ids, SpecStats).

    ``temperature`` is a scalar or a per-row sequence: 0 for greedy rows
    (``generate``'s greedy ids) and > 0 for sampled rows (target-sampling
    distribution), mixed in one batch. ``kv_quant``: an int8 TARGET cache
    with per-position scales, equal to ``generate(kv_quant=True)``'s (the
    verify window quantizes its writes as decode_step does); the draft
    cache stays full precision. EOS: positions after a row's first EOS
    hold ``pad_id``, as in ``generate``. Requires ``prompt_len +
    max_new_tokens + k <= max_seq_len`` of BOTH configs (the verify window
    may overhang the last emitted position by up to ``k`` rejected
    rows)."""
    tc, dc = config, draft_config
    B, P = prompt.shape
    limit = min(tc.max_seq_len, dc.max_seq_len)
    if P + max_new_tokens + k > limit:
        raise ValueError(
            f"prompt_len {P} + max_new_tokens {max_new_tokens} + k {k} "
            f"exceeds max_seq_len {limit}")
    if k < 1:
        raise ValueError("k must be >= 1")
    dev = prompt.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).expand(B)
    sampling = bool((temps > 0).any())
    temps = temps.to(dev)
    sampled = temps > 0.0
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    gen = generator if sampling else None

    t_logits, t_cache = prefill(params, prompt, tc, kv_quant=kv_quant)
    _, d_cache = prefill(draft_params, prompt, dc)

    # the first token comes from the target's prefill logits
    first = torch.argmax(t_logits, dim=-1).to(torch.int32)
    if sampling:
        first = torch.where(
            sampled, _categorical(_scaled_probs(t_logits, temps), gen),
            first)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = first == eos_id
    # k+1 columns of overhang: a finished row's masked window still
    # indexes up to k cells past max_new_tokens; sliced back at the end
    out = torch.full((B, max_new_tokens + k + 1), pad_id,
                     dtype=torch.int32, device=dev)
    out[:, 0] = first
    last, n_out = first.clone(), torch.ones(B, dtype=torch.int32, device=dev)
    drafted = torch.zeros(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros(B, dtype=torch.int32, device=dev)
    blocks = 0
    # the one readback of a block: does any row still run
    while bool(((n_out < max_new_tokens) & ~done).any()):
        t_cache, d_cache, drafts, n_acc, tail = propose_and_verify(
            params, draft_params, t_cache, d_cache, last, P + n_out - 1,
            temps, gen, tc, dc, k)
        # a row takes part while un-done and short of max_new; full rows
        # ride along without moving their cursor or their stats
        alive = ~done & (n_out < max_new_tokens)
        emit_block(out, n_out, last, done, drafts, n_acc, tail, alive,
                   max_new_tokens, eos_id)
        drafted += torch.where(alive, k, 0).to(torch.int32)
        accepted += torch.where(alive, n_acc, 0)
        blocks += 1
    return out[:, :max_new_tokens], SpecStats(blocks, drafted, accepted)
