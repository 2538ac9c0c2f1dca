"""Autoregressive decoding: KV cache, prefill, single-token step, window
step, generate.

Port of ``kubeflow_tpu/models/decode.py``, for both model families: the
MLP of each layer is the dense one or the MoE one by config type
(``_mlp``). The KV cache is preallocated at
``max_seq_len`` as stacked (L, B, S, G, D) buffers; GQA caches the
un-repeated kv heads. Where the JAX package returns an updated copy of the
cache (immutable arrays), the port writes into the cache tensors in place
and returns the same dict — one cache's memory for the whole generation.
A per-row write at a position ``>= max_seq_len`` is dropped, as JAX's
scatter drops it (a chunk overhanging the cache, a finished row frozen at
``max_seq_len``), without reading any value back to the host.

Decode attention: ``decode_attention="auto"`` takes the hand-written
flash-decode kernel (ops/decode_attention.py) on CUDA at every cache
length and the einsum path on the CPU. The JAX package's TPU gate
(``max_seq_len >= 2048``) was measured on a v5e and is not carried over.
``decode_window`` (W tokens a row, the continuous engine's chunked prefill
and later speculative verification) is the einsum path, as in the JAX
package, which has no kernel for it.

``generate`` is a Python loop over decode steps that never reads a value
back to the host until the end (the JAX package's ``lax.scan``).

Tensor-parallel decode: params placed by
``runtime.sharded_decode.shard_decode_params`` carry their mesh, and
every function here runs on them unchanged, on every rank of the mesh
with the same inputs (SPMD): each rank attends with its own heads over a
cache of its own kv heads (flash-decode on the rank's G/tp groups),
sums ``wo``'s and ``w_down``'s partial products over tp, and gathers the
vocab-sharded logits, so every rank holds the same logits and picks the
same tokens.
"""

from __future__ import annotations

import math

import torch

from ..parallel import comm
from .moe import MoEConfig, moe_mlp_block
from .quant import wcast
from .transformer import (TransformerConfig, apply_rope, attention_block,
                          embed_tokens, layer_weights, lm_head_weight,
                          mlp_block, rms_norm, rope_frequencies,
                          unstack_layers)


def _placement(params) -> tuple:
    """(mesh, rules) of params placed by ``shard_decode_params``; (None,
    None) for params on one device."""
    return getattr(params, "mesh", None), getattr(params, "rules", None)


def _logits(x: torch.Tensor, params: dict, config: TransformerConfig,
            mesh, rules) -> torch.Tensor:
    """(..., d) final hidden states → f32 logits over the whole vocab
    (the rank's vocab slices gathered over tp)."""
    w = wcast(lm_head_weight(params, config, mesh, rules), x.dtype)
    logits = torch.einsum("...d,dv->...v", x, w).float()
    return comm.gather_dim(logits, mesh, "tp", dim=-1)


def _mlp(x: torch.Tensor, layer: dict, config: TransformerConfig,
         mesh=None, rules=None) -> torch.Tensor:
    """Dense or sparse MLP by config type. At decode the MoE router sees
    one token a row (N = batch), so a step's expert capacity is
    ceil(batch/E * factor * k): at a non-binding capacity decode logits
    equal the full forward's. On a mesh every rank holds the whole batch
    (``replicated``): the routing groups are the step's rows, each rank
    runs its experts' slots and the combine is summed over (tp, ep). The
    aux loss is a training quantity and is dropped here."""
    if isinstance(config, MoEConfig):
        return moe_mlp_block(x, layer, config, mesh, rules,
                             replicated=True)[0]
    return mlp_block(x, layer, config, mesh, rules)


# ------------------------------------------------------------------- cache
def init_kv_cache(config: TransformerConfig, batch: int,
                  kv_quant: bool = False, *, device, mesh=None) -> dict:
    """Zeroed (layers, batch, max_seq, kv_heads, d_head) K/V buffers (on a
    mesh, the rank's kv_heads/tp); ``kv_quant``: int8 buffers +
    per-(position, kv_head) f32 scales."""
    c = config
    shape = (c.n_layers, batch, c.max_seq_len,
             c.n_kv_heads // comm.axis_size(mesh, "tp"), c.d_head)
    if not kv_quant:
        return {"k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=c.compute_dtype, device=device)}
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
    }


def is_kv_quantized(cache: dict) -> bool:
    return "k_scale" in cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d_head) → int8 values + (...,) f32 amax/127 scales; rounds
    half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 start: int, layer: int) -> dict:
    """Write (b, s, h, d) K/V into layer ``layer`` of the stacked cache at
    sequence offset ``start``. In place (the JAX package returns an
    updated copy); quantized caches quantize at the write and store the
    per-position scales alongside."""
    sl = slice(start, start + k.shape[1])
    if not is_kv_quantized(cache):
        cache["k"][layer, :, sl] = k
        cache["v"][layer, :, sl] = v
        return cache
    qk, sk = _quantize_kv(k)
    qv, sv = _quantize_kv(v)
    cache["k"][layer, :, sl] = qk
    cache["v"][layer, :, sl] = qv
    cache["k_scale"][layer, :, sl] = sk
    cache["v_scale"][layer, :, sl] = sv
    return cache


def _row_index(pos: torch.Tensor, width: int, seq_len: int) -> tuple:
    """Where a per-row write of ``width`` positions from ``pos[b]`` goes:
    (rows, target, keep), with keep false at positions ``>= seq_len``.
    A dropped position is aimed at itself mod seq_len and rewrites that
    cell's own value: for ``width <= seq_len`` a row's positions have
    distinct residues, and those past the end fall below the ones
    before it, so no cell is written twice. Built once per step and
    shared by every layer's K/V (and scale) writes."""
    cols = pos.long()[:, None] + torch.arange(width, device=pos.device)
    rows = torch.arange(cols.shape[0], device=pos.device)[:, None]
    return rows, cols.remainder(seq_len), cols < seq_len


def _scatter_rows(buf: torch.Tensor, layer: int, index: tuple,
                  new: torch.Tensor) -> None:
    rows, target, keep = index
    keep = keep.reshape(keep.shape + (1,) * (new.dim() - 2))
    buf[layer, rows, target] = torch.where(keep, new,
                                           buf[layer, rows, target])


def _write_cache_window_rows(cache: dict, k: torch.Tensor, v: torch.Tensor,
                             index: tuple, layer: int) -> dict:
    """Per-row write, in place: (B, W, h, d) K/V lands at row b's
    ``pos[b] .. pos[b]+W-1`` (``index`` from ``_row_index``; every row at
    its own depth), and the part at or past ``max_seq_len`` is dropped, as
    the JAX package's scatter drops it, with no value read back to the
    host. W=1 is the JAX package's ``_write_cache_rows`` (decode_step).
    Quantized caches quantize at the write and store the per-position
    scales alongside."""
    if not is_kv_quantized(cache):
        _scatter_rows(cache["k"], layer, index, k)
        _scatter_rows(cache["v"], layer, index, v)
        return cache
    qk, sk = _quantize_kv(k)
    qv, sv = _quantize_kv(v)
    _scatter_rows(cache["k"], layer, index, qk)
    _scatter_rows(cache["v"], layer, index, qv)
    _scatter_rows(cache["k_scale"], layer, index, sk)
    _scatter_rows(cache["v_scale"], layer, index, sv)
    return cache


def _read_cache_layer(cache: dict, i: int, dt: torch.dtype):
    """Layer ``i``'s (B, S, G, D) K/V in compute dtype; quantized caches
    dequantize here (the einsum path)."""
    ck, cv = cache["k"][i], cache["v"][i]
    if is_kv_quantized(cache):
        ck = ck.to(dt) * cache["k_scale"][i][..., None].to(dt)
        cv = cv.to(dt) * cache["v_scale"][i][..., None].to(dt)
    return ck, cv


# ----------------------------------------------------------------- prefill
def prefill(params: dict, tokens: torch.Tensor, config: TransformerConfig,
            kv_quant: bool = False):
    """Run the prompt through a fresh KV cache. tokens: (batch, prompt_len)
    → (logits (batch, vocab) f32 for the LAST position, cache)."""
    c = config
    mesh, rules = _placement(params)
    B, S = tokens.shape
    cache = init_kv_cache(c, B, kv_quant=kv_quant, device=tokens.device,
                          mesh=mesh)
    x = embed_tokens(params, tokens, c, mesh, rules)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = rope_frequencies(c, positions)
    for i, layer in enumerate(unstack_layers(params["blocks"])):
        x, (k, v) = attention_block(x, layer, c, cos, sin, return_kv=True,
                                    mesh=mesh, rules=rules)
        _write_cache(cache, k, v, 0, layer=i)
        x = _mlp(x, layer, c, mesh, rules)
    x = rms_norm(x, params["final_norm"])
    return _logits(x[:, -1], params, c, mesh, rules), cache


def uses_flash_decode(config: TransformerConfig,
                      device: torch.device) -> bool:
    """Whether decode_step takes the flash-decode kernel: always when
    asked for, and under "auto" on CUDA (the JAX package's v5e-measured
    length gate is not carried over)."""
    c = config
    return c.decode_attention == "flash" or (
        c.decode_attention == "auto" and device.type == "cuda")


# -------------------------------------------------------------- decode step
def _row_positions(pos, batch: int, device: torch.device) -> torch.Tensor:
    """``pos`` as a (batch,) int32 tensor on ``device``: a (batch,) tensor
    as it is; an int (or 0-d tensor) filled on the device, since a host
    tensor copied to the card would wait for the card's queue to drain."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos,
                config: TransformerConfig):
    """One token in, next-token logits out; the cache is updated in place.

    token: (batch,) int; pos: an int or 0-d tensor (all rows at the same
    depth — the generate loop) or a (batch,) tensor of per-row positions.
    The token at ``pos`` is written before it is attended; attention
    covers positions ``<= pos``."""
    c = config
    mesh, rules = _placement(params)
    B = token.shape[0]
    dev = token.device
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    pos_vec = _row_positions(pos, B, dev)
    x = embed_tokens(params, token[:, None], c, mesh, rules)   # (B,1,D)
    cos, sin = rope_frequencies(c, pos_vec[:, None])
    scale = 1.0 / math.sqrt(c.d_head)
    rep = c.n_heads // c.n_kv_heads
    G = c.n_kv_heads // comm.axis_size(mesh, "tp")
    use_flash = uses_flash_decode(c, dev)
    if not use_flash:
        valid = (torch.arange(c.max_seq_len, device=dev)[None, :]
                 <= pos_vec[:, None])[:, None, None, None, :]  # (B,1,1,1,S)
    quant = is_kv_quantized(cache)
    if per_row:
        index = _row_index(pos_vec, 1, c.max_seq_len)
    else:
        start = int(pos)

    for i, layer in enumerate(unstack_layers(params["blocks"])):
        w = layer_weights(layer, ("attn_norm", "wq", "wk", "wv", "wo"), c,
                          mesh, rules)
        h = rms_norm(x, w["attn_norm"])
        dt = h.dtype
        q = torch.einsum("bsd,dhk->bshk", h, wcast(w["wq"], dt))
        k = torch.einsum("bsd,dhk->bshk", h, wcast(w["wk"], dt))
        v = torch.einsum("bsd,dhk->bshk", h, wcast(w["wv"], dt))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if per_row:
            _write_cache_window_rows(cache, k, v, index, layer=i)
        else:
            _write_cache(cache, k, v, start, layer=i)
        # grouped GQA: q heads fold to (kv_heads, rep) and contract against
        # the UN-repeated cache — head h reads kv head h // rep
        _, _, H, D = q.shape
        if use_flash:
            from ..ops.decode_attention import flash_decode_attention
            out = flash_decode_attention(
                q[:, 0].reshape(B, G, rep, D),
                cache["k"][i], cache["v"][i], pos_vec,
                k_scale=cache["k_scale"][i] if quant else None,
                v_scale=cache["v_scale"][i] if quant else None)
            out = out.reshape(B, H, D)[:, None].to(dt)
        else:
            qg = q.reshape(B, 1, G, rep, D)
            ck, cv = _read_cache_layer(cache, i, dt)          # (B, S, G, D)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                  ck.float()) * scale
            logits = logits.masked_fill(~valid, float("-inf"))
            probs = torch.softmax(logits, dim=-1).to(dt)
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cv).reshape(
                B, 1, H, D)
        y = torch.einsum("bshk,hkd->bsd", out, wcast(w["wo"], dt))
        x = x + comm.reduce_from(y, mesh, "tp")
        x = _mlp(x, layer, c, mesh, rules)

    x = rms_norm(x, params["final_norm"])
    return _logits(x[:, 0], params, c, mesh, rules), cache


def decode_window(params: dict, cache: dict, tokens: torch.Tensor, pos,
                  config: TransformerConfig):
    """W tokens in, W next-token logits out; the cache is updated in place.

    tokens: (B, W) consumed at positions ``pos[b] .. pos[b]+W-1`` (pos an
    int, a 0-d or a (B,) tensor); logits[:, i] (f32, (B, W, vocab)) is the
    next-token distribution after consuming tokens[:, :i+1], so
    ``decode_step`` is the W=1 case. Attention is the einsum path with a
    two-part mask: key position s is visible to window query i iff
    ``s <= pos + i`` (the prefix and the causal structure inside the
    window); f32 logits, probabilities in the compute dtype."""
    c = config
    mesh, rules = _placement(params)
    B, W = tokens.shape
    dev = tokens.device
    pos_vec = _row_positions(pos, B, dev)
    x = embed_tokens(params, tokens, c, mesh, rules)            # (B, W, D)
    positions = pos_vec[:, None] + torch.arange(W, dtype=torch.int32,
                                                device=dev)
    cos, sin = rope_frequencies(c, positions)
    scale = 1.0 / math.sqrt(c.d_head)
    valid = (torch.arange(c.max_seq_len, device=dev)[None, None, :]
             <= positions[:, :, None])[:, None, None]         # (B,1,1,W,S)
    rep = c.n_heads // c.n_kv_heads
    G = c.n_kv_heads // comm.axis_size(mesh, "tp")
    # window columns from max_seq_len on are past the end for every row
    width = min(W, c.max_seq_len)
    index = _row_index(pos_vec, width, c.max_seq_len)

    for i, layer in enumerate(unstack_layers(params["blocks"])):
        w = layer_weights(layer, ("attn_norm", "wq", "wk", "wv", "wo"), c,
                          mesh, rules)
        h = rms_norm(x, w["attn_norm"])
        dt = h.dtype
        q = torch.einsum("bsd,dhk->bshk", h, wcast(w["wq"], dt))
        k = torch.einsum("bsd,dhk->bshk", h, wcast(w["wk"], dt))
        v = torch.einsum("bsd,dhk->bshk", h, wcast(w["wv"], dt))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        _write_cache_window_rows(cache, k[:, :width], v[:, :width], index,
                                 layer=i)
        _, _, H, D = q.shape
        qg = q.reshape(B, W, G, rep, D)
        ck, cv = _read_cache_layer(cache, i, dt)              # (B, S, G, D)
        logits = torch.einsum("bwgrd,bsgd->bgrws", qg.float(),
                              ck.float()) * scale
        logits = logits.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bgrws,bsgd->bwgrd", probs, cv).reshape(
            B, W, H, D)
        y = torch.einsum("bshk,hkd->bsd", out, wcast(w["wo"], dt))
        x = x + comm.reduce_from(y, mesh, "tp")
        x = _mlp(x, layer, c, mesh, rules)

    x = rms_norm(x, params["final_norm"])
    return _logits(x, params, c, mesh, rules), cache


# ---------------------------------------------------------------- generate
def top_k_top_p_mask(logits: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus (top-p) sets to -inf.
    Both knobs are per-row (batch,) tensors: top_k <= 0 disables the
    k-cut, top_p >= 1 disables the nucleus cut."""
    order = torch.argsort(-logits, dim=-1, stable=True)          # desc
    sorted_logits = torch.gather(logits, -1, order)
    ranks = torch.argsort(order, dim=-1, stable=True)            # 0 = best
    k = top_k[:, None]
    keep = torch.where(k > 0, ranks < k, True)
    # nucleus: a token stays if the cumulative mass BEFORE it is < p
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    mass_before = torch.gather(cum_before, -1, ranks)
    keep &= torch.where(top_p[:, None] < 1.0,
                        mass_before < top_p[:, None], True)
    return logits.masked_fill(~keep, float("-inf"))


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor) -> torch.Tensor:
    """One decision per row: greedy at temperature 0, else temperature-
    scaled top-k/top-p sampling (Gumbel-max over the kept logits, noise
    from ``generator``). ``generator=None`` means no row samples."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    filtered = top_k_top_p_mask(scaled, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def check_lengths(prompt_len: int, max_new_tokens: int,
                  config: TransformerConfig) -> None:
    """Raise the ValueError ``generate`` raises for a prompt and budget
    that do not fit ``config.max_seq_len``."""
    if prompt_len + max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
            f"exceeds max_seq_len {config.max_seq_len}")


def generate(params: dict, prompt: torch.Tensor, config: TransformerConfig,
             max_new_tokens: int, temperature=0.0,
             generator: torch.Generator | None = None, top_k=0,
             top_p=1.0, eos_id: int | None = None, pad_id: int = 0,
             kv_quant: bool = False) -> torch.Tensor:
    """Greedy (temperature=0), temperature, top-k and/or nucleus sampling.

    prompt: (batch, prompt_len) → (batch, max_new_tokens) int32.
    ``temperature``/``top_k``/``top_p`` are scalars or per-row sequences.
    ``eos_id``: every position after a row's first EOS holds ``pad_id``
    (the loop still runs max_new_tokens steps). ``kv_quant``: int8 KV
    cache with per-position scales."""
    c = config
    B, prompt_len = prompt.shape
    check_lengths(prompt_len, max_new_tokens, c)
    dev = prompt.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).expand(B)
    sampling = bool((temps > 0).any())
    temps = temps.to(dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int32).expand(B).to(dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32).expand(B).to(dev)
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    gen = generator if sampling else None

    logits, cache = prefill(params, prompt, c, kv_quant=kv_quant)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tokens = []
    # N-1 model steps; the last token needs only a pick from the carried
    # logits, not another full step
    for i in range(max_new_tokens):
        token = sample_token(logits, gen, temps, top_k, top_p)
        if eos_id is not None:
            token = torch.where(done, torch.full_like(token, pad_id), token)
            done = done | (token == eos_id)
        tokens.append(token)
        if i < max_new_tokens - 1:
            logits, cache = decode_step(params, cache, token,
                                        prompt_len + i, c)
    return torch.stack(tokens, dim=1)
