"""Ring attention: exact causal attention over a sequence-sharded axis.

Port of ``kubeflow_tpu/parallel/ring.py``. Each rank holds one sequence
block of Q/K/V; the K/V blocks rotate around the ``sp`` ring while each
rank accumulates its Q block's attention with the streaming-softmax
(flash) recurrence in f32. The block attention is a plain einsum, as the
reference's is (it never calls the flash kernel).

The rotation is ``comm.ring_shift``, an autograd Function (send to the
next rank ↔ send the grads to the previous one), so autograd through
the loop is the reference's autodiff through its ``fori_loop``. The
causal skip above the diagonal skips the matmuls only: every rank makes
every rotation, forward and backward, as the reference keeps its
``ppermute`` unconditional, since a rank that skipped one would stall
the ring. The last rotation's output is the one a rank may not use
(causal, below the last rank); it is tied into the result with a zero
grad so that its backward rotation still runs.

Technique after Liu et al., "Ring Attention with Blockwise Transformers"
(arXiv:2310.01889).
"""

from __future__ import annotations

import math

import torch

from . import comm

_NEG_INF = -1e30


def _block_attention(q, k, v, *, scale, mask):
    """One (q-block × kv-block) flash step. q, k, v: (b, s, h, d); mask:
    (sq, sk) bool or None. Returns (contrib, row_sum, row_max) with
    contrib = exp(logits - row_max) @ v."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    row_max = logits.amax(dim=-1)                              # (b, h, sq)
    p = torch.exp(logits - row_max[..., None])
    if mask is not None:
        p = p * mask
    row_sum = p.sum(dim=-1)                                    # (b, h, sq)
    contrib = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return contrib, row_sum, row_max


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Ring attention on this rank's blocks. q/k/v: (batch, seq/sp,
    heads, d_head), the rank's sequence block (and its own heads under
    tp); returns q's shape. With no mesh or sp = 1 it is the plain local
    attention, the reference's fallback."""
    sp = comm.axis_size(mesh, axis_name)
    if sp == 1:
        from ..models.transformer import xla_attention
        return xla_attention(q, k, v, causal=causal)
    return _ring_local(q, k, v, mesh=mesh, axis_name=axis_name,
                       axis_size=sp, causal=causal)


def _ring_local(q, k, v, *, mesh, axis_name: str, axis_size: int,
                causal: bool):
    """Per-rank body: rotate K/V around the ring, accumulate flash
    stats."""
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    me = comm.axis_rank(mesh, axis_name)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    q_pos = me * sq + torch.arange(sq, device=q.device)
    k_cur, v_cur = k, v
    for t in range(axis_size):
        kv_idx = (me - t) % axis_size
        if not causal or kv_idx <= me:
            mask = None
            if causal:
                k_pos = kv_idx * sq + torch.arange(sq, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
            contrib, row_sum, row_max = _block_attention(
                q, k_cur, v_cur, scale=scale, mask=mask)
            m_new = torch.maximum(m, row_max)
            alpha = torch.exp(m - m_new)        # rescale of the old sums
            beta = torch.exp(row_max - m_new)   # rescale of this block
            l = l * alpha + row_sum * beta
            o = (o * alpha.transpose(1, 2)[..., None]
                 + contrib.float() * beta.transpose(1, 2)[..., None])
            m = m_new
        elif t == axis_size - 1:
            o = comm.Tie.apply(o, k_cur, v_cur)
        if t < axis_size - 1:
            # the reference rotates once more after the last block; that
            # rotation's result is never read, so the port leaves it out
            # on every rank alike
            k_cur, v_cur = comm.ring_shift((k_cur, v_cur), mesh, axis_name)
    denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)
