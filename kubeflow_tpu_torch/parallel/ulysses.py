"""Ulysses sequence parallelism: all-to-all head/sequence exchange.

Port of ``kubeflow_tpu/parallel/ulysses.py``. Where ring attention keeps
the sequence sharded and rotates K/V, Ulysses trades two all-to-alls for
local attention over the whole sequence: scatter heads / gather sequence,
attend with heads/sp heads a rank, then scatter sequence / gather heads
back. The all-to-all is ``comm.all_to_all``, an autograd Function whose
backward is the inverse exchange.

The local attention in between is the port's flash attention on CUDA
tensors (the forward kernel, and the dK/dV and dQ kernels in the
backward), as the reference calls its Pallas kernel there on a TPU, and
the plain attention on the CPU.

Technique after Jacobs et al., "DeepSpeed Ulysses" (arXiv:2309.14509).
"""

from __future__ import annotations

import torch

from . import comm


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis_name: str = "sp", causal: bool = True,
                      n_rep: int = 1) -> torch.Tensor:
    """Ulysses attention on this rank's blocks. q: (batch, seq/sp,
    heads_local, d_head), heads_local the rank's heads (heads/tp); k/v
    carry the UN-repeated GQA heads plus ``n_rep``, so the K/V
    all-to-alls move 1/n_rep the bytes: either the rank's own kv heads
    (n_kv_heads/tp), or, when n_kv_heads does not divide over tp, all
    n_kv_heads (replicated over tp; repeated to every q head and cut to
    this rank's before the exchange, full-width bytes). heads_local must
    divide by sp. Returns q's shape."""
    from ..models.transformer import local_attention, repeat_kv

    sp = comm.axis_size(mesh, axis_name)
    if sp == 1:
        return local_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                               causal=causal)
    heads_local = q.shape[2]
    if heads_local % sp:
        raise ValueError(
            f"ulysses needs per-rank heads ({heads_local}) divisible by "
            f"sp={sp}; use ring attention for this shape")
    tp = comm.axis_size(mesh, "tp")
    if k.shape[2] * n_rep == heads_local * tp != heads_local:
        # kv heads replicated over tp: repeat to every q head, keep ours
        r = comm.axis_rank(mesh, "tp")
        sl = slice(r * heads_local, (r + 1) * heads_local)
        k, v = repeat_kv(k, n_rep)[:, :, sl], repeat_kv(v, n_rep)[:, :, sl]
        n_rep = 1
    elif k.shape[2] * n_rep != heads_local:
        raise ValueError(f"k has {k.shape[2]} heads x n_rep {n_rep}, q has "
                         f"{heads_local} (tp={tp})")
    # exchange-then-repeat only when the kv head chunks stay aligned
    repeat_after = n_rep > 1 and k.shape[2] % sp == 0
    if not repeat_after:
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)

    # (b, s/sp, h, d) → (b, s, h/sp, d): scatter heads, gather sequence
    def fwd(x):
        return comm.all_to_all(x, mesh, axis_name, split=2, concat=1)

    qf, kf, vf = fwd(q), fwd(k), fwd(v)
    if repeat_after:
        kf, vf = repeat_kv(kf, n_rep), repeat_kv(vf, n_rep)
    out = local_attention(qf, kf, vf, causal=causal)
    # (b, s, h/sp, d) → (b, s/sp, h, d): scatter sequence, gather heads
    return comm.all_to_all(out, mesh, axis_name, split=1, concat=2)
