"""Flash attention with its gradient: the hand-written CUDA kernels and
their plain PyTorch versions.

Port of ``kubeflow_tpu/ops/attention.py`` ``flash_attention`` and its
custom VJP. ``csrc/flash_attention.cu`` replaces the Pallas
``_flash_kernel`` (forward, with the per-row log-sum-exp the backward
needs); ``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_dkv_kernel``
and ``_flash_bwd_dq_kernel``. Each source's header says how it is laid out
and what bounds it on an H100. bf16 takes the tensor-core path of all
three kernels (wgmma on tiles that TMA copies into shared memory), f32
the scalar path.

``flash_attention`` is a ``torch.autograd.Function`` when a gradient is
needed: the forward saves (q, k, v, out, lse), the backward computes
Δ = rowsum(dO ⊙ O) and runs the two backward kernels. Every wrapper takes
the kernel for CUDA tensors and the plain version for CPU tensors,
decided by where the tensors lie and nothing else: on the card it
launches the kernel or raises. The TPU-tuned block table
(``TUNED_BLOCKS``) and the XLA fall-back for sequence lengths no block
divides are not carried over: the kernels mask the ragged edge
themselves, so they take any length.

The forward is also registered as the operator ``kft::flash_attention_fwd``
so that torch's selective activation checkpointing (``remat="attn"``,
models/transformer.py) can save its (out, lse) and replay them on
recompute instead of launching the forward again.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"kft_flash_attention_fwd": [
    _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]}
_BWD_SIGNATURES = {
    "kft_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 6 + [ctypes.c_float,
                                                          _I, _P],
    "kft_flash_attention_bwd_dq": [_P] * 8 + [_I] * 6 + [ctypes.c_float,
                                                         _I, _P]}

# kernel launches since the last reset (plain-version calls do not count)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch: f32 logits of the scaled q
    against k, the ``-1e30`` mask, probabilities cast to v's dtype before
    the PV product, f32 accumulation, ``max(l, 1e-30)`` denominator.
    Shapes (b, s, h, d); ``return_lse`` adds the (b, h, s) f32 row
    log-sum-exp."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        mask = torch.ones(s, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    denom = l.clamp_min(1e-30)
    out = (acc / denom.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom))[..., 0]
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True):
    """The backward kernels' function in plain PyTorch, after the
    reference's ``_flash_backward``/``_recompute_p_ds``: Δ = rowsum(dO ⊙ O)
    in f32; logits = (q·kᵀ)·scale, scaled after the product (the forward
    scales q before it); P = exp(logits − lse), 0 where masked;
    dS = P ⊙ (dO·Vᵀ − Δ)·scale; dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K, all in
    f32 from f32 upcasts (P is not rounded to bf16, unlike in the forward),
    cast to the inputs' dtype. Shapes (b, s, h, d); lse (b, h, s) f32.
    Returns (dq, dk, dv)."""
    d = q.shape[3]
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    delta = (do32 * o.float()).sum(dim=-1).transpose(1, 2)      # (b, h, s)
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    p = torch.exp(logits - lse[..., None])
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q/k/v must share one (b, s, h, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} (GQA callers repeat K/V)")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"d_head {q.shape[3]} not in {_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must lie on one device")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on the current stream."""
    _check(q, k, v)
    q, k, v = (_kernel_ready(x) for x in (q, k, v))
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = (ctypes.c_int64 * 12)(
        *[x.stride(i) for x in (q, k, v, out) for i in range(3)])
    lib = _build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kft_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, strides,
        b, s, h, d, _DTYPES[q.dtype], int(causal),
        1.0 / math.sqrt(d), q.device.index or 0, stream)
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: d contiguous, and in bf16, which TMA
    reads, a base and (b, s, h) strides that are positive multiples of 16
    bytes; otherwise a fresh contiguous copy (``contiguous`` would keep a
    misaligned base)."""
    if x.dtype != torch.bfloat16:
        return x if x.stride(-1) == 1 else x.contiguous()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            x.stride(i) > 0 and x.stride(i) * 2 % 16 == 0
            for i in range(3) if x.shape[i] > 1):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def prepare_bwd_inputs(q, k, v, o, lse, do):
    """Check the backward's inputs, give q/k/v/dO a unit last stride, and
    form Δ = rowsum(dO ⊙ O) in f32 as (b, h, s). Returns
    (q, k, v, dO, lse, Δ), what the two kernel wrappers take."""
    _check(q, k, v)
    b, s, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o and dO must match q's shape and dtype; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype} for q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {s}) float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (q.device == o.device == lse.device == do.device):
        raise ValueError("q/k/v/o/lse/dO must lie on one device")
    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse.contiguous(), delta


def _launch_args(q, causal):
    b, s, h, d = q.shape
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    return lib, (b, s, h, d, _DTYPES[q.dtype], int(causal),
                 1.0 / math.sqrt(d), q.device.index or 0,
                 torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True):
    """Launch the dK/dV kernel on the current stream: (dk, dv) from
    prepared inputs (``prepare_bwd_inputs``)."""
    dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
              for x in (k, v))
    st = (ctypes.c_int64 * 18)(
        *[x.stride(i) for x in (q, k, v, do, dk, dv) for i in range(3)])
    lib, args = _launch_args(q, causal)
    err = lib.kft_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), st,
        *args)
    _build.check(err, "flash_attention_bwd_dkv")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True):
    """Launch the dQ kernel on the current stream: dq from prepared
    inputs (``prepare_bwd_inputs``)."""
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = (ctypes.c_int64 * 15)(
        *[x.stride(i) for x in (q, k, v, do, dq) for i in range(3)])
    lib, args = _launch_args(q, causal)
    err = lib.kft_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), st, *args)
    _build.check(err, "flash_attention_bwd_dq")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True):
    """The backward on the card: Δ formed here in f32, then the dK/dV and
    the dQ kernel of ``csrc/flash_attention_bwd.cu``. Returns
    (dq, dk, dv), contiguous, in the inputs' dtype."""
    q, k, v, do, lse, delta = prepare_bwd_inputs(q, k, v, o, lse, do)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


@torch.library.custom_op("kft::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the forward: the kernel for CUDA tensors, the plain
    version for CPU tensors. An operator, so that selective checkpointing
    sees it (ops launched through ctypes are invisible to dispatch)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, return_lse=True)
    return flash_attention_plain(q, k, v, causal, return_lse=True)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the two backward kernels as its gradient (the
    reference's ``jax.custom_vjp``): saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd_op(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # grads out of an einsum are often strided: the kernels read d
        # contiguous
        dout = _kernel_ready(dout)
        bwd = flash_attention_bwd_cuda if q.is_cuda \
            else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q/k/v: (batch, seq, heads, d_head) → (batch, seq, heads, d_head).
    CUDA tensors go through the kernels, CPU tensors through the plain
    versions. Differentiable (``FlashAttention``) when a gradient is
    needed; ``return_lse`` (prefill) adds the (b, h, s) f32 log-sum-exp
    and is not differentiable."""
    if not return_lse and torch.is_grad_enabled() and \
            any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, return_lse)
    return flash_attention_plain(q, k, v, causal, return_lse)
