"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``kubeflow_tpu/ops/attention.py`` ``flash_attention`` (forward;
the backward kernels come with the train step). The CUDA kernel,
``csrc/flash_attention.cu``, replaces the Pallas ``_flash_kernel``; its
header says how it is laid out and what bounds it on an H100.

``flash_attention`` takes the kernel for CUDA tensors and the plain
version for CPU tensors, decided by where the tensors lie and nothing
else: on the card it launches the kernel or raises. The TPU-tuned block
table (``TUNED_BLOCKS``) and the XLA fall-back for sequence lengths no
block divides are not carried over: the kernel masks the ragged edge
itself, so it takes any length.
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

# kernel launches since the last reset (plain-version calls do not count)
LAUNCHES = {"flash_attention": 0}


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
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q/k/v: (batch, seq, heads, d_head) → (batch, seq, heads, d_head).
    CUDA tensors go through the kernel, CPU tensors through
    ``flash_attention_plain``."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, return_lse)
    return flash_attention_plain(q, k, v, causal, return_lse)
