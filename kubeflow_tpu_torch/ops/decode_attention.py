"""Flash-decode attention: one query token per row against the KV cache —
the hand-written CUDA kernel and its plain PyTorch version.

Port of ``kubeflow_tpu/ops/decode_attention.py`` ``flash_decode_attention``.
The CUDA kernel, ``csrc/flash_decode.cu``, replaces the Pallas
``_decode_kernel``; its header says how it is laid out and what bounds it
on an H100. The query arrives grouped (B, G, rep, D) and contracts against
the un-repeated (B, S, G, D) cache; entries past ``pos[b]`` are dead; an
int8 cache carries (B, S, G) f32 scales folded outside the products. The
kernel splits the cache into chunks (split-KV) and a second launch merges
their partials; the wrapper allocates the partials' workspace, and one
call counts one launch.

``flash_decode_attention`` takes the kernel for CUDA tensors and the plain
version for CPU tensors, decided by where the tensors lie and nothing
else: on the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_REPS = (1, 2, 4, 8)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"kft_flash_decode": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    ctypes.c_float, _I, _P], "kft_flash_decode_chunk": []}

# kernel launches since the last reset (plain-version calls do not count)
LAUNCHES = {"flash_decode": 0, "flash_decode_int8": 0}


def flash_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, pos: torch.Tensor, *,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, all in f32: logits of the
    scaled q against k (times the K scale for an int8 cache), the ``<=
    pos`` mask at ``-1e30``, P times the V scale after the denominator sum,
    ``max(l, 1e-30)`` denominator, result in q's dtype."""
    B, G, rep, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bgrd,bsgd->bgrs", q.float() * scale, k.float())
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    valid = (torch.arange(S, device=q.device)[None, :]
             <= pos.to(q.device).long()[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _check(q, k, v, pos, k_scale, v_scale):
    B, G, rep, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[2] != G or k.shape[3] != D:
        raise ValueError(f"cache {tuple(k.shape)}/{tuple(v.shape)} does not "
                         f"match q {tuple(q.shape)} as (B, S, G, D)")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("k_scale and v_scale go together")
    want = torch.int8 if quant else q.dtype
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"cache dtype {k.dtype}/{v.dtype}; expected {want}")
    if quant:
        for sc in (k_scale, v_scale):
            if sc.shape != k.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f"scales must be (B, S, G) float32; got "
                                 f"{tuple(sc.shape)} {sc.dtype}")
    if D not in _HEAD_DIMS or rep not in _REPS:
        raise ValueError(f"d_head {D} / rep {rep} not in {_HEAD_DIMS} / "
                         f"{_REPS}")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({B},) int32; got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    tensors = [q, k, v, pos] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one device")


def _cache_ready(x: torch.Tensor) -> torch.Tensor:
    """A K/V cache as the kernel's 16-byte copies read it: d contiguous, a
    base and (b, s, g) strides that are multiples of 16 bytes (a layer's
    slice of the stacked cache is); otherwise a fresh contiguous copy."""
    item = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            x.stride(i) * item % 16 == 0 for i in range(3)
            if x.shape[i] > 1):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _lib():
    return _build.load("flash_decode", _SIGNATURES)


def flash_decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, pos: torch.Tensor, *,
                                k_scale: torch.Tensor | None = None,
                                v_scale: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu`` on the current stream."""
    _check(q, k, v, pos, k_scale, v_scale)
    lib = _lib()
    quant = k_scale is not None
    k, v = _cache_ready(k), _cache_ready(v)
    q, pos = q.contiguous(), pos.contiguous()
    B, G, rep, D = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    # the splits' partials: f32 (m, l, acc[rep][D]) per (b, g, split)
    nsplit = -(-S // lib.kft_flash_decode_chunk())
    ws = torch.empty(B * G * nsplit * rep * (D + 2), dtype=torch.float32,
                     device=q.device)
    scales = (k_scale, v_scale) if quant else (k, v)  # unread if not quant
    strides = (ctypes.c_int64 * 12)(
        *[x.stride(i) for x in (k, v, *scales) for i in range(3)])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kft_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), strides, B, G, S,
        rep, D, _DTYPES[q.dtype], int(quant), 1.0 / math.sqrt(D),
        q.device.index or 0, stream)
    _build.check(err, "flash_decode_attention")
    LAUNCHES["flash_decode_int8" if quant else "flash_decode"] += 1
    return out


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos: torch.Tensor, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """q: (B, G, rep, D) one grouped query token; k/v: (B, S, G, D) cache
    (int8 when ``k_scale``/``v_scale`` (B, S, G) are given, else q's
    dtype); pos: (B,) int32 — entries at s <= pos[b] are live. Returns
    (B, G, rep, D) in q's dtype. CUDA tensors go through the kernel, CPU
    tensors through ``flash_decode_attention_plain``."""
    if q.is_cuda:
        return flash_decode_attention_cuda(q, k, v, pos, k_scale=k_scale,
                                           v_scale=v_scale)
    return flash_decode_attention_plain(q, k, v, pos, k_scale=k_scale,
                                        v_scale=v_scale)
