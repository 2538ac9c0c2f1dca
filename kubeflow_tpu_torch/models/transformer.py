"""Flagship workload: decoder-only transformer LM, forward pass.

Port of ``kubeflow_tpu/models/transformer.py`` (forward only: remat,
``pipelined_forward``, ring and Ulysses attention come with later slices
of the port). Plain functions on tensors, with the JAX package's layouts
at every public function: (b, s, h, d) attention, and params as a dict
whose layer weights are stacked on a leading (L, ...) axis
(``wq`` (L, d, h, k), ``wo`` (L, h, k, d), ...), so the tests compare
like with like. f32 params, activations in ``config.dtype``, f32
softmax/norm accumulation.

Attention dispatch: ``attention="auto"`` takes the hand-written flash
kernel (ops/attention.py) for CUDA tensors at every sequence length, and
the plain reference attention on the CPU. The JAX package's TPU gate
(``FLASH_MIN_SEQ``) was measured on a v5e and is not carried over.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from .quant import is_quantized, wcast

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8          # < n_heads ⇒ grouped-query attention
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    # activation checkpointing of the training backward; the forward's
    # values do not depend on it (kept so one config file serves both)
    remat: bool | str = False
    attention: str = "auto"      # auto | xla | flash
    decode_attention: str = "auto"   # auto | xla | flash

    def __post_init__(self):
        if self.remat not in (False, True, "mlp", "attn"):
            raise ValueError(f"remat must be False, True, 'mlp', or "
                             f"'attn'; got {self.remat!r}")
        if self.attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={self.attention!r} is not ported yet (ROADMAP "
                f"queue A item 4, multi-device)")
        if self.attention not in ("auto", "xla", "flash"):
            raise ValueError(f"attention must be auto, xla, or flash; got "
                             f"{self.attention!r}")
        if self.decode_attention not in ("auto", "xla", "flash"):
            raise ValueError(f"decode_attention must be auto, xla, or "
                             f"flash; got {self.decode_attention!r}")
        for name in (self.dtype, self.param_dtype):
            if name not in _DTYPES:
                raise ValueError(f"dtype {name!r} not in {sorted(_DTYPES)}")

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------------ params
def init_params(generator: torch.Generator, config: TransformerConfig,
                device="cuda") -> dict:
    """Random params drawn from ``generator`` (on its own device), placed
    on ``device``. Same shapes, dtypes and scales as the JAX package's
    ``init_params``; the numbers differ (another RNG)."""
    c = config
    dev = resolve_device(device)
    pdt = c.torch_param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pdt,
                        device=generator.device)
        return (w / math.sqrt(fan_in)).to(dev)

    L = c.n_layers
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
        "w_gate": dense((L, c.d_model, c.d_ff), c.d_model),
        "w_up": dense((L, c.d_model, c.d_ff), c.d_model),
        "w_down": dense((L, c.d_ff, c.d_model), c.d_ff),
    }
    return {
        "embed": embed,
        "blocks": blocks,
        "final_norm": torch.ones((c.d_model,), dtype=pdt, device=dev),
        "lm_head": dense((c.d_model, c.vocab_size), c.d_model),
    }


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked (L, ...) block weights (quantized nodes
    slice ``q`` and ``s`` together)."""
    return {name: ({"q": w["q"][i], "s": w["s"][i]} if is_quantized(w)
                   else w[i])
            for name, w in blocks.items()}


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to x's dtype (forward only;
    the custom backward comes with the train step)."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * weight.float()).to(x.dtype)


def rope_frequencies(config: TransformerConfig, positions: torch.Tensor):
    """positions: (..., seq) int → cos/sin of shape (..., seq, d_head/2)."""
    d = config.d_head // 2
    inv_freq = torch.pow(
        torch.tensor(config.rope_theta, dtype=torch.float32),
        -torch.arange(0, d, dtype=torch.float32) / d).to(positions.device)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (batch, seq, heads, d_head); cos/sin: (batch, seq, d_head/2).
    Rotates the two halves of d_head (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv_heads, d) → (b, s, kv_heads*n_rep, d) for GQA: head h
    reads kv head h // n_rep, as ``jnp.repeat`` lays it out."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Reference attention, plain PyTorch (the JAX package leaves it to
    XLA): f32 logits and softmax, probabilities cast to q's dtype for the
    PV product. Shapes (b, s, h, d)."""
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _select_attention(config: TransformerConfig, device: torch.device) -> str:
    if config.attention != "auto":
        return config.attention
    return "flash" if device.type == "cuda" else "xla"


def attention_block(x, layer, config: TransformerConfig, cos, sin,
                    return_kv: bool = False):
    """``return_kv=True`` also returns the post-RoPE, pre-GQA-repeat
    (k, v) — what a decode KV cache stores (models/decode.py prefill)."""
    c = config
    h = rms_norm(x, layer["attn_norm"])
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wq"], dt))
    k = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wk"], dt))
    v = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wv"], dt))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv = (k, v)
    n_rep = c.n_heads // c.n_kv_heads
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if _select_attention(c, x.device) == "flash":
        from ..ops.attention import flash_attention
        out = flash_attention(q, kr, vr, causal=True)
    else:
        out = xla_attention(q, kr, vr, causal=True)
    x = x + torch.einsum("bshk,hkd->bsd", out, wcast(layer["wo"], dt))
    return (x, kv) if return_kv else x


def mlp_block(x, layer, config: TransformerConfig):
    h = rms_norm(x, layer["mlp_norm"])
    dt = h.dtype
    gate = torch.einsum("bsd,df->bsf", h, wcast(layer["w_gate"], dt))
    up = torch.einsum("bsd,df->bsf", h, wcast(layer["w_up"], dt))
    return x + torch.einsum("bsf,fd->bsd", F.silu(gate) * up,
                            wcast(layer["w_down"], dt))


def forward_hidden(params: dict, tokens: torch.Tensor,
                   config: TransformerConfig,
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → final-norm hidden states (b, s, d); the
    LM head is not applied."""
    c = config
    x = params["embed"].to(c.compute_dtype)[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions[None, :].expand(tokens.shape)
    cos, sin = rope_frequencies(c, positions)
    for i in range(c.n_layers):
        layer = layer_params(params["blocks"], i)
        x = attention_block(x, layer, c, cos, sin)
        x = mlp_block(x, layer, c)
    return rms_norm(x, params["final_norm"])


def lm_head_logits(x: torch.Tensor, lm_head) -> torch.Tensor:
    """(b, s, d) hidden → (b, s, vocab) f32 logits."""
    return torch.einsum("bsd,dv->bsv", x, wcast(lm_head, x.dtype)).float()


def forward(params: dict, tokens: torch.Tensor, config: TransformerConfig,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → logits (batch, seq, vocab) float32."""
    x = forward_hidden(params, tokens, config, positions=positions)
    return lm_head_logits(x, params["lm_head"])
