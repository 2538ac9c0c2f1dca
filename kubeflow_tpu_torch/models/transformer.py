"""Flagship workload: decoder-only transformer LM, forward and backward.

Port of ``kubeflow_tpu/models/transformer.py`` (``pipelined_forward``,
ring and Ulysses attention come with the multi-device slice of the port).
Plain functions on tensors, with the JAX package's layouts at every public
function: (b, s, h, d) attention, and params as a dict whose layer weights
are stacked on a leading (L, ...) axis (``wq`` (L, d, h, k), ``wo``
(L, h, k, d), ...), so the tests compare like with like. f32 params (or
bf16 with f32 masters in the optimizer), activations in ``config.dtype``,
f32 softmax/norm accumulation.

The backward is torch autograd through these functions, with two
hand-written pieces as in the reference: ``rms_norm`` saves only
(x, w, per-row inv) (its custom VJP), and flash attention's gradient is
the two backward kernels (ops/attention.py). ``remat`` selects activation
checkpointing per layer (``torch.utils.checkpoint``, non-reentrant), after
``resolve_remat_mlp``/``resolve_layer_remat``; it changes memory and
launches, never values.

Attention dispatch: ``attention="auto"`` takes the hand-written flash
kernels (ops/attention.py) for CUDA tensors at every sequence length, and
the plain reference attention on the CPU. The JAX package's TPU gate
(``FLASH_MIN_SEQ``) was measured on a v5e and is not carried over.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    # activation checkpointing of the training backward (False: save
    # everything; "mlp": recompute the FFN; "attn": recompute the layer but
    # not its attention; True: recompute the whole layer); values do not
    # depend on it
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
                f"queue A, multi-device)")
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


def unstack_layers(blocks: dict) -> list[dict]:
    """The stacked (L, ...) block weights as one dict per layer, each
    weight taken apart once with ``unbind(0)`` (quantized nodes split
    ``q`` and ``s`` together). Under autograd, ``unbind``'s backward stacks
    the L grads in one op; indexing ``w[i]`` per layer would materialise a
    zero (L, ...) grad per layer instead."""
    per_name = {name: ([{"q": q, "s": sc} for q, sc in
                        zip(w["q"].unbind(0), w["s"].unbind(0))]
                       if is_quantized(w) else w.unbind(0))
                for name, w in blocks.items()}
    return [dict(zip(per_name, layer)) for layer in zip(*per_name.values())]


# ------------------------------------------------------------------- layers
def _rms_norm_impl(x, weight, eps):
    """One primal body for the plain and the differentiated forward.
    Returns (y, inv) with inv the per-row rsqrt."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * weight.float()).to(x.dtype), inv


class RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward follows the reference's ``_rms_norm_bwd``:
    it saves only (x, weight, inv), inv the per-row rsqrt — d× smaller
    than the f32 normalised intermediate autograd of the naive form
    would keep — and recomputes the rest."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        y, inv = _rms_norm_impl(x, weight, eps)
        ctx.save_for_backward(x, weight, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, inv = ctx.saved_tensors
        x32, g32, w32 = x.float(), g.float(), weight.float()
        d = x.shape[-1]
        wg = g32 * w32
        # d(x·inv(x))·wg: product rule through the rsqrt(mean(x²)) term
        dot = (x32 * wg).sum(dim=-1, keepdim=True)
        dx = inv * wg - inv ** 3 * x32 * dot / d
        dw = (g32 * x32 * inv).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to x's dtype; differentiable
    through ``RMSNorm`` when a gradient is needed."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNorm.apply(x, weight, eps)
    return _rms_norm_impl(x, weight, eps)[0]


def rope_frequencies(config: TransformerConfig, positions: torch.Tensor):
    """positions: (..., seq) int → cos/sin of shape (..., seq, d_head/2)."""
    d = config.d_head // 2
    # made on positions' device: a host tensor copied to the card would
    # make every decode step wait for the card to drain its queue
    inv_freq = torch.pow(config.rope_theta, -torch.arange(
        0, d, dtype=torch.float32, device=positions.device) / d)
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


# ------------------------------------------------------------------- remat
def resolve_remat_mlp(config: TransformerConfig, mlp_fn):
    """``remat="mlp"``: checkpoint only the FFN, whose saved (b, s, d_ff)
    gate/up activations dominate memory; everything else stays saved."""
    if config.remat == "mlp":
        return functools.partial(checkpoint, mlp_fn, use_reentrant=False)
    return mlp_fn


def _save_flash(ctx, func, *args, **kwargs):
    """Selective-checkpoint policy of the attention region under
    ``remat="attn"``: save the flash forward's (out, lse), recompute every
    other op."""
    if func is torch.ops.kft.flash_attention_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _attn_contexts():
    return create_selective_checkpoint_contexts(_save_flash)


def resolve_layer_remat(config: TransformerConfig, attn_fn, mlp_fn):
    """The whole-layer policies for a layer of ``attn_fn(x, layer)`` then
    ``mlp_fn(x, layer)``, as one body ``body(x, layer)``:

    - True   → checkpoint everything (smallest footprint; the backward
               re-runs the full layer forward, flash attention included);
    - "attn" → checkpoint everything except the attention's output: the
               backward recomputes norms, projections and the FFN, but
               replays the saved flash (out, lse) instead of launching the
               attention forward again. The layer is two checkpointed
               regions, so the post-attention residual — the reference's
               ``tag_attn_out`` — is saved as the FFN region's input.
    """
    if config.remat == "attn":
        attn_fn = functools.partial(checkpoint, attn_fn, use_reentrant=False,
                                    context_fn=_attn_contexts)
        mlp_fn = functools.partial(checkpoint, mlp_fn, use_reentrant=False)

    def layer(x, layer_params):
        return mlp_fn(attn_fn(x, layer_params), layer_params)

    if config.remat is True:
        return functools.partial(checkpoint, layer, use_reentrant=False)
    return layer


def forward_hidden(params: dict, tokens: torch.Tensor,
                   config: TransformerConfig,
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → final-norm hidden states (b, s, d); the
    LM head is not applied (the fused chunked CE, models/train.py, takes
    the hidden states)."""
    c = config
    x = params["embed"].to(c.compute_dtype)[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions[None, :].expand(tokens.shape)
    cos, sin = rope_frequencies(c, positions)
    mlp = resolve_remat_mlp(c, mlp_block)
    body = resolve_layer_remat(
        c, lambda x, layer: attention_block(x, layer, c, cos, sin),
        lambda x, layer: mlp(x, layer, c))
    for layer in unstack_layers(params["blocks"]):
        x = body(x, layer)
    return rms_norm(x, params["final_norm"])


def lm_head_logits(x: torch.Tensor, lm_head) -> torch.Tensor:
    """(b, s, d) hidden → (b, s, vocab) f32 logits."""
    return torch.einsum("bsd,dv->bsv", x, wcast(lm_head, x.dtype)).float()


def forward(params: dict, tokens: torch.Tensor, config: TransformerConfig,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → logits (batch, seq, vocab) float32."""
    x = forward_hidden(params, tokens, config, positions=positions)
    return lm_head_logits(x, params["lm_head"])


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(p) for p in params.values())
    return params.numel()


def model_flops_per_token(config: TransformerConfig) -> float:
    """Approximate forward FLOPs/token (2*params matmul convention)."""
    c = config
    per_layer = 2 * (c.d_model * c.n_heads * c.d_head * 2
                     + c.d_model * c.n_kv_heads * c.d_head * 2
                     + 3 * c.d_model * c.d_ff)
    return c.n_layers * per_layer + 2 * c.d_model * c.vocab_size
