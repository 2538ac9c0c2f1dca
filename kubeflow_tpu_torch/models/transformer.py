"""Flagship workload: decoder-only transformer LM, forward and backward.

Port of ``kubeflow_tpu/models/transformer.py``.
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

Attention dispatch: ``attention="auto"`` takes ring attention when the
mesh has sp > 1 (parallel/ring.py), else the hand-written flash kernels
(ops/attention.py) for CUDA tensors at every sequence length, and the
plain reference attention on the CPU. The JAX package's TPU gate
(``FLASH_MIN_SEQ``) was measured on a v5e and is not carried over.

On a mesh (``mesh=``, a DeviceMesh of parallel/mesh.py) each rank runs
these functions on its local shards, laid out by ``param_logical_specs``
and the partition rules, with the collectives GSPMD inserts for the
reference placed by hand (parallel/comm.py):

- fsdp: each layer gathers its weights before use (the backward
  reduce-scatters their grads), inside the layer's remat region;
- tp: attention runs on the rank's heads and the FFN on its ``mlp``
  shard, the input of each goes through ``copy_to`` (its grad summed over
  tp) and the output of ``wo`` / ``w_down`` through ``reduce_from`` (an
  all-reduce); the embedding is vocab-sharded, so the lookup is a masked
  local gather plus an all-reduce, and the LM head gives the rank's vocab
  slice of the logits;
- sp: the rank holds one sequence block, its RoPE positions offset by
  its sp index, and attention is ring or Ulysses;
- pp: the rank holds one stage's layers (``pipeline_rules`` put the
  stacked layer axis on pp) and ``pipelined_forward`` runs the GPipe
  schedule of parallel/pipeline.py over the stages, the embedding and
  the LM head outside it, the stage body the layer body above.
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
from ..parallel import comm
from ..parallel.sharding import (PartitionRules, gather_for_compute,
                                 spec_axes, spec_tree)
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
    attention: str = "auto"      # auto | xla | ring | ulysses | flash
    decode_attention: str = "auto"   # auto | xla | flash

    def __post_init__(self):
        if self.remat not in (False, True, "mlp", "attn"):
            raise ValueError(f"remat must be False, True, 'mlp', or "
                             f"'attn'; got {self.remat!r}")
        if self.attention not in ("auto", "xla", "ring", "ulysses",
                                  "flash"):
            raise ValueError(f"attention must be auto, xla, ring, ulysses "
                             f"or flash; got {self.attention!r}")
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
def param_logical_specs(config: TransformerConfig) -> dict:
    """Logical-axis names per weight; the partition rules turn them into
    mesh specs. Layer weights are stacked on a leading 'layers' axis."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", "norm"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


@functools.lru_cache(maxsize=64)
def param_specs(config: TransformerConfig,
                rules: PartitionRules | None = None) -> dict:
    """The mesh spec of each weight under ``rules`` (default
    ``DEFAULT_RULES``), in the params' tree: ``param_logical_specs``, or
    ``moe_param_logical_specs`` for an ``MoEConfig``. Shared: don't
    mutate it."""
    return spec_tree(_logical_specs(config), rules)


def _logical_specs(config: TransformerConfig) -> dict:
    """The logical specs of the config's family."""
    from .moe import MoEConfig, moe_param_logical_specs
    if isinstance(config, MoEConfig):
        return moe_param_logical_specs(config)
    return param_logical_specs(config)


@functools.lru_cache(maxsize=64)
def _layer_specs(config: TransformerConfig,
                 rules: PartitionRules | None = None) -> dict:
    """Each block weight's spec without its stacked layer axis."""
    return {k: v[1:] for k, v in param_specs(config, rules)["blocks"].items()}


_TP_LOGICAL = ("vocab", "heads", "kv_heads", "mlp")


def _axis_sizes(config: TransformerConfig) -> dict:
    """Each logical axis' length on this config."""
    c = config
    return {"vocab": c.vocab_size, "embed": c.d_model, "heads": c.n_heads,
            "kv_heads": c.n_kv_heads, "head_dim": c.d_head, "mlp": c.d_ff,
            "layers": c.n_layers, "norm": c.d_model,
            "experts": getattr(c, "n_experts", 1)}


def check_mesh(config: TransformerConfig, mesh,
               rules: PartitionRules | None = None) -> None:
    """Raise unless the model can run on ``mesh`` under ``rules``: tp on
    exactly the vocab, heads, kv_heads and mlp axes (the model's tp
    collectives assume that layout), the stacked layer axis on pp when
    pp > 1 (a rank holds its stage's layers), and every sharded dim
    divisible: the layers by pp, an MoE's experts by ep. A dense model on
    an ep axis runs replicated over it, as in the reference (its batch
    is not sharded there)."""
    if mesh is None:
        return
    rules = rules or PartitionRules()
    size = functools.partial(comm.axis_size, mesh)
    mapping = dict(rules.rules)

    def axes_of(logical):
        return set(spec_axes(mapping.get(logical)))
    if size("tp") > 1:
        on_tp = {k for k in mapping if "tp" in axes_of(k)}
        if on_tp != set(_TP_LOGICAL):
            raise ValueError(f"the model's tp layout needs {_TP_LOGICAL} "
                             f"and only those on tp; the rules put "
                             f"{sorted(on_tp)} there")
    if size("pp") > 1 and axes_of("layers") != {"pp"}:
        raise ValueError(f"pp={size('pp')}: the rules must put the stacked "
                         f"'layers' axis on pp (pipeline_rules()); they put "
                         f"it on {sorted(axes_of('layers'))}")
    lengths = _axis_sizes(config)

    def divisible(node, path):
        for name, axes in node.items():
            if isinstance(axes, dict):
                divisible(axes, f"{path}{name}/")
                continue
            for ax in axes:
                if ax is None:
                    continue
                n = size(mapping[ax])
                if lengths[ax] % n:
                    raise ValueError(
                        f"{path}{name}: its {ax} axis of {lengths[ax]} does "
                        f"not divide over {mapping[ax]} ({n} ranks)")
    divisible(_logical_specs(config), "")


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


def _select_attention(config: TransformerConfig, device: torch.device,
                      mesh=None) -> str:
    if config.attention != "auto":
        kind = config.attention
    elif comm.axis_size(mesh, "sp") > 1:
        kind = "ring"
    else:
        kind = "flash" if device.type == "cuda" else "xla"
    if kind in ("xla", "flash") and comm.axis_size(mesh, "sp") > 1:
        raise ValueError(f"attention={kind!r} sees one sequence block; "
                         f"with sp > 1 use ring or ulysses")
    return kind


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over the tensors as given: the flash kernels on CUDA,
    the plain reference attention on the CPU."""
    if q.device.type == "cuda":
        from ..ops.attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, causal=causal)


@functools.lru_cache(maxsize=64)
def _layer_gathers(config: TransformerConfig, rules, mesh) -> dict:
    """Per block weight, the (dim, axes) each layer gathers before use:
    its sharded axes but tp and ep (the rank computes on its heads, mlp
    slice and experts), those of size above 1 (none on one rank)."""
    out = {}
    for name, spec in _layer_specs(config, rules).items():
        dims = [(d, live) for d, entry in enumerate(spec)
                if (live := tuple(a for a in spec_axes(entry)
                                  if a not in ("tp", "ep")
                                  and comm.axis_size(mesh, a) > 1))]
        if dims:
            out[name] = dims
    return out


def layer_weights(layer: dict, names, config: TransformerConfig, mesh,
                  rules: PartitionRules | None = None) -> dict:
    """The layer with its weights ``names`` as the rank computes with
    them: gathered over every sharded axis but tp and ep (the backward
    reduce-scatters their grads). Without a mesh, or with nothing to
    gather, the layer as it is."""
    if mesh is None:
        return layer
    gathers = _layer_gathers(config, rules, mesh)
    if not gathers:
        return layer
    out = dict(layer)
    for n in names:
        for dim, axes in gathers.get(n, ()):
            out[n] = comm.all_gather(out[n], mesh, axes, dim)
    return out


def attention_block(x, layer, config: TransformerConfig, cos, sin,
                    return_kv: bool = False, mesh=None,
                    rules: PartitionRules | None = None):
    """``return_kv=True`` also returns the post-RoPE, pre-GQA-repeat
    (k, v) — what a decode KV cache stores (models/decode.py prefill).
    On a mesh: the rank's heads (and under sp its sequence block)."""
    c = config
    layer = layer_weights(layer, ("attn_norm", "wq", "wk", "wv", "wo"), c,
                          mesh, rules)
    h = rms_norm(x, layer["attn_norm"])
    h = comm.copy_to(h, mesh, "tp")
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wq"], dt))
    k = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wk"], dt))
    v = torch.einsum("bsd,dhk->bshk", h, wcast(layer["wv"], dt))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv = (k, v)
    n_rep = c.n_heads // c.n_kv_heads
    kind = _select_attention(c, x.device, mesh)
    if kind == "ulysses":
        # takes the un-repeated K/V: its all-to-alls move 1/n_rep the bytes
        from ..parallel.ulysses import ulysses_attention
        out = ulysses_attention(q, k, v, mesh=mesh, causal=True,
                                n_rep=n_rep)
    else:
        kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        if kind == "ring":
            from ..parallel.ring import ring_attention
            out = ring_attention(q, kr, vr, mesh=mesh, causal=True)
        elif kind == "flash":
            from ..ops.attention import flash_attention
            out = flash_attention(q, kr, vr, causal=True)
        else:
            out = xla_attention(q, kr, vr, causal=True)
    y = torch.einsum("bshk,hkd->bsd", out, wcast(layer["wo"], dt))
    x = x + comm.reduce_from(y, mesh, "tp")
    return (x, kv) if return_kv else x


def mlp_block(x, layer, config: TransformerConfig, mesh=None,
              rules: PartitionRules | None = None):
    layer = layer_weights(layer, ("mlp_norm", "w_gate", "w_up", "w_down"),
                          config, mesh, rules)
    h = rms_norm(x, layer["mlp_norm"])
    h = comm.copy_to(h, mesh, "tp")
    dt = h.dtype
    gate = torch.einsum("bsd,df->bsf", h, wcast(layer["w_gate"], dt))
    up = torch.einsum("bsd,df->bsf", h, wcast(layer["w_up"], dt))
    y = torch.einsum("bsf,fd->bsd", F.silu(gate) * up,
                     wcast(layer["w_down"], dt))
    return x + comm.reduce_from(y, mesh, "tp")


def embed_tokens(params: dict, tokens: torch.Tensor,
                 config: TransformerConfig, mesh=None,
                 rules: PartitionRules | None = None) -> torch.Tensor:
    """The embedding lookup in compute dtype. Under tp the table is
    vocab-sharded: each rank looks up the tokens in its vocab slice
    (zeros elsewhere) and an all-reduce over tp sums the one nonzero."""
    embed = params["embed"]
    if mesh is not None:
        embed = gather_for_compute(embed, param_specs(config, rules)["embed"],
                                   mesh)
    w = embed.to(config.compute_dtype)
    if comm.axis_size(mesh, "tp") == 1:
        return w[tokens]
    rows = w.shape[0]
    local = tokens.long() - comm.axis_rank(mesh, "tp") * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], w[local.clamp(0, rows - 1)], 0.0)
    return comm.reduce_from(x.to(w.dtype), mesh, "tp")


def lm_head_weight(params: dict, config: TransformerConfig, mesh=None,
                   rules: PartitionRules | None = None):
    """The LM head as the rank computes with it: (d_model, vocab/tp)."""
    if mesh is None:
        return params["lm_head"]
    return gather_for_compute(params["lm_head"],
                              param_specs(config, rules)["lm_head"], mesh)


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
    from ..ops import attention  # noqa: F401 — registers the policy's op
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
                   positions: torch.Tensor | None = None, mesh=None,
                   rules: PartitionRules | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → final-norm hidden states (b, s, d); the
    LM head is not applied (the fused chunked CE, models/train.py, takes
    the hidden states). On a mesh, tokens are the rank's rows and
    sequence block; the positions default to the block's global ones."""
    c = config
    x = embed_tokens(params, tokens, c, mesh, rules)
    if positions is None:
        positions = block_positions(tokens, mesh).expand(tokens.shape)
    cos, sin = rope_frequencies(c, positions)
    body = _layer_body(c, cos, sin, mesh, rules)
    for layer in unstack_layers(params["blocks"]):
        x = body(x, layer)
    return rms_norm(x, params["final_norm"])


def block_positions(tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """(1, seq) positions of the rank's sequence block: offset by its sp
    index on a mesh."""
    s = tokens.shape[1]
    start = comm.axis_rank(mesh, "sp") * s
    return torch.arange(start, start + s, device=tokens.device)[None, :]


def _layer_body(c: TransformerConfig, cos, sin, mesh, rules):
    """``body(x, layer)``: one layer, attention then FFN, under the remat
    policies."""
    mlp = resolve_remat_mlp(
        c, lambda x, layer, c: mlp_block(x, layer, c, mesh, rules))
    return resolve_layer_remat(
        c, lambda x, layer: attention_block(x, layer, c, cos, sin,
                                            mesh=mesh, rules=rules),
        lambda x, layer: mlp(x, layer, c))


def pipelined_forward_hidden(params: dict, tokens: torch.Tensor,
                             config: TransformerConfig, mesh,
                             n_microbatches: int,
                             rules: PartitionRules | None = None):
    """``forward_hidden`` with the layer stack pipelined over ``pp``
    (parallel/pipeline.py): the embedding runs before the pipeline on
    every stage, the final norm after it. The stage body is the layer
    body on the stage's layers, the rank's local weights, with the fsdp
    gathers and tp collectives of ``layer_weights`` / ``attention_block``
    / ``mlp_block``; under sp it runs ring (or Ulysses) attention over
    sp with the RoPE tables of the rank's sequence block. The tables are
    (1, seq), shared by every microbatch, as in the reference."""
    from ..parallel.pipeline import pipeline_apply, split_stages
    c = config
    x = embed_tokens(params, tokens, c, mesh, rules)
    cos, sin = rope_frequencies(c, block_positions(tokens, mesh))
    body = _layer_body(c, cos, sin, mesh, rules)

    def stage_fn(stage_layers, act):
        for layer in unstack_layers(stage_layers):
            act = body(act, layer)
        return act

    x = pipeline_apply(split_stages(params["blocks"], 1), x, stage_fn,
                       mesh=mesh, n_microbatches=n_microbatches)
    return rms_norm(x, params["final_norm"])


def pipelined_forward(params: dict, tokens: torch.Tensor,
                      config: TransformerConfig, mesh, n_microbatches: int,
                      rules: PartitionRules | None = None) -> torch.Tensor:
    """``forward`` with the layer stack pipelined over ``pp``: logits
    (batch, seq, vocab) float32 of the rank's rows and sequence block,
    every vocab column, on every pp rank."""
    x = pipelined_forward_hidden(params, tokens, config, mesh,
                                 n_microbatches, rules)
    return _full_logits(params, x, config, mesh, rules)


def lm_head_logits(x: torch.Tensor, lm_head) -> torch.Tensor:
    """(b, s, d) hidden → (b, s, vocab) f32 logits (the rank's vocab slice
    under tp)."""
    return torch.einsum("bsd,dv->bsv", x, wcast(lm_head, x.dtype)).float()


def forward(params: dict, tokens: torch.Tensor, config: TransformerConfig,
            positions: torch.Tensor | None = None, mesh=None,
            rules: PartitionRules | None = None) -> torch.Tensor:
    """tokens: (batch, seq) int → logits (batch, seq, vocab) float32 (on
    a mesh: the rank's rows and sequence block, every vocab column)."""
    x = forward_hidden(params, tokens, config, positions=positions,
                       mesh=mesh, rules=rules)
    return _full_logits(params, x, config, mesh, rules)


def _full_logits(params, x, config, mesh, rules) -> torch.Tensor:
    """The LM head on hidden states: every vocab column (gathered over
    tp)."""
    x = comm.copy_to(x, mesh, "tp")
    logits = lm_head_logits(x, lm_head_weight(params, config, mesh, rules))
    return comm.gather_replicated(logits, mesh, "tp", dim=-1)


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
