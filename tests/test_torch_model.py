"""The port's model code (kubeflow_tpu_torch/models, convert.py) against the
JAX package on the same params and inputs.

Config: the tiny flagship (``__graft_entry__._flagship_config(tiny=True)``:
d_model 64, 4 layers, 4 heads of 16, 2 KV heads, d_ff 128, vocab 512,
max_seq_len 128), float32 unless a test says otherwise. The JAX params are
made once and carried across with convert.py — never two separate inits.
The JAX side runs its Pallas kernels in interpret mode
(``attention="flash"``, ``decode_attention="flash"``); the port on the CPU
runs their plain versions. Tolerances: logits 3e-5 (the reference's
decode pin, tests/test_decode_attention.py); tokens and int8 values exact.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import quant as jq
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import decode as td
from kubeflow_tpu_torch.models import quant as tq
from kubeflow_tpu_torch.models import transformer as tt

LOGITS_TOL = 3e-5
TINY = dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")


def _configs(**kw):
    jc = jt.TransformerConfig(**{**TINY, "attention": "flash",
                                 "decode_attention": "flash", **kw})
    return jc, tt.TransformerConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0),
                                                   _configs()[0])
    np_params = jax.tree.map(np.asarray, jp)
    return jp, convert.to_torch(np_params), np_params


@pytest.fixture(scope="module")
def jax_quantized(params):
    # eager, as the JAX serving engine calls it: under jit XLA may turn
    # the /127 into a multiply by its reciprocal and move the last bit
    return jq.quantize_params(params[0])


@pytest.fixture(scope="module")
def jax_prefill(params, prompt):
    """JAX prefill (logits, cache) per kv_quant, computed once."""
    memo = {}

    def get(kv_quant):
        if kv_quant not in memo:
            memo[kv_quant] = jax.jit(jd.prefill, static_argnums=(2, 3))(
                params[0], jnp.asarray(prompt), _configs()[0], kv_quant)
        return memo[kv_quant]
    return get


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, TINY["vocab_size"],
                                             (2, 12)).astype(np.int32)


def _close(got, want, tol=LOGITS_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- convert
def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_trees_equal(a[key], b[key])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["plain", "quantized", "bfloat16"])
def test_convert_round_trip_is_exact(params, jax_quantized, kind):
    jp, _, np_params = params
    if kind == "quantized":
        np_params = jax.tree.map(np.asarray, jax_quantized)
    elif kind == "bfloat16":
        np_params = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    tp = convert.to_torch(np_params)
    if kind == "bfloat16":
        assert tp["embed"].dtype == torch.bfloat16
    _assert_trees_equal(convert.to_numpy(tp), np_params)


def test_quantize_params_matches_jax_exactly(params, jax_quantized):
    """Same int8 values and scales: symmetric per-output-channel, scales
    keep the reduced dims (``wo`` reduces axes (1, 2))."""
    _, tp, _ = params
    want = jax.tree.map(np.asarray, jax_quantized)
    got = convert.to_numpy(tq.quantize_params(tp))
    _assert_trees_equal(got, want)
    assert got["blocks"]["wo"]["s"].shape == (TINY["n_layers"], 1, 1,
                                              TINY["d_model"])


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_forward_logits_match(params, prompt, attention):
    jp, tp, _ = params
    jc, tc = _configs(attention=attention)
    want = jax.jit(jt.forward, static_argnums=2)(jp, jnp.asarray(prompt), jc)
    got = tt.forward(tp, torch.from_numpy(prompt).long(), tc)
    _close(got.numpy(), want)


def test_rope_and_rms_norm_match(params):
    jc, tc = _configs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    jcos, jsin = jt.rope_frequencies(jc, jnp.asarray(pos))
    tcos, tsin = tt.rope_frequencies(tc, torch.from_numpy(pos))
    _close(tcos.numpy(), jcos, 1e-6)
    got = tt.apply_rope(torch.from_numpy(x), tcos, tsin)
    _close(got.numpy(), jt.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)
    h = rng.standard_normal((2, 5, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    _close(tt.rms_norm(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
           jt.rms_norm(jnp.asarray(h), jnp.asarray(w)), 1e-6)


# ------------------------------------------------------------- prefill
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_logits_and_cache_match(params, prompt, jax_prefill,
                                        kv_quant):
    _, tp, _ = params
    _, tc = _configs()
    jl, jcache = jax_prefill(kv_quant)
    tl, tcache = td.prefill(tp, torch.from_numpy(prompt).long(), tc,
                            kv_quant=kv_quant)
    _close(tl.numpy(), jl)
    assert set(tcache) == set(jcache)
    if not kv_quant:
        for name in ("k", "v"):
            _close(tcache[name].numpy(), jcache[name])
        return
    for name in ("k_scale", "v_scale"):
        _close(tcache[name].numpy(), jcache[name], 1e-6)
    for name in ("k", "v"):
        got = tcache[name].numpy().astype(np.int32)
        want = np.asarray(jcache[name]).astype(np.int32)
        assert tcache[name].dtype == torch.int8
        # the same f32 inputs to 1e-6: a value exactly at a rounding
        # boundary may land one step apart, no more and almost never
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() < 1e-3


def test_prefill_bfloat16_cache(params, prompt):
    """bf16 activations: the two frameworks round at different places in
    the matmuls, so agreement is bf16-grade (5e-2 on logits of size ~5,
    4e-2 on the cache), and the cache is bf16 on both sides."""
    jp, tp, _ = params
    jc, tc = _configs(dtype="bfloat16")
    jl, jcache = jax.jit(jd.prefill, static_argnums=2)(
        jp, jnp.asarray(prompt), jc)
    tl, tcache = td.prefill(tp, torch.from_numpy(prompt).long(), tc)
    assert tcache["k"].dtype == torch.bfloat16
    _close(tl.numpy(), jl, 5e-2)
    for name in ("k", "v"):
        _close(tcache[name].float().numpy(),
               np.asarray(jcache[name], np.float32), 4e-2)


# --------------------------------------------------------- decode step
@pytest.mark.parametrize("decode_attention,per_row,kv_quant", [
    ("flash", False, False), ("flash", True, True), ("xla", True, False)])
def test_decode_step_logits_match(params, prompt, jax_prefill,
                                  decode_attention, per_row, kv_quant):
    """Scalar pos (all rows at one depth) and per-row pos, through the
    flash-decode kernel and the einsum path, with an f32 or an int8 cache."""
    jp, tp, _ = params
    jc, tc = _configs(decode_attention=decode_attention)
    _, jcache = jax_prefill(kv_quant)
    _, tcache = td.prefill(tp, torch.from_numpy(prompt).long(), tc,
                           kv_quant=kv_quant)
    tok = np.asarray([3, 9], np.int32)
    pos = np.asarray([12, 7], np.int32) if per_row else 12
    jl, jcache = jax.jit(jd.decode_step, static_argnums=4)(
        jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tcache = td.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                torch.as_tensor(pos) if per_row else pos, tc)
    _close(tl.numpy(), jl)
    if not kv_quant:
        _close(tcache["k"].numpy(), jcache["k"])


# ------------------------------------------------------------ sampling
def test_top_k_top_p_mask_matches_exactly():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 512), dtype=np.float32) * 3
    top_k = np.asarray([0, 1, 5, 50], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.95], np.float32)
    want = np.asarray(jd.top_k_top_p_mask(*map(jnp.asarray,
                                                (logits, top_k, top_p))))
    got = td.top_k_top_p_mask(*map(torch.from_numpy,
                                   (logits, top_k, top_p))).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_tokens_follow_the_filtered_distribution():
    """The RNGs differ, so sampling is checked by distribution: many
    draws from fixed logits against the softmax of the temperature-scaled
    logits cut to the top-k and the nucleus, computed here in numpy
    (chi-square at p=1e-4), and no draw outside the kept set."""
    n, temp, top_k, top_p = 20000, 0.8, 5, 0.9
    logits = np.asarray([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0],
                        np.float32)
    scaled = logits / temp                      # already sorted, descending
    p_all = np.exp(scaled - scaled.max())
    p_all /= p_all.sum()
    mass_before = np.cumsum(p_all) - p_all
    kept = (np.arange(logits.size) < top_k) & (mass_before < top_p)
    probs = p_all[kept] / p_all[kept].sum()
    rows = torch.from_numpy(np.tile(logits, (n, 1)))
    g = torch.Generator().manual_seed(0)
    toks = td.sample_token(rows, g, torch.full((n,), temp),
                           torch.full((n,), top_k, dtype=torch.int32),
                           torch.full((n,), top_p)).numpy()
    counts = np.bincount(toks, minlength=logits.size)
    assert counts[~kept].sum() == 0
    expected = probs * n
    stat = ((counts[kept] - expected) ** 2 / expected).sum()
    assert kept.sum() == 4         # the nucleus cuts inside the top 5
    assert stat < 21.1075          # chi-square, 3 dof, 1 - 1e-4 quantile


# ------------------------------------------------------------ generate
@pytest.mark.parametrize("variant", ["plain", "eos", "kv_quant",
                                     "int8_weights"])
def test_greedy_generate_is_token_identical(params, jax_quantized, prompt,
                                            variant):
    jp, tp, _ = params
    jc, tc = _configs()
    kw = {}
    if variant == "eos":
        # an id the plain run emits mid-sequence in row 0, so the rows
        # after it are padded and the other row runs on
        plain = td.generate(tp, torch.from_numpy(prompt).long(), tc, 8)
        kw = dict(eos_id=int(plain[0, 3]), pad_id=1)
    elif variant == "kv_quant":
        kw = dict(kv_quant=True)
    elif variant == "int8_weights":
        jp, tp = jax_quantized, tq.quantize_params(tp)
    want = np.asarray(jd.generate(jp, jnp.asarray(prompt), jc, 8, **kw))
    got = td.generate(tp, torch.from_numpy(prompt).long(), tc, 8, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    if variant == "eos":
        assert (got[0, 4:] == 1).all()
