"""The port's speculative decoding (kubeflow_tpu_torch/models/
speculative.py) against the JAX package's on the CPU, mirroring
tests/test_speculative.py case by case on the same converted params.

Config: a two-layer target (d_model 64) and a one-layer draft (d_model
32), vocab 128, float32, JAX params carried across with convert.py.
Greedy ids must be token-identical to JAX ``speculative_generate``, JAX
``generate`` and the port's ``generate``, and ``SpecStats`` (blocks, and
drafted and accepted per row) exactly equal to JAX's. Sampled rows draw
from another RNG than JAX's, so they are held to the target distribution:
the first two tokens' marginals over 4096 rows at temperature 1 against
the exact ones, with the reference's total-variation bound calibrated
against an unbiased sampler.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import speculative as js
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.models.quant import quantize_params as jax_quantize
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import decode as td
from kubeflow_tpu_torch.models import speculative as ts
from kubeflow_tpu_torch.models import transformer as tt

V = 128


def _cfg(n_layers=2, d_model=64):
    return jt.TransformerConfig(vocab_size=V, d_model=d_model,
                                n_layers=n_layers, n_heads=4, n_kv_heads=2,
                                d_ff=d_model * 2, max_seq_len=128,
                                dtype="float32")


def _port(jc):
    return tt.TransformerConfig(**dataclasses.asdict(jc))


def _pair(jp, jc):
    """(JAX params, port params, JAX config, port config)."""
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp)), jc, _port(jc)


def _noisy(jp, sigma, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: p + jnp.asarray(
        sigma * rng.standard_normal(p.shape), p.dtype), jp)


@pytest.fixture(scope="module")
def target():
    jc = _cfg()
    return _pair(jax.jit(jt.init_params, static_argnums=1)(
        jax.random.key(0), jc), jc)


@pytest.fixture(scope="module")
def draft():
    jc = _cfg(n_layers=1, d_model=32)
    return _pair(jax.jit(jt.init_params, static_argnums=1)(
        jax.random.key(7), jc), jc)


@pytest.fixture(scope="module")
def noisy(target):
    """The target plus small noise: agrees on most argmaxes, not all."""
    return _pair(_noisy(target[0], 0.02, seed=3), target[2])


def _prompt(batch=3, length=9, seed=1):
    return np.random.default_rng(seed).integers(0, V, (batch, length)) \
        .astype(np.int32)


def _both(tgt, drf, prompt, n, **kw):
    """(port ids, port stats, JAX ids, JAX stats) of the same call."""
    jp, tp, jc, tc = tgt
    jdp, tdp, jdc, tdc = drf
    got, stats = ts.speculative_generate(tp, tdp, torch.from_numpy(prompt),
                                         tc, tdc, n, **kw)
    want, jstats = js.speculative_generate(jp, jdp, jnp.asarray(prompt), jc,
                                           jdc, n, **kw)
    return got.numpy(), stats, np.asarray(want), jstats


def _assert_stats_equal(stats, jstats):
    assert stats.blocks == int(jstats.blocks)
    np.testing.assert_array_equal(stats.drafted.numpy(),
                                  np.asarray(jstats.drafted))
    np.testing.assert_array_equal(stats.accepted.numpy(),
                                  np.asarray(jstats.accepted))


def _jax_generate(tgt, prompt, n, **kw):
    jp, _, jc, _ = tgt
    return np.asarray(jd.generate(jp, jnp.asarray(prompt), jc, n, **kw))


def _port_generate(tgt, prompt, n, **kw):
    _, tp, _, tc = tgt
    return td.generate(tp, torch.from_numpy(prompt), tc, n, **kw).numpy()


# ------------------------------------------------------------------ greedy
def test_self_draft_accepts_everything_and_matches_generate(target):
    prompt = _prompt()
    got, stats, want, jstats = _both(target, target, prompt, 24, k=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_generate(target, prompt, 24))
    np.testing.assert_array_equal(got, _port_generate(target, prompt, 24))
    assert int(stats.accepted.sum()) == int(stats.drafted.sum()) > 0
    assert stats.blocks <= -(-24 // 5) + 1
    _assert_stats_equal(stats, jstats)


def test_different_draft_matches_jax_speculative_and_generate(target,
                                                              draft):
    prompt = _prompt()
    got, stats, want, jstats = _both(target, draft, prompt, 24, k=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_generate(target, prompt, 24))
    _assert_stats_equal(stats, jstats)
    assert stats.blocks >= -(-24 // 4)


def test_partial_acceptance_path(target, noisy):
    """Blocks end mid-window: the bonus-after-partial-match indexing and
    the overwrite of stale cache rows run (a random draft accepts ~0, a
    self-draft everything)."""
    prompt = _prompt()
    got, stats, want, jstats = _both(target, noisy, prompt, 32, k=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_generate(target, prompt, 32))
    _assert_stats_equal(stats, jstats)
    assert 0 < int(stats.accepted.sum()) < int(stats.drafted.sum()), stats


def test_eos_contract_matches_generate(target, draft):
    prompt = _prompt()
    eos = int(_port_generate(target, prompt, 24)[0, 4])  # row 0 stops early
    got, stats, want, jstats = _both(target, draft, prompt, 24, k=3,
                                     eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_generate(target, prompt, 24, eos_id=eos, pad_id=0))
    np.testing.assert_array_equal(
        got, _port_generate(target, prompt, 24, eos_id=eos, pad_id=0))
    assert (got[0, 5:] == 0).all()
    _assert_stats_equal(stats, jstats)


def test_mixed_greedy_and_sampled_rows(target, draft):
    """Per-row temperatures in one batch: the greedy rows equal generate's
    stream while sampled rows ride along inside the vocab."""
    _, tp, _, tc = target
    _, tdp, _, tdc = draft
    prompt = _prompt(4, 9)
    got, _ = ts.speculative_generate(
        tp, tdp, torch.from_numpy(prompt), tc, tdc, 20, k=3,
        temperature=[0.0, 1.0, 0.0, 0.7],
        generator=torch.Generator().manual_seed(5))
    got = got.numpy()
    want = _jax_generate(target, prompt, 20)
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    assert ((got >= 0) & (got < V)).all()
    assert not (got[[1, 3]] == want[[1, 3]]).all()


def test_shape_validation(target, draft):
    _, tp, _, tc = target
    _, tdp, _, tdc = draft
    for bad, match in (((_prompt(1, 100), 40, 4), "max_seq_len"),
                       ((_prompt(), 8, 0), "k must")):
        prompt, n, k = bad
        with pytest.raises(ValueError, match=match) as port_err:
            ts.speculative_generate(tp, tdp, torch.from_numpy(prompt), tc,
                                    tdc, n, k=k)
        with pytest.raises(ValueError, match=match) as jax_err:
            js.speculative_generate(target[0], draft[0],
                                    jnp.asarray(prompt), target[2],
                                    draft[2], n, k=k)
        assert str(port_err.value) == str(jax_err.value)


def test_int8_weights_target_matches(target, draft):
    """An int8 weight-only target (JAX's eager quantize_params, carried
    across) verified through decode_window equals generate on the same
    quantized tree, in both packages."""
    q = _pair(jax_quantize(target[0]), target[2])
    prompt = _prompt()
    got, stats, want, jstats = _both(q, draft, prompt, 16, k=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_generate(q, prompt, 16))
    np.testing.assert_array_equal(got, _jax_generate(q, prompt, 16))
    _assert_stats_equal(stats, jstats)


def test_int8_kv_target_matches(target, draft):
    """An int8 KV target cache (the window quantizes its writes as
    decode_step does): greedy ids equal generate(kv_quant=True)."""
    prompt = _prompt()
    got, stats, want, jstats = _both(target, draft, prompt, 16, k=3,
                                     kv_quant=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _port_generate(target, prompt, 16, kv_quant=True))
    np.testing.assert_array_equal(
        got, _jax_generate(target, prompt, 16, kv_quant=True))
    _assert_stats_equal(stats, jstats)


# ----------------------------------------------------------------- sampled
def test_sampled_marginals_match_the_target_distribution(target):
    """The accept/reject rule as a distribution: at temperature 1 with a
    mismatched draft (real rejections), the first two tokens' marginals
    over 4096 rows equal exact target sampling — first token
    softmax(prefill logits), second p0 @ P1 over every first token."""
    jp, tp, jc, tc = target
    B = 4096
    prompt_row = _prompt(1, 5, seed=2)
    far = _pair(_noisy(jp, 0.5, seed=11), jc)
    got, stats = ts.speculative_generate(
        tp, far[1], torch.from_numpy(np.tile(prompt_row, (B, 1))), tc, tc,
        2, k=1, temperature=1.0, generator=torch.Generator().manual_seed(42))
    got = got.numpy()

    logits0, _ = jd.prefill(jp, jnp.asarray(prompt_row), jc)
    p0 = np.asarray(jax.nn.softmax(logits0[0]), np.float64)
    _, cache_v = jd.prefill(jp, jnp.tile(jnp.asarray(prompt_row), (V, 1)),
                            jc)
    step_logits, _ = jd.decode_step(jp, cache_v,
                                    jnp.arange(V, dtype=jnp.int32), 5, jc)
    p1 = p0 @ np.asarray(jax.nn.softmax(step_logits, axis=-1), np.float64)

    rng = np.random.default_rng(0)
    for pos, want in ((0, p0), (1, p1)):
        want = want / want.sum()
        emp = np.bincount(got[:, pos], minlength=V) / B
        tv = 0.5 * np.abs(emp - want).sum()
        ref = np.bincount(rng.choice(V, B, p=want), minlength=V) / B
        ref_tv = 0.5 * np.abs(ref - want).sum()
        assert tv < 1.6 * ref_tv + 0.01, \
            f"pos {pos}: TV {tv:.3f} vs unbiased-sampler TV {ref_tv:.3f}"
    assert int(stats.accepted.sum()) < int(stats.drafted.sum())


def test_sampled_self_draft_accepts_nearly_everything(target):
    """draft == target at temperature 1: p/q is 1 up to the two forward
    paths' float noise, so acceptance is ~total."""
    _, tp, _, tc = target
    _, stats = ts.speculative_generate(
        tp, tp, torch.from_numpy(_prompt()), tc, tc, 24, k=4,
        temperature=1.0, generator=torch.Generator().manual_seed(3))
    assert int(stats.accepted.sum()) >= 0.95 * int(stats.drafted.sum())


def test_scaled_probs_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, V)).astype(np.float32)
    temp = np.asarray([0.0, 0.5, 2.0], np.float32)
    got = ts._scaled_probs(torch.from_numpy(logits), torch.from_numpy(temp))
    want = js._scaled_probs(jnp.asarray(logits), jnp.asarray(temp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
