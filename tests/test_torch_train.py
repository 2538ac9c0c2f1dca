"""The port's train path (kubeflow_tpu_torch models/train.py,
runtime/data.py, runtime/trainer.py, the model's backward) against the
JAX package on the same params, batches and optimizer states.

Config: the tiny flagship (``__graft_entry__._flagship_config(tiny=True)``:
d_model 64, 4 layers, 4 heads of 16, 2 KV heads, d_ff 128, vocab 512),
float32. JAX params and optimizer states are carried across with
convert.py — never two separate inits. Where the JAX side reaches its
Pallas flash kernels it runs them in interpret mode
(``attention="flash"``); the port on the CPU runs their plain versions.

Tolerances: rms_norm grads 1e-5; model grads through flash 5e-4 (the
reference's own pin, tests/test_ops.py); losses 1e-5; the optimizer 1e-5
relative (tests/test_fused_adamw.py); 3-step trajectories 1e-5 on losses
and 2e-6 on f32 params (Adam moves each weight by at most ~lr per step,
3e-4, so summation-order noise in the grads stays far below that);
remat policies against no remat 1e-6 (same ops, same order).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime import data as jdata
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.runtime import data as tdata
from kubeflow_tpu_torch.runtime.trainer import Trainer

TINY = dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
GRAD_TOL = 5e-4
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6


def _configs(**kw):
    jc = jt.TransformerConfig(**{**TINY, **kw})
    return jc, tt.TransformerConfig(**dataclasses.asdict(jc))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    """Leaves in jax.tree.leaves order (both sort dict keys)."""
    return [x.detach().float().numpy() for x in ttr.tree_leaves(tree)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _trees_close(got_torch, want_jax, tol):
    got, want = _t_leaves(got_torch), _leaves(want_jax)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)


def _batch(b=2, s=32, seed=1, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY["vocab_size"], (b, s)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[rng.random((b, s)) < pad_frac] = -1
    return tokens, targets


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the tiny shapes gain nothing
    from more, and the suite runs in parallel workers beside
    timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0),
                                                   _configs()[0])
    return jp, jax.tree.map(np.asarray, jp)


def _trainable(np_params):
    return ttr.tree_map(lambda p: p.requires_grad_(),
                        convert.to_torch(np_params))


# ---------------------------------------------------------------- rms_norm
def test_rms_norm_grads_match_the_custom_vjp_and_save_only_x_w_inv():
    rng = np.random.default_rng(2)
    x, g = (rng.standard_normal((2, 5, 64), dtype=np.float32)
            for _ in range(2))
    w = rng.standard_normal((64,), dtype=np.float32)
    y, vjp = jax.vjp(jt.rms_norm, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        yt = tt.rms_norm(xt, wt)
    got = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))
    _close(yt.detach().numpy(), y, 1e-5)
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-5)
    assert [tuple(t.shape) for t in saved] == [(2, 5, 64), (64,), (2, 5, 1)]


# ------------------------------------------------------------- model grads
@pytest.fixture(scope="module")
def model_grads(params):
    """d(sum of logits)/d(params) through flash: JAX's Pallas backward in
    interpret mode, and the port's remat=False grads."""
    jp, np_params = params
    tokens = _batch()[0]
    jc, tc = _configs(attention="flash")
    want = jax.jit(jax.grad(lambda p: jt.forward(
        p, jnp.asarray(tokens), jc).sum()))(jp)

    def port(remat):
        tp = _trainable(np_params)
        loss = tt.forward(tp, torch.from_numpy(tokens),
                          tc.replace(remat=remat)).sum()
        return ttr.tree_unflatten(tp, torch.autograd.grad(
            loss, ttr.tree_leaves(tp)))
    return want, port(False), port


def test_model_grads_through_flash_match_jax_grad(model_grads):
    want, got, _ = model_grads
    _trees_close(got, want, GRAD_TOL)


@pytest.mark.parametrize("remat", [True, "mlp", "attn"])
def test_remat_changes_no_grad(model_grads, remat):
    _, base, port = model_grads
    for a, b in zip(_t_leaves(port(remat)), _t_leaves(base)):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("remat,forwards_per_layer",
                         [(False, 1), ("mlp", 1), ("attn", 1), (True, 2)])
def test_remat_replays_or_reruns_the_flash_forward(params, monkeypatch,
                                                   remat,
                                                   forwards_per_layer):
    """The flash forward runs once per layer in the forward; under
    remat=True the backward runs it again, under "attn" it replays the
    saved (out, lse) — the CPU counterpart of the launch counts that
    chip_smoke.py checks on the card."""
    from kubeflow_tpu_torch.ops import attention as tattn
    _, np_params = params
    calls = []
    plain = tattn.flash_attention_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(tattn, "flash_attention_plain", counted)
    tp = _trainable(np_params)
    _, tc = _configs(attention="flash", remat=remat)
    loss = tt.forward(tp, torch.from_numpy(_batch()[0]), tc).sum()
    assert len(calls) == TINY["n_layers"]
    torch.autograd.grad(loss, ttr.tree_leaves(tp))
    assert len(calls) == forwards_per_layer * TINY["n_layers"]


def test_stacked_weights_unbind_once_per_forward(params):
    """The (L, ...) weights are taken apart by one unbind each, so the
    backward stacks the layer grads in one op rather than summing a zero
    (L, ...) tensor per layer."""
    _, np_params = params
    tp = _trainable(np_params)
    _, tc = _configs()
    loss = tt.forward(tp, torch.from_numpy(_batch()[0]), tc).sum()
    seen, stack = set(), [loss.grad_fn]
    names = []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert names.count("UnbindBackward0") == len(np_params["blocks"])
    assert "SelectBackward0" not in names


def test_model_flops_per_token_matches():
    jc, tc = _configs()
    assert tt.model_flops_per_token(tc) == jt.model_flops_per_token(jc)


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("chunk", [0, 8, 12, 32])
def test_loss_and_fused_loss_match_jax(params, chunk):
    """-1 targets included; chunk 0 is loss_fn, the others fused_loss_fn
    (12 does not divide 32: _ce_chunks rounds the count up to 4)."""
    jp, np_params = params
    jc, tc = _configs()
    tokens, targets = _batch()
    tp = convert.to_torch(np_params)
    args_j = (jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    args_t = (tp, torch.from_numpy(tokens), torch.from_numpy(targets), tc)
    if chunk:
        want = jtr.fused_loss_fn(*args_j, chunk_tokens=chunk)
        got = ttr.fused_loss_fn(*args_t, chunk_tokens=chunk)
    else:
        want, got = jtr.loss_fn(*args_j), ttr.loss_fn(*args_t)
    _close(got.item(), want, LOSS_TOL)


def test_fused_loss_grads_match_whole_logits(params):
    _, np_params = params
    _, tc = _configs()
    tokens, targets = map(torch.from_numpy, _batch())
    grads = []
    for loss in (lambda p: ttr.loss_fn(p, tokens, targets, tc),
                 lambda p: ttr.fused_loss_fn(p, tokens, targets, tc, 8)):
        tp = _trainable(np_params)
        grads.append(torch.autograd.grad(loss(tp), ttr.tree_leaves(tp)))
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("seq_len,chunk", [(32, 8), (32, 12), (96, 48),
                                           (1024, 512), (100, 7), (7, 512)])
def test_ce_chunks_match(seq_len, chunk):
    assert ttr._ce_chunks(seq_len, chunk) == jtr._ce_chunks(seq_len, chunk)


@pytest.mark.parametrize("shape", [(2, 96), (8, 1024), (4, 8192),
                                   (32, 2048)])
def test_ce_chunk_for_follows_the_same_policy(monkeypatch, shape):
    """Same rule as the reference's; the threshold is each package's own
    measured constant, so the policy is compared at the reference's."""
    monkeypatch.setattr(ttr, "CE_FUSE_THRESHOLD_BYTES",
                        jtr.CE_FUSE_THRESHOLD_BYTES)
    tokens = np.zeros(shape, np.int32)
    for chunk in (0, 512):
        want = jtr.ce_chunk_for(jtr.TrainConfig(ce_chunk_tokens=chunk),
                                tokens, 32_000)
        got = ttr.ce_chunk_for(ttr.TrainConfig(ce_chunk_tokens=chunk),
                               torch.from_numpy(tokens), 32_000)
        assert got == want


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup", [100, 2])
def test_schedule_matches_optax(warmup):
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, 10_000)
    steps = np.arange(301)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(steps)))
    got = [ttr.warmup_cosine_decay(int(s), 3e-4, warmup) for s in steps]
    # optax evaluates in f32, the port on host floats: a few f32 ulps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16), dtype=np.float32) * scale,
            "b": rng.standard_normal((16,), dtype=np.float32) * scale,
            "blocks": {"deep": rng.standard_normal((4, 8, 8),
                                                   dtype=np.float32) * scale}}


@pytest.mark.parametrize("grad_scale", [0.01, 50.0])  # 50: clip engages
def test_fused_clip_adamw_matches_optax_chain_and_jax_fused(grad_scale):
    tc = jtr.TrainConfig(warmup_steps=2)
    refs = {"chain": jtr.make_optimizer(tc),
            "fused": jtr.make_optimizer(dataclasses.replace(
                tc, fused_adamw=True))}
    port = ttr.make_optimizer(ttr.TrainConfig(warmup_steps=2))
    params = _np_tree(0)
    states = {k: opt.init(jax.tree.map(jnp.asarray, params))
              for k, opt in refs.items()}
    p_ref = {k: jax.tree.map(jnp.asarray, params) for k in refs}
    p_t = convert.to_torch(params)
    s_t = port.init(p_t)
    for step in range(5):
        grads = _np_tree(10 + step, grad_scale)
        u_t, s_t = port.update(convert.to_torch(grads), s_t, p_t)
        for k, opt in refs.items():
            u, states[k] = opt.update(jax.tree.map(jnp.asarray, grads),
                                      states[k], p_ref[k])
            p_ref[k] = optax.apply_updates(p_ref[k], u)
            for a, b in zip(_t_leaves(u_t), _leaves(u)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
        p_t = jax.tree.map(lambda p, u: p + u, p_t, u_t)
    for p in p_ref.values():
        for a, b in zip(_t_leaves(p_t), _leaves(p)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
    assert s_t.count == 5


def test_fused_clip_adamw_requires_params():
    opt = ttr.make_optimizer(ttr.TrainConfig())
    p = convert.to_torch(_np_tree(0))
    with pytest.raises(ValueError, match="params"):
        opt.update(p, opt.init(p), None)


# ------------------------------------------------------------ trajectories
@pytest.fixture(scope="module")
def jax_steps():
    """The reference's jitted (init_fn, step_fn) on a 1-device CPU mesh,
    built once per (bf16_params, fused_adamw, accum_steps)."""
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    memo = {}

    def get(bf16, fused, accum):
        key = (bf16, fused, accum)
        if key not in memo:
            tc = jtr.TrainConfig(warmup_steps=2, bf16_params=bf16,
                                 fused_adamw=fused)
            memo[key] = jtr.make_sharded_train_step(
                mesh, _configs()[0], tc, accum_steps=accum)
        return memo[key]
    return get


def _batches(n, accum):
    out = []
    for i in range(n):
        tokens, targets = _batch(b=4, s=16, seed=20 + i)
        if accum > 1:
            tokens, targets = (x.reshape(accum, 4 // accum, 16)
                               for x in (tokens, targets))
        out.append((tokens, targets))
    return out


def _run_jax(step_fn, params, opt, batches):
    losses = []
    for tokens, targets in batches:
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens),
                                    jnp.asarray(targets))
        losses.append(float(loss))
    return params, opt, losses


def _run_port(step_fn, params, opt, batches):
    losses = []
    for tokens, targets in batches:
        params, opt, loss = step_fn(params, opt, torch.from_numpy(tokens),
                                    torch.from_numpy(targets))
        losses.append(loss.item())
    return params, opt, losses


@pytest.mark.parametrize("bf16,accum", [(False, 1), (True, 1), (False, 2)])
def test_three_step_trajectory_matches_sharded_step(jax_steps, bf16, accum):
    """Loss per step and params after 3 steps (warmup 2) against
    make_sharded_train_step from the same init. bf16 params: the f32
    masters are compared (the bf16 params are their rounding), and the
    forward reads bf16 weights, so losses agree to 1e-4."""
    init_fn, step_fn = jax_steps(bf16, False, accum)
    jp, jo = init_fn(jax.random.key(0))
    start = jo.master if bf16 else jp
    tc = ttr.TrainConfig(warmup_steps=2, bf16_params=bf16)
    _, port_step = ttr.make_train_step(_configs()[1], tc, "cpu", accum)
    tp, to = ttr.init_train_state(
        convert.to_torch(jax.tree.map(np.asarray, start)), tc)
    batches = _batches(3, accum)
    jp, jo, want = _run_jax(step_fn, jp, jo, batches)
    tp, to, got = _run_port(port_step, tp, to, batches)
    _close(got, want, 1e-4 if bf16 else LOSS_TOL)
    if bf16:
        assert all(p.dtype == torch.bfloat16 for p in ttr.tree_leaves(tp))
        _trees_close(to.master, jo.master, PARAM_TOL)
        for p, m in zip(ttr.tree_leaves(tp), ttr.tree_leaves(to.master)):
            assert torch.equal(p.detach(), m.to(torch.bfloat16))
    else:
        _trees_close(tp, jp, PARAM_TOL)
        # the optax chain's state carries across: same count and moments
        moved = convert.opt_state_to_torch(jax.tree.map(np.asarray, jo))
        assert moved.count == to.count == 3
        for a, b in zip(_t_leaves(moved.mu), _t_leaves(to.mu)):
            _close(a, b, 1e-6)


def test_trajectory_from_a_converted_mid_run_state(jax_steps, params):
    """Both packages continue one run from the same step-150 optimizer
    state (the fused form's, converted with opt_state_to_torch): lr from
    the cosine part of the schedule, bias correction at count 151+."""
    init_fn, step_fn = jax_steps(False, True, 1)
    jp, _ = init_fn(jax.random.key(0))
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3)
                      .astype(np.float32), jp)
    # a second moment of a run that has seen grads: no entry near 0
    nu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3)
                      .astype(np.float32) ** 2 + np.float32(1e-6), jp)
    state = jtr.FusedAdamWState(count=np.int32(150), mu=mu, nu=nu)
    tc = ttr.TrainConfig(warmup_steps=2, fused_adamw=True)
    tp, _ = ttr.init_train_state(
        convert.to_torch(jax.tree.map(np.asarray, jp)), tc)
    to = convert.opt_state_to_torch(state)
    assert to.count == 150
    _, port_step = ttr.make_train_step(_configs()[1], tc, "cpu")
    batches = _batches(3, 1)
    jp, jo, want = _run_jax(step_fn, jp, jax.tree.map(jnp.asarray, state),
                            batches)
    tp, to, got = _run_port(port_step, tp, to, batches)
    _close(got, want, LOSS_TOL)
    _trees_close(tp, jp, PARAM_TOL)
    assert to.count == int(jo.count) == 153


def test_master_state_converts(jax_steps):
    init_fn, _ = jax_steps(True, False, 1)
    _, jo = init_fn(jax.random.key(0))
    moved = convert.opt_state_to_torch(jax.tree.map(np.asarray, jo))
    assert isinstance(moved, ttr.MasterOptState)
    assert moved.inner.count == 0
    _trees_close(moved.master, jo.master, 0.0)


# -------------------------------------------------------------------- data
def test_synthetic_batches_are_the_references():
    a = list(tdata.synthetic_lm_batches(4, 16, 100, n_batches=3, seed=7))
    b = list(jdata.synthetic_lm_batches(4, 16, 100, n_batches=3, seed=7))
    for (ta, ga), (tb, gb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ga, gb)
        assert ta.dtype == tb.dtype == np.int32


@pytest.mark.parametrize("seed,doc_sep", [(0, None), (None, 3)])
def test_token_file_batches_are_the_references(tmp_path, seed, doc_sep):
    path = tmp_path / "corpus.bin"
    rng = np.random.default_rng(0)
    tdata.write_token_file(path, rng.integers(0, 16, 5000, dtype=np.int32))
    ref = tmp_path / "ref.bin"
    jdata.write_token_file(ref, np.fromfile(path, dtype="<i4"))
    assert path.read_bytes() == ref.read_bytes()
    kw = dict(n_epochs=2, seed=seed, doc_sep=doc_sep)
    got = list(tdata.token_file_batches(path, 4, 32, **kw))
    want = list(jdata.token_file_batches(path, 4, 32, **kw))
    assert len(got) == len(want) > 0
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_tokenize_corpus_writes_the_references_file(tmp_path):
    class WordTok:
        def encode(self, text, add_special_tokens=False):
            return [sum(map(ord, w)) % 90 + 2 for w in text.split()]
    text = tmp_path / "corpus.txt"
    text.write_text("alpha beta gamma\nepsilon zeta\n\n\neta theta\n\n"
                    "lam mu nu xi\n")
    n = tdata.tokenize_corpus(text, WordTok(), tmp_path / "a", doc_sep=1)
    m = jdata.tokenize_corpus(text, WordTok(), tmp_path / "b", doc_sep=1)
    assert n == m == 13
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_prefetch_stages_tensors_and_propagates_errors():
    def bad_source():
        yield from tdata.synthetic_lm_batches(4, 8, 100, n_batches=1)
        raise RuntimeError("disk gone")

    with tdata.prefetch_to_device(bad_source(), "cpu") as it:
        tokens, targets = next(it)
        assert isinstance(tokens, torch.Tensor) and tokens.shape == (4, 8)
        with pytest.raises(RuntimeError, match="disk gone"):
            next(it)


def test_prefetch_close_stops_the_producer():
    before = threading.active_count()
    it = tdata.prefetch_to_device(
        tdata.synthetic_lm_batches(4, 8, 100), "cpu", buffer_size=1)
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.prefetch_to_device(iter([]), "cuda")


# ----------------------------------------------------------------- trainer
def _small(**kw):
    return tt.TransformerConfig(**{**dict(
        vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=48, dtype="float32", max_seq_len=64), **kw})


def test_trainer_makes_progress_and_tracks_stats():
    cfg = _small()
    with Trainer(cfg, ttr.TrainConfig(warmup_steps=2), device="cpu") as tr:
        src = tdata.synthetic_lm_batches(8, 16, cfg.vocab_size,
                                         n_batches=12, seed=1)
        stats = tr.fit(src, steps=12, log_every=4)
    assert stats.step == 12
    assert stats.last_loss is not None and np.isfinite(stats.last_loss)
    assert stats.tokens_seen == 12 * 8 * 16
    assert stats.tokens_per_sec > 0 and stats.model_tflops_per_sec > 0
    assert [s for s, _ in stats.losses] == [4, 8, 12]
    assert stats.losses[-1][1] < stats.losses[0][1] * 1.1


def test_fit_does_not_skip_batches_across_calls():
    cfg = _small()
    drawn = []

    def source():
        for i, batch in enumerate(tdata.synthetic_lm_batches(
                4, 16, cfg.vocab_size, n_batches=64)):
            drawn.append(i)
            yield batch

    stream = source()
    with Trainer(cfg, ttr.TrainConfig(warmup_steps=1), device="cpu") as tr:
        tr.fit(stream, steps=3, prefetch_buffer=2)
        assert len(drawn) == 3
        tr.fit(stream, steps=3, prefetch_buffer=2)
        assert len(drawn) == 6
        assert tr.stats.step == 6


def test_trainer_fits_from_token_file(tmp_path):
    path = tmp_path / "corpus.bin"
    rng = np.random.default_rng(0)
    tdata.write_token_file(path, rng.integers(0, 128, 40_000,
                                              dtype=np.int32))
    with Trainer(_small(), ttr.TrainConfig(warmup_steps=1),
                 device="cpu") as tr:
        tr.fit(tdata.token_file_batches(path, 4, 16, n_epochs=None), steps=3)
        assert tr.stats.step == 3 and tr.stats.last_loss is not None


def test_evaluate_reports_heldout_perplexity():
    cfg = _small(n_layers=1, n_kv_heads=2, d_ff=64, max_seq_len=32)
    with Trainer(cfg, device="cpu") as tr:
        heldout = list(tdata.synthetic_lm_batches(8, 16, cfg.vocab_size,
                                                  seed=2, n_batches=3))
        before = _t_leaves(tr.params)
        r0 = tr.evaluate(heldout)
        for a, b in zip(before, _t_leaves(tr.params)):
            np.testing.assert_array_equal(a, b)
        assert r0["batches"] == 3 and r0["tokens"] == 3 * 8 * 15
        assert np.isclose(r0["perplexity"], np.exp(r0["loss"]), rtol=1e-5)
        tr.fit(tdata.synthetic_lm_batches(8, 16, cfg.vocab_size, seed=1),
               steps=30, log_every=30)
        r1 = tr.evaluate(heldout)
        assert r1["loss"] < r0["loss"]
        assert list(tr.stats.evals) == [(0, r0["loss"]), (30, r1["loss"])]


def test_evaluate_equals_the_jax_trainers_on_the_same_params():
    jc = jt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=64,
                              max_seq_len=32, dtype="float32")
    heldout = list(jdata.synthetic_lm_batches(4, 16, 128, seed=3,
                                              n_batches=2))
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    with JaxTrainer(mesh, jc, seed=4) as jtrainer:
        want = jtrainer.evaluate(heldout)
        np_params = jax.tree.map(np.asarray, jtrainer.params)
    with Trainer(tt.TransformerConfig(**dataclasses.asdict(jc)),
                 device="cpu") as tr:
        tr.params = convert.to_torch(np_params)
        got = tr.evaluate(heldout)
    assert got["tokens"] == want["tokens"]
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL


def test_stats_history_is_bounded():
    with Trainer(_small(), ttr.TrainConfig(warmup_steps=1), device="cpu",
                 stats_history_cap=3) as tr:
        assert tr.stats.losses.maxlen == 3 and tr.stats.evals.maxlen == 3
        src = list(tdata.synthetic_lm_batches(8, 16, 128, n_batches=6,
                                              seed=1))
        tr.fit(src, steps=6, log_every=1)
        assert [s for s, _ in tr.stats.losses] == [4, 5, 6]


def test_trainer_profile_window_writes_trace(tmp_path):
    with Trainer(_small(), ttr.TrainConfig(warmup_steps=1), device="cpu",
                 profile_dir=tmp_path / "trace", profile_steps=(1, 3)) as tr:
        tr.fit(tdata.synthetic_lm_batches(8, 16, 128, n_batches=5), steps=5,
               log_every=10)
    assert any(f.is_file() for f in (tmp_path / "trace").rglob("*"))


@pytest.mark.parametrize("make,error,match", [
    (lambda: Trainer(_small(), device="cpu", lora=object()), ValueError,
     "lora mode requires base_params"),
    (lambda: Trainer(_small(), device="cpu", mesh=object(), lora=object()),
     ValueError, "lora mode requires base_params")])
def test_unported_trainer_arguments_name_their_roadmap_item(make, error,
                                                            match):
    """``lora=`` is ported on one device and on a mesh
    (tests/test_torch_sharded_lora.py); without ``base_params`` it is
    refused on either, as the reference refuses it, before anything is
    built."""
    with pytest.raises(error, match=match):
        make()


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_small())


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_steps_launch_the_backward_kernels_on_card(cuda):
    from kubeflow_tpu_torch import ops
    cfg = _small(max_seq_len=128, n_layers=2)
    with Trainer(cfg, ttr.TrainConfig(warmup_steps=1), device=cuda) as tr:
        ops.reset_launch_counts()
        tr.fit(tdata.synthetic_lm_batches(4, 64, 128, n_batches=2), steps=2)
    counts = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert counts[name] == 2 * cfg.n_layers
    assert np.isfinite(tr.stats.last_loss)
