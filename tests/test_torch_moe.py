"""The port's MoE family (kubeflow_tpu_torch/models/moe.py and its
paths through decode, quant, speculation, the engines, the train step and
the Trainer) against the JAX package on the same params and inputs.

Config: vocab 128, d_model 32, 2 layers, 4 heads, 2 KV heads, d_ff 48,
float32, 4 experts, top-2, route groups of 16 (N = 64 tokens make four
groups). Capacity factor 1.0 binds (tokens are dropped; the tests assert
some are), 8.0 never does. JAX params are carried across with convert.py,
never two separate inits; the JAX side's Pallas kernels run in interpret
mode (``attention="flash"``, ``decode_attention="flash"``).

Tolerances (ROADMAP's for the dense port): routing rebuilt from the port's
indices — dispatch exact, combine and aux 1e-6; block and forward logits
2e-5; decode-step and window logits 3e-5; greedy ids exact; grads through
flash 5e-4; losses over 3 train steps 1e-4 relative; int8 ``q`` exact,
``s`` 1e-7.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.models import quant as jq
from kubeflow_tpu.models import speculative as js
from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime import data as jdata
from kubeflow_tpu.runtime.serving import BatchedGenerator as JaxBatched
from kubeflow_tpu.runtime.serving import \
    ContinuousBatchedGenerator as JaxContinuous
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import decode as td
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models import quant as tq
from kubeflow_tpu_torch.models import speculative as ts
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.runtime import data as tdata
from kubeflow_tpu_torch.runtime.serving import (BatchedGenerator,
                                               ContinuousBatchedGenerator)
from kubeflow_tpu_torch.runtime.trainer import Trainer

V = 128
TINY = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=48, max_seq_len=64, dtype="float32", n_experts=4,
            experts_per_token=2, route_group_size=16)
DRAFT = dict(vocab_size=V, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=64, dtype="float32")
BINDING, FREE = 1.0, 8.0
ROUTE_TOL = 1e-6
LOGITS_TOL = 2e-5
DECODE_TOL = 3e-5
GRAD_TOL = 5e-4
WAIT = 120


def _configs(cf, **kw):
    jc = jm.MoEConfig(**{**TINY, "capacity_factor": cf, **kw})
    return jc, tm.MoEConfig(**dataclasses.asdict(jc))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t_leaves(tree):
    return [x.detach().float().numpy() for x in ttr.tree_leaves(tree)]


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and the
    suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """(JAX params, numpy params) of the tiny MoE: one draw serves every
    capacity factor (the params do not depend on it)."""
    jp = jax.jit(jm.init_moe_params, static_argnums=1)(
        jax.random.key(0), _configs(FREE)[0])
    return jp, jax.tree.map(np.asarray, jp)


# ------------------------------------------------------------------ routing
def _router_logits(kind):
    if kind == "ties":  # every prob ties: the lower expert wins each pick
        return np.zeros((64, 4), np.float32)
    rng = np.random.default_rng(1)
    # skewed toward experts 0 and 1, so capacity binds at factor 1.0
    return (rng.standard_normal((64, 4)) + [1.0, 0.5, 0.0, -0.5]).astype(
        np.float32)


@pytest.mark.parametrize("kind,cf", [("random", BINDING), ("random", FREE),
                                     ("ties", BINDING), ("ties", FREE)])
def test_route_tokens_matches_jax(kind, cf):
    jc, tc = _configs(cf)
    logits = _router_logits(kind)
    capacity = jm.expert_capacity(64, jc)
    assert capacity == tm.expert_capacity(64, tc)
    jcomb, jdisp, jaux = jax.jit(jm.route_tokens, static_argnums=(1, 2))(
        jnp.asarray(logits), jc, capacity)
    comb, disp, aux = tm.route_tokens(torch.from_numpy(logits), tc, capacity)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    _close(comb.numpy(), np.asarray(jcomb), ROUTE_TOL)
    _close(aux.item(), float(jaux), ROUTE_TOL)
    dropped = 64 * 2 - int(disp.sum())
    assert (dropped > 0) == (cf == BINDING)
    if kind == "ties":  # picks 0 and 1 for every token, in that order
        expert, _, _, _ = tm.route_indices(torch.from_numpy(logits)[None],
                                           tc, capacity)
        assert (expert[0] == torch.tensor([0, 1])).all()


@pytest.mark.parametrize("n,group", [(64, 16), (60, 16), (7, 16), (4096, 2048),
                                     (8192, 2048), (8, 2048)])
def test_groups_and_capacity_match_jax(n, group):
    jc, tc = _configs(1.25, route_group_size=group)
    assert tm.num_route_groups(n, group) == jm.num_route_groups(n, group)
    g = n // tm.num_route_groups(n, group)
    assert tm.expert_capacity(g, tc) == jm.expert_capacity(g, jc)


def test_flagship_moe_is_the_flagship_with_the_references_defaults():
    """FLAGSHIP_MOE: the flagship's fields, and MoEConfig's defaults are
    the JAX package's."""
    from kubeflow_tpu_torch.tools.train_step_time import (FLAGSHIP,
                                                          FLAGSHIP_MOE)
    moe_fields = ("n_experts", "experts_per_token", "capacity_factor",
                  "router_aux_coef", "route_group_size")
    want = jm.MoEConfig(**dataclasses.asdict(FLAGSHIP))
    assert dataclasses.asdict(FLAGSHIP_MOE) == dataclasses.asdict(want)
    assert [getattr(FLAGSHIP_MOE, f) for f in moe_fields] == \
        [8, 2, 1.25, 0.01, 2048]


@pytest.mark.parametrize("cf", [BINDING, FREE])
def test_moe_mlp_block_matches_jax_over_groups(params, cf):
    """One layer's sparse MLP on N = 64 tokens in four groups of 16, each
    with its own capacity: output and aux."""
    jp, np_params = params
    jc, tc = _configs(cf)
    x = np.random.default_rng(2).standard_normal((4, 16, 32)).astype(
        np.float32)
    jlayer = jax.tree.map(lambda w: w[0], jp["blocks"])
    jout, jaux = jax.jit(jm.moe_mlp_block, static_argnums=2)(
        jnp.asarray(x), jlayer, jc)
    layer = tt.unstack_layers(convert.to_torch(np_params)["blocks"])[0]
    out, aux = tm.moe_mlp_block(torch.from_numpy(x), layer, tc)
    _close(out.numpy(), np.asarray(jout), LOGITS_TOL)
    _close(aux.item(), float(jaux), ROUTE_TOL)


@pytest.mark.parametrize("cf", [BINDING, FREE])
@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_moe_forward_matches_jax(params, cf, attention):
    jp, np_params = params
    jc, tc = _configs(cf, attention=attention)
    tokens = _tokens((4, 16), seed=3)
    jl, jaux = jax.jit(jm.moe_forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jc)
    tl, aux = tm.moe_forward(convert.to_torch(np_params),
                             torch.from_numpy(tokens), tc)
    assert tl.dtype == torch.float32 and tl.shape == (4, 16, V)
    _close(tl.numpy(), np.asarray(jl), LOGITS_TOL)
    _close(aux.item(), float(jaux), ROUTE_TOL)


@pytest.mark.parametrize("cf", [BINDING, FREE])
def test_bf16_mlp_block_follows_the_reference(params, cf):
    """bf16 compute on the same bf16 input (gates rounded to bf16 before
    they scale the expert outputs, as the reference's
    ``combine.astype(dt)``): within one bf16 ulp, elementwise. (Through a
    whole bf16 forward the frameworks round the hidden states apart, and
    a near-tied router pick may flip: routing is discrete.)"""
    jp, np_params = params
    jc, tc = _configs(cf, dtype="bfloat16")
    x = jnp.asarray(np.random.default_rng(2).standard_normal((4, 16, 32)),
                    jnp.bfloat16)
    jlayer = jax.tree.map(lambda w: w[0], jp["blocks"])
    jout, jaux = jax.jit(jm.moe_mlp_block, static_argnums=2)(x, jlayer, jc)
    layer = tt.unstack_layers(convert.to_torch(np_params)["blocks"])[0]
    out, aux = tm.moe_mlp_block(convert.to_torch(np.asarray(x)), layer, tc)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)
    _close(aux.item(), float(jaux), ROUTE_TOL)


# ----------------------------------------------------------------- training
def _train_batch(seed=4):
    tokens = _tokens((4, 16), seed)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -2:] = -1
    return tokens, targets


@pytest.fixture(scope="module")
def jax_grads(params):
    """The reference's MoE loss and grads through its flash kernels
    (interpret mode), at the binding capacity."""
    jp, _ = params
    jc, _ = _configs(BINDING, attention="flash")
    tokens, targets = _train_batch()
    loss, grads = jax.jit(jax.value_and_grad(jm.moe_loss_fn),
                          static_argnums=3)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("remat", [False, True, "mlp", "attn"])
def test_moe_loss_and_grads_match_jax(params, jax_grads, remat):
    """Value and grads of moe_loss_fn (CE + aux) through the flash path,
    under every remat policy."""
    _, np_params = params
    _, tc = _configs(BINDING, attention="flash", remat=remat)
    tokens, targets = _train_batch()
    tp = ttr.tree_map(lambda p: p.requires_grad_(),
                      convert.to_torch(np_params))
    loss, grads = ttr.value_and_grad(
        lambda p, t, tg: tm.moe_loss_fn(p, t, tg, tc), tp,
        torch.from_numpy(tokens), torch.from_numpy(targets))
    want_loss, want_grads = jax_grads
    _close(loss.item(), want_loss, LOGITS_TOL)
    got = _t_leaves(grads)
    assert len(got) == len(want_grads)
    for g, w in zip(got, want_grads):
        _close(g, w, GRAD_TOL)


def test_moe_chunked_ce_loss_matches_jax(params):
    jp, np_params = params
    jc, tc = _configs(BINDING, attention="xla")
    tokens, targets = _train_batch()
    want = jax.jit(functools.partial(jm.moe_loss_fn, config=jc,
                                     ce_chunk_tokens=8))(
        jp, jnp.asarray(tokens), jnp.asarray(targets))
    got = tm.moe_loss_fn(convert.to_torch(np_params), torch.from_numpy(tokens),
                         torch.from_numpy(targets), tc, ce_chunk_tokens=8)
    _close(got.item(), float(want), LOGITS_TOL)


def test_build_loss_includes_aux_and_eval_loss_leaves_it_out(params):
    _, np_params = params
    _, tc = _configs(BINDING)
    tp = convert.to_torch(np_params)
    tokens, targets = (torch.from_numpy(a) for a in _train_batch())
    logits, aux = tm.moe_forward(tp, tokens, tc)
    ce = ttr.token_ce(logits, targets)
    train = ttr.build_loss(tc)(tp, tokens, targets)
    evaluation = ttr.build_eval_loss(tc)(tp, tokens, targets)
    _close(train.item(), (ce + tc.router_aux_coef * aux).item(), 1e-6)
    _close(evaluation.item(), ce.item(), 1e-6)


def test_moe_step_trains_f32_params_whatever_bf16_params_says():
    _, tc = _configs(FREE)
    init_fn, _ = tm.make_moe_train_step(
        tc, ttr.TrainConfig(bf16_params=True), device="cpu")
    p, opt = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(opt, ttr.FusedAdamWState)
    assert all(x.dtype == torch.float32 and x.requires_grad
               for x in ttr.tree_leaves(p))
    assert p["blocks"]["w_gate"].shape == (2, 4, 32, 48)
    assert p["blocks"]["router"].shape == (2, 32, 4)


def _batches(n):
    return [_train_batch(seed=20 + i) for i in range(n)]


def test_moe_trainer_three_steps_match_the_sharded_moe_step(params):
    """The Trainer on converted params against make_sharded_moe_train_step
    on a one-device CPU mesh: the loss of each of 3 steps (warmup 2) and
    the params after them."""
    jp, np_params = params
    jc, tc = _configs(BINDING)
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    init_fn, step_fn = jm.make_sharded_moe_train_step(
        mesh, jc, jtr.TrainConfig(warmup_steps=2))
    _, jopt = init_fn(jax.random.key(0))       # zero moments, count 0
    jparams = jax.tree.map(jnp.array, jp)      # a copy: the step donates
    want = []
    for tokens, targets in _batches(3):
        jparams, jopt, loss = step_fn(jparams, jopt, jnp.asarray(tokens),
                                      jnp.asarray(targets))
        want.append(float(loss))
    with Trainer(tc, ttr.TrainConfig(warmup_steps=2), device="cpu") as tr:
        tr.params = ttr.tree_map(lambda p: p.requires_grad_(),
                                 convert.to_torch(np_params))
        tr.opt_state = ttr.make_optimizer(tr.tc).init(tr.params)
        tr.fit(_batches(3), steps=3, log_every=1)
        got = [loss for _, loss in tr.stats.losses]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for g, w in zip(_t_leaves(tr.params), jax.tree.leaves(jparams)):
        _close(g, np.asarray(w), 1e-5)


def test_moe_trainer_resumes_bit_equal(tmp_path):
    """Trainer A checkpoints its step 4; Trainer B resumes there; both run
    steps 5 and 6 on the same batches and agree bit for bit."""
    _, tc = _configs(BINDING)
    tcfg = ttr.TrainConfig(warmup_steps=2)
    batches = [_train_batch(seed=40 + i) for i in range(6)]
    with Trainer(tc, tcfg, device="cpu", checkpoint_dir=tmp_path,
                 checkpoint_interval=4, max_checkpoints=1) as a:
        a.fit(batches[:4], steps=4, log_every=1)
        a.checkpointer.wait()
        with Trainer(tc, tcfg, device="cpu", seed=9,
                     checkpoint_dir=tmp_path) as b:
            assert b.stats.step == 4
            a.fit(batches[4:], steps=2, log_every=1)
            b.fit(batches[4:], steps=2, log_every=1)
            assert [x for _, x in a.stats.losses][-2:] == \
                [x for _, x in b.stats.losses]
            for x, y in zip(ttr.tree_leaves(a.params),
                            ttr.tree_leaves(b.params)):
                assert torch.equal(x, y)


def test_moe_trainer_evaluate_equals_the_jax_trainers(params):
    """Held-out loss without the aux, on the same params."""
    jc, tc = _configs(BINDING)
    heldout = list(jdata.synthetic_lm_batches(4, 16, V, seed=3,
                                              n_batches=2))
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    with JaxTrainer(mesh, jc, seed=4) as jtrainer:
        want = jtrainer.evaluate(heldout)
        np_params = jax.tree.map(np.asarray, jtrainer.params)
    with Trainer(tc, device="cpu") as tr:
        tr.params = convert.to_torch(np_params)
        got = tr.evaluate(heldout)
    assert got["tokens"] == want["tokens"]
    assert abs(got["loss"] - want["loss"]) < 1e-5


def test_moe_trainer_makes_progress():
    """A repeated batch: the loss falls."""
    _, tc = _configs(BINDING)
    batch = next(iter(tdata.synthetic_lm_batches(8, 16, V, seed=1)))
    with Trainer(tc, ttr.TrainConfig(warmup_steps=2), device="cpu") as tr:
        stats = tr.fit([batch] * 12, steps=12, log_every=4)
    assert [s for s, _ in stats.losses] == [4, 8, 12]
    assert stats.losses[-1][1] < stats.losses[0][1]


# ------------------------------------------------------------------- decode
def _caches_close(got: dict, want: dict) -> None:
    for name in want:
        _close(got[name].numpy(), np.asarray(want[name]), DECODE_TOL)


@pytest.mark.parametrize("cf", [BINDING, FREE])
def test_prefill_decode_step_and_window_match_jax(params, cf):
    """On identical inputs: prefill of (8, 12) tokens (six groups),
    decode steps of 8 rows and a window of 2 x 8 — at a binding capacity
    each routes (and drops) as the reference's does."""
    jp, np_params = params
    jc, tc = _configs(cf, decode_attention="flash")
    tp = convert.to_torch(np_params)
    prompt = _tokens((8, 12), seed=5)
    jl, jcache = jax.jit(jd.prefill, static_argnums=2)(
        jp, jnp.asarray(prompt), jc)
    tl, cache = td.prefill(tp, torch.from_numpy(prompt), tc)
    _close(tl.numpy(), np.asarray(jl), DECODE_TOL)
    _caches_close(cache, jcache)
    step = jax.jit(jd.decode_step, static_argnums=4)
    for i, token in enumerate(_tokens((3, 8), seed=6)):
        jl, jcache = step(jp, jcache, jnp.asarray(token), 12 + i, jc)
        tl, cache = td.decode_step(tp, cache, torch.from_numpy(token),
                                   12 + i, tc)
        _close(tl.numpy(), np.asarray(jl), DECODE_TOL)
    window = _tokens((8, 8), seed=7)
    pos = np.array([15, 20, 15, 3, 15, 15, 40, 15], np.int32)
    jl, jcache = jax.jit(jd.decode_window, static_argnums=4)(
        jp, jcache, jnp.asarray(window), jnp.asarray(pos), jc)
    tl, cache = td.decode_window(tp, cache, torch.from_numpy(window),
                                 torch.from_numpy(pos), tc)
    _close(tl.numpy(), np.asarray(jl), DECODE_TOL)
    _caches_close(cache, jcache)


def test_decode_matches_the_forward_at_a_non_binding_capacity(params):
    """Teacher-forced decode equals the full forward when nothing drops
    (the reference's tests/test_decode.py case)."""
    _, np_params = params
    _, tc = _configs(FREE)
    tp = convert.to_torch(np_params)
    tokens = torch.from_numpy(_tokens((2, 10), seed=8))
    full, _ = tm.moe_forward(tp, tokens, tc)
    logits, cache = td.prefill(tp, tokens[:, :4], tc)
    _close(logits.numpy(), full[:, 3].numpy(), 1e-4)
    for pos in range(4, 10):
        logits, cache = td.decode_step(tp, cache, tokens[:, pos], pos, tc)
        _close(logits.numpy(), full[:, pos].numpy(), 1e-4)


@pytest.mark.parametrize("cf", [BINDING, FREE])
def test_greedy_generate_ids_match_jax(params, cf):
    jp, np_params = params
    jc, tc = _configs(cf, decode_attention="flash")
    prompt = _tokens((4, 7), seed=9)
    want = np.asarray(jd.generate(jp, jnp.asarray(prompt), jc, 12))
    got = td.generate(convert.to_torch(np_params), torch.from_numpy(prompt),
                      tc, 12)
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- int8
def test_moe_int8_scales_match_jax_and_the_router_stays_f32(params):
    jp, np_params = params
    jqp = jq.quantize_params(jp)   # eager: jit moves the scales' last bit
    tp = convert.to_torch(np_params)
    tqp = tq.quantize_params(tp)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tqp["blocks"][name]["q"].numpy(),
                                      np.asarray(jqp["blocks"][name]["q"]))
        _close(tqp["blocks"][name]["s"].numpy(),
               np.asarray(jqp["blocks"][name]["s"]), 1e-7)
    assert tqp["blocks"]["w_gate"]["s"].shape == (2, 4, 1, 48)
    assert tqp["blocks"]["w_down"]["s"].shape == (2, 4, 1, 32)
    assert tqp["blocks"]["router"] is tp["blocks"]["router"]
    np.testing.assert_array_equal(tqp["lm_head"]["q"].numpy(),
                                  np.asarray(jqp["lm_head"]["q"]))
    assert tq.quantize_params(tqp) is tqp


def test_serving_copy_keeps_the_router_in_f32(params):
    """The engines cast the matmul weights to the compute dtype once; the
    router is not one of them (its top-k picks would flip in bf16)."""
    from kubeflow_tpu_torch.runtime.serving import cast_matmul_weights
    _, np_params = params
    served = cast_matmul_weights(convert.to_torch(np_params),
                                 torch.bfloat16)
    assert served["blocks"]["router"].dtype == torch.float32
    assert all(served["blocks"][n].dtype == torch.bfloat16
               for n in ("w_gate", "w_up", "w_down", "wq", "wo"))


def test_int8_moe_generate_matches_jax(params):
    jp, np_params = params
    jc, tc = _configs(FREE)
    prompt = _tokens((2, 6), seed=10)
    jqp = jq.quantize_params(jp)
    want = np.asarray(jd.generate(jqp, jnp.asarray(prompt), jc, 8))
    tqp = convert.to_torch(jax.tree.map(np.asarray, jqp))
    got = td.generate(tqp, torch.from_numpy(prompt), tc, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's own quantisation serves the same ids
    with BatchedGenerator(convert.to_torch(np_params), tc, quantize=True,
                          device="cpu") as gen:
        ids = [gen.submit(p, 8).result(timeout=WAIT).tolist()
               for p in prompt]
    assert ids == want.tolist()


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def draft():
    jc = jt.TransformerConfig(**DRAFT)
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(7), jc)
    return (jp, convert.to_torch(jax.tree.map(np.asarray, jp)), jc,
            tt.TransformerConfig(**dataclasses.asdict(jc)))


PROMPTS = [_tokens((6,), seed=11), _tokens((6,), seed=12),
           _tokens((6,), seed=13)]


@pytest.fixture(scope="module")
def jax_engine_ids(params):
    """Both JAX engines' greedy ids for PROMPTS (8 new) at the non-binding
    capacity, as the reference's MoE serving tests run them."""
    jp, _ = params
    jc, _ = _configs(FREE)
    with JaxBatched(jp, jc, max_batch=4, max_wait_s=0.2) as gen:
        bucketed = [np.asarray(f.result(timeout=WAIT)).tolist()
                    for f in [gen.submit(p, 8) for p in PROMPTS]]
    with JaxContinuous(jp, jc, n_slots=2) as gen:
        continuous = [np.asarray(f.result(timeout=WAIT)).tolist()
                      for f in [gen.submit(p, 8) for p in PROMPTS]]
    return {"bucketed": bucketed, "continuous": continuous}


@pytest.mark.parametrize("engine", ["bucketed", "continuous",
                                    "continuous-spec"])
def test_engines_serve_the_jax_engines_ids(params, draft, jax_engine_ids,
                                           engine):
    """Greedy ids of both engines (the continuous one also with a dense
    draft) equal the JAX engines' and JAX generate's on an MoE target."""
    jp, np_params = params
    jc, tc = _configs(FREE)
    tp = convert.to_torch(np_params)
    if engine == "bucketed":
        gen = BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                               device="cpu")
    else:
        kw = {} if engine == "continuous" else dict(
            draft_params=draft[1], draft_config=draft[3], spec_k=3)
        gen = ContinuousBatchedGenerator(tp, tc, n_slots=2, device="cpu",
                                         **kw)
    with gen:
        got = [f.result(timeout=WAIT).tolist()
               for f in [gen.submit(p, 8) for p in PROMPTS]]
        if engine == "continuous-spec":
            assert gen.spec_ticks >= 1
    assert got == jax_engine_ids[engine.split("-")[0]]
    for p, ids in zip(PROMPTS, got):
        assert ids == np.asarray(jd.generate(
            jp, jnp.asarray(p)[None], jc, 8))[0].tolist()


def test_moe_target_speculation_matches_generate(params, draft):
    """An MoE target verified through decode_window with a dense draft:
    the same greedy ids as generate and as JAX's speculative_generate,
    the same acceptance."""
    jp, np_params = params
    jc, tc = _configs(FREE)
    tp = convert.to_torch(np_params)
    prompt = _tokens((3, 6), seed=14)
    got, stats = ts.speculative_generate(tp, draft[1],
                                         torch.from_numpy(prompt), tc,
                                         draft[3], 10, k=3)
    want, jstats = js.speculative_generate(jp, draft[0], jnp.asarray(prompt),
                                           jc, draft[2], 10, k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), td.generate(tp, torch.from_numpy(prompt), tc,
                                 10).numpy())
    assert stats.blocks == int(jstats.blocks)
    np.testing.assert_array_equal(stats.accepted.numpy(),
                                  np.asarray(jstats.accepted))


# ------------------------------------------------------------------ convert
def test_moe_tree_round_trips_exactly(params):
    _, np_params = params
    back = convert.to_numpy(convert.to_torch(np_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert back["blocks"]["w_gate"].shape == (2, 4, 32, 48)
    assert back["blocks"]["router"].shape == (2, 32, 4)
