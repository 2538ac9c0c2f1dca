"""The port's pipeline parallelism (parallel/pipeline.py, the model's
``pipelined_forward``, the sharded step and ``Trainer(mesh=...)`` on pp
meshes, checkpoints through pp) against the JAX package on the same mesh
shapes, and ``dryrun_multidevice`` on 4 and 8 ranks.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted; the port's in one gloo world of 8
spawned processes (tests/torch_dist_ranks.py), started once for the
module, with timeouts on the rendezvous, every collective and the join.
Params start from the JAX side's own init (convert.py, the layer axis
sharded over pp), batches are numpy, laid out for the microbatches by
``shard_batch``.

Configs: ``pipeline_apply`` on the reference's tanh stack (4 layers of
8 x 8, batch 8, 4 microbatches); ``pipelined_forward`` on the
reference's tiny config (vocab 128, d_model 32, 4 layers, 4 heads, 2 kv
heads, d_ff 64), batch 4 x 32, 2 microbatches; the steps on
tests/test_torch_sharded_train.py's (2 layers, d_model 64), batch 8 x 32,
accum 2, the default 2·pp = 4 microbatches, padded targets. Tolerances
are that file's: losses and values 1e-5, f32 params 2e-6 after two
steps, the first step's and the forward's gradients 5e-4 of each leaf's
largest element, logits 2e-5 (the reference's attention pin); restores
and resumes bit-equal.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.parallel.pipeline import pipeline_apply, split_stages
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel.mesh import AXES

import torch_dist_ranks

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
PIPE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=64, dtype="float32")
CKPT = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=48, max_seq_len=64, dtype="float32")
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
GRAD_TOL = 5e-4
LOGITS_TOL = 2e-5
SPAWN_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 60.0

STEPS = {"pp2_tp2": {"pp": 2, "tp": 2},
         "pp2_sp2_tp2": {"pp": 2, "sp": 2, "tp": 2}}
FORWARDS = {"pp2_tp2_dp2": {"pp": 2, "tp": 2, "dp": 2},
            "pp2_sp2_dp2": {"pp": 2, "sp": 2, "dp": 2},
            "pp2_sp2_tp2": {"pp": 2, "sp": 2, "tp": 2}}
EVAL_MESH = {"pp": 2, "tp": 2}


def _jax_mesh(sizes):
    cfg = MeshConfig(**sizes)
    return build_mesh(cfg, devices=jax.devices()[:cfg.size])


def _batches(n, accum=2, b=8, s=32, seed=20, pad_frac=0.1, vocab=512):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        tokens = rng.integers(0, vocab, (accum, b, s))
        targets = np.roll(tokens, -1, axis=2)
        targets[rng.random(targets.shape) < pad_frac] = -1
        out.append((tokens.astype(np.int32), targets.astype(np.int32)))
    return out


def _jax_pipeline_apply():
    """The reference's own pin (tests/test_pipeline_parity.py): a tanh
    stack through pipeline_apply at pp4 x dp2, 4 microbatches."""
    mesh = _jax_mesh({"pp": 4, "dp": 2})
    L, d, batch = 4, 8, 8
    keys = jax.random.split(jax.random.key(0), 4)
    params = {"w": jax.random.normal(keys[0], (L, d, d)) / np.sqrt(d),
              "b": jax.random.normal(keys[1], (L, d)) * 0.1}
    x = jax.random.normal(keys[2], (batch, d))
    cot = jax.random.normal(keys[3], (batch, d))

    def stage_fn(stage_layers, h):
        def body(h, layer):
            return jnp.tanh(h @ layer["w"] + layer["b"]), None
        return jax.lax.scan(body, h, stage_layers)[0]

    def loss(params, x):
        y = pipeline_apply(split_stages(params, 4), x, stage_fn, mesh=mesh,
                           n_microbatches=4)
        return jnp.sum(y * cot)

    value, (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, x)
    inputs = {k: np.asarray(v) for k, v in
              (("w", params["w"]), ("b", params["b"]), ("x", x),
               ("cot", cot))}
    return inputs, {"value": float(value), "w": np.asarray(g["w"]),
                    "b": np.asarray(g["b"]), "x": np.asarray(gx)}


def _jax_forward(sizes, params, tokens, cot):
    mesh = _jax_mesh(sizes)
    jc = jt.TransformerConfig(**PIPE)

    def loss(p):
        return jnp.sum(jt.pipelined_forward(p, tokens, jc, mesh,
                                            n_microbatches=2) * cot)

    logits = jax.jit(lambda p: jt.pipelined_forward(
        p, tokens, jc, mesh, n_microbatches=2))(params)
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return {"value": float(value), "logits": np.asarray(logits),
            "grads": jax.tree.map(np.asarray, grads)}


def _jax_steps(sizes, batches):
    """The reference's make_sharded_train_step on the same mesh shape:
    (its init params, losses, params after the steps, the first step's
    gradients), numpy."""
    mesh = _jax_mesh(sizes)
    jc = jt.TransformerConfig(**TINY)
    init_fn, step_fn = jtr.make_sharded_train_step(
        mesh, jc, jtr.TrainConfig(warmup_steps=2), accum_steps=2)
    params, opt = init_fn(jax.random.key(0))
    start = jax.tree.map(np.asarray, params)
    losses = []
    for tokens, targets in batches:
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens),
                                    jnp.asarray(targets))
        losses.append(float(loss))
    tc = jtr.TrainConfig(warmup_steps=2, grad_clip=1e9, fused_adamw=True)
    init_fn, grad_step = jtr.make_sharded_train_step(mesh, jc, tc,
                                                     accum_steps=2)
    p, opt = init_fn(jax.random.key(0))
    _, opt, _ = grad_step(p, opt, *map(jnp.asarray, batches[0]))
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - tc.b1), opt.mu)
    return start, losses, jax.tree.map(np.asarray, params), grads


@pytest.fixture(scope="module")
def jax_side():
    batches = _batches(2)
    apply_inputs, apply_want = _jax_pipeline_apply()
    jp = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.key(0), jt.TransformerConfig(**PIPE))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, PIPE["vocab_size"], (4, 32)).astype(np.int32)
    cot = rng.standard_normal((4, 32, PIPE["vocab_size"])).astype(
        np.float32)
    forwards = {name: _jax_forward(sizes, jp, tokens, cot)
                for name, sizes in FORWARDS.items()}
    steps = {name: _jax_steps(sizes, batches)
             for name, sizes in STEPS.items()}
    held_out = [(t[0], tg[0]) for t, tg in _batches(2, seed=40,
                                                    pad_frac=0.3)]
    jc = jt.TransformerConfig(**TINY)
    ep = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(3), jc)
    with JaxTrainer(_jax_mesh(EVAL_MESH), jc) as trainer:
        trainer.params = ep
        evaluated = trainer.evaluate(held_out)
    return {"batches": batches, "apply": (apply_inputs, apply_want),
            "forward_params": jax.tree.map(np.asarray, jp),
            "tokens": tokens, "cot": cot, "forwards": forwards,
            "steps": steps, "held_out": held_out,
            "eval_params": jax.tree.map(np.asarray, ep), "eval": evaluated}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Rank 0's results of one world of 8 ranks."""
    tc = {"warmup_steps": 2}
    inputs = jax_side["apply"][0]
    cases = [dict(kind="pipe_comm", name="pipe_comm"),
             dict(kind="pipe_apply", name="apply", mesh={"pp": 4, "dp": 2},
                  n_micro=4, **inputs)]
    cases += [dict(kind="pipe_forward", name=f"forward_{name}", config=PIPE,
                   mesh=sizes, n_micro=2,
                   params=jax_side["forward_params"],
                   tokens=jax_side["tokens"], cot=jax_side["cot"])
              for name, sizes in FORWARDS.items()]
    cases += [dict(kind="step", name=name, config=TINY, mesh=sizes, accum=2,
                   tc=tc, params=jax_side["steps"][name][0],
                   batches=jax_side["batches"])
              for name, sizes in STEPS.items()]
    cases += [
        dict(kind="trainer_eval", name="eval", config=TINY, mesh=EVAL_MESH,
             params=jax_side["eval_params"], batches=jax_side["held_out"]),
        dict(kind="resume", name="resume", config=TINY,
             mesh={"pp": 2, "tp": 2},
             dir=str(tmp_path_factory.mktemp("resume"))),
        dict(kind="restore", name="restore", config=CKPT, chain=True,
             dir=str(tmp_path_factory.mktemp("restore") / "ckpt"),
             **{"from": {"pp": 2, "tp": 2},
                "to": {"tp4": {"tp": 4}, "pp2_tp2": {"pp": 2, "tp": 2}}})]
    return tmesh.spawn(
        torch_dist_ranks.pipeline_suite, 8, {"cases": cases}, device="cpu",
        timeout=SPAWN_TIMEOUT, collective_timeout=COLLECTIVE_TIMEOUT,
        store_dir=str(tmp_path_factory.mktemp("world")))[0]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _grads_close(got, want):
    want, got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max())


# ----------------------------------------------------------- collectives
def test_stage_shift_and_broadcast_are_their_transposes(port_side):
    """pp = 4: a tick's shift gives each stage the previous stage's
    tensor and sends the grad back; the broadcast from the last stage
    gives every stage its tensor and returns the grad to it once."""
    assert port_side["pipe_comm"] == {
        "shift_value": True, "shift_grad": True, "broadcast_value": True,
        "broadcast_grad": True}


def test_a_stage_waiting_on_a_missing_send_fails_within_the_timeout(
        tmp_path):
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        tmesh.spawn(torch_dist_ranks.pipe_deadlock, 2, device="cpu",
                    timeout=60, collective_timeout=3,
                    store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


# -------------------------------------------------------------- pipeline
def test_pipeline_apply_matches_the_reference(jax_side, port_side):
    """The GPipe schedule at pp4 x dp2, 4 microbatches: the value and the
    grads of the input and of every stacked param against the
    reference's pipeline_apply."""
    want, got = jax_side["apply"][1], port_side["apply"]
    _close(got["value"], want["value"], LOSS_TOL)
    for name in ("w", "b", "x"):
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want[name]).max())


@pytest.mark.parametrize("name", list(FORWARDS))
def test_pipelined_forward_matches_the_reference(jax_side, port_side, name):
    """The embedding outside, 2 stages of 2 layers (ring attention inside
    them under sp), the LM head outside: logits, and the grads of a
    non-uniform cotangent's sum, against the reference's
    pipelined_forward on the same mesh shape."""
    want, got = jax_side["forwards"][name], port_side[f"forward_{name}"]
    _close(got["value"], want["value"], 1e-4)
    _close(got["logits"], want["logits"], LOGITS_TOL)
    _grads_close(got["grads"], want["grads"])


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("name", list(STEPS))
def test_pipelined_step_matches_the_reference(jax_side, port_side, name):
    """Two steps (accum 2, padded targets) of make_sharded_train_step on a
    pp mesh: the global-mean losses and the gathered params."""
    _, want_losses, want_params, _ = jax_side["steps"][name]
    got = port_side[name]
    _close(got["losses"], want_losses, LOSS_TOL)
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want_params)):
        _close(g, w, PARAM_TOL)
    # every replica of a leaf (its ranks along the axes it is not sharded
    # on: pp for the embedding, ep and tp for the attention weights) the
    # same, params and first-step grads
    assert got["replicas_equal"]


@pytest.mark.parametrize("name", list(STEPS))
def test_pipelined_step_gradients_match_the_reference(jax_side, port_side,
                                                      name):
    """The first step's gradients on a pp mesh: a grad summed over pp
    (the LM head's, computed on every stage) or not summed where it
    must be (the embedding's, which reaches stage 0 only) is off by the
    axis' size."""
    _grads_close(port_side[name]["grads"], jax_side["steps"][name][3])


# ---------------------------------------------------------------- trainer
def test_trainer_on_a_pp_mesh_evaluates_as_the_reference(jax_side,
                                                         port_side):
    """Trainer(mesh=pp2 x tp2).evaluate of the same params, pipelined,
    against the reference Trainer's evaluate."""
    want, got = jax_side["eval"], port_side["eval"]["eval"]
    assert got["tokens"] == want["tokens"]
    _close(got["loss"], want["loss"], LOSS_TOL)


def test_trainer_on_a_pp_mesh_resumes_bit_equal(port_side):
    got = port_side["resume"]
    assert got["resumed_step"] == 4
    assert got["losses"]["a"] == got["losses"]["b"]
    assert all(np.isfinite(got["losses"]["a"]))
    assert got["params_equal"]


def test_cross_mesh_restore_through_pp_is_bit_equal(port_side):
    """pp2 x tp2 → tp4 → pp2 x tp2, each hop written on the mesh before:
    every leaf of params and optimizer state bit-equal to the first
    mesh's, and a train step on each."""
    got = port_side["restore"]
    for label in ("tp4", "pp2_tp2"):
        assert got[label]["equal"] and got[label]["step"] == 3
        assert np.isfinite(got[label]["loss"])
    # wq (L, d, heads, k): the layer axis over pp, or the heads over tp 4
    assert got["tp4"]["wq_local"] == (2, 32, 1, 8)
    assert got["pp2_tp2"]["wq_local"] == (1, 32, 2, 8)


# -------------------------------------------------------------- the mesh
class _Shape:
    """Axis sizes in a DeviceMesh's interface, for check_mesh."""
    mesh_dim_names = AXES

    def __init__(self, **sizes):
        self.sizes = [sizes.get(a, 1) for a in AXES]

    def size(self, i):
        return self.sizes[i]


def test_check_mesh_admits_pp_with_the_layers_on_it():
    c = tt.TransformerConfig(**TINY)
    tt.check_mesh(c, _Shape(pp=2, tp=2), ttr.pipeline_rules())
    with pytest.raises(ValueError, match="'layers' axis on pp"):
        tt.check_mesh(c, _Shape(pp=2), None)
    with pytest.raises(ValueError, match="layers axis of 2"):
        tt.check_mesh(c, _Shape(pp=4), ttr.pipeline_rules())
    assert ttr.pipeline_rules().rules == jtr.pipeline_rules().rules


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_runs_every_layout_the_ranks_allow(n):
    """dryrun_multidevice on gloo ranks: at 8 every layout of
    dryrun_multichip runs; at 4 those that need 8 are skipped, saying
    so."""
    from kubeflow_tpu_torch.tools.dryrun_multidevice import (
        dryrun_multidevice)
    lines = dryrun_multidevice(n, "cpu", timeout=240)
    skipped = [ln for ln in lines if "skipped" in ln]
    labels = ["fsdp+tp+sp(ring)", "pp(gpipe)+tp", "ep(moe)+tp",
              "ep4(moe)+tp", "pp+ep(moe)+tp", "pp+sp(ring)+tp",
              "multislice(dp-over-slices)+fsdp+tp", "tp-serving"]
    assert [ln.split(":")[0] for ln in lines] == [f"[dryrun] {x}"
                                                  for x in labels]
    if n == 8:
        assert not skipped
    else:
        assert len(skipped) == 4 and all("multiple of 8" in ln
                                         for ln in skipped)
    for ln in lines:
        if "loss=" in ln:
            assert np.isfinite(float(ln.rsplit("loss=", 1)[1]))
