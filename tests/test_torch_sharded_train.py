"""The port's sharded train step (models/train.py
``make_sharded_train_step``), ``Trainer(mesh=...)`` and cross-mesh
checkpoint restores against the JAX package on the same meshes.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted; the port's in two gloo worlds of
spawned processes (4 ranks, then 8; tests/torch_dist_ranks.py), each
started once for the module, with timeouts on the rendezvous, every
collective and the join. Params start from the JAX step's own init
(convert.py, sharded by the rules), batches are numpy with padding
targets, so the global token mean is tested.

Config: the tiny flagship at 2 layers (d_model 64, 4 heads of 16, 2 kv
heads, d_ff 128, vocab 512), float32. Tolerances are
tests/test_torch_train.py's: losses 1e-5, f32 params 2e-6 after two
steps (the grads are summed in another order on each layout, far below
Adam's ~lr step); the first step's gradients 5e-4 of each leaf's largest
element (a mis-reduced gradient is off by a mesh axis' size); the
embedding and LM-head grads through the
vocab-parallel CE 5e-4, as model grads there; the clip norm 1e-6
relative; remat policies against no remat 1e-6 (the same ops in the
same order); ``Trainer(mesh=...).evaluate`` 1e-5 against the reference's
loss of the same params. Restores are bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.parallel import mesh as tmesh

import torch_dist_ranks

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
# n_kv_heads 4, so the kv heads divide over tp = 4 (the reference's
# tests/test_checkpoint.py config)
CKPT = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=48, max_seq_len=64, dtype="float32")
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
GRAD_TOL = 5e-4
SPAWN_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 60.0

# (name, mesh, attention, world)
STEPS = [
    ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, "auto", 4),
    ("sp2_tp2", {"sp": 2, "tp": 2}, "auto", 4),          # ring
    ("dp2_sp2", {"dp": 2, "sp": 2}, "ulysses", 4),
    ("fsdp2_sp2_tp2", {"fsdp": 2, "sp": 2, "tp": 2}, "auto", 8),
]
# Trainer(mesh=...).evaluate against the reference's loss on the same
# params: one mesh with fsdp, one with sp (ring)
EVALS = {"fsdp2_tp2": {"fsdp": 2, "tp": 2}, "sp2_tp2": {"sp": 2, "tp": 2}}
RESTORES = {
    "tp2_to_tp4": ({"fsdp": 4, "tp": 2}, {"tp4": {"fsdp": 2, "tp": 4}}),
    "dp4_to_dp3_dp5": ({"dp": 4, "fsdp": 2},
                       {"dp3": {"dp": 3, "fsdp": 2}, "dp5": {"dp": 5}}),
}


def _batches(n, accum=2, b=4, s=32, seed=20, pad_frac=0.1):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        tokens = rng.integers(0, TINY["vocab_size"], (accum, b, s))
        targets = np.roll(tokens, -1, axis=2)
        targets[rng.random(targets.shape) < pad_frac] = -1
        out.append((tokens.astype(np.int32), targets.astype(np.int32)))
    return out


def _jax_steps(sizes, attention, batches):
    """The reference's make_sharded_train_step on the same mesh shape:
    (its init params, losses, params after the steps, the first step's
    gradients), numpy. The gradients are (first moment) / (1 - b1) after
    one step of the fused AdamW with a clip that does not bind."""
    cfg = MeshConfig(**sizes)
    mesh = build_mesh(cfg, devices=jax.devices()[:cfg.size])
    jc = jt.TransformerConfig(**TINY, attention=attention)
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
    steps = {name: _jax_steps(sizes, attn, batches)
             for name, sizes, attn, _ in STEPS}
    held_out = [(t[0], tg[0]) for t, tg in _batches(2, seed=40,
                                                    pad_frac=0.3)]
    jc = jt.TransformerConfig(**TINY)
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(3), jc)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, TINY["vocab_size"], (2, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[rng.random(targets.shape) < 0.1] = -1
    vocab = {}
    for name, fn in (
            ("whole", lambda p: jtr.loss_fn(p, tokens, targets, jc)),
            ("chunked", lambda p: jtr.fused_loss_fn(p, tokens, targets, jc,
                                                    chunk_tokens=8))):
        loss, grads = jax.value_and_grad(fn)(jp)
        vocab[name] = {"loss": float(loss),
                       "embed": np.asarray(grads["embed"]),
                       "lm_head": np.asarray(grads["lm_head"])}
    grads = jax.tree.map(lambda p: np.random.default_rng(6).standard_normal(
        p.shape).astype(np.float32), jax.tree.map(np.asarray, jp))
    return {"batches": batches, "steps": steps, "held_out": held_out,
            "params": jax.tree.map(np.asarray, jp), "tokens": tokens,
            "targets": targets, "vocab": vocab, "grads": grads}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Rank 0's results of the two worlds (4 ranks, then 8)."""
    tc = {"warmup_steps": 2}
    out = {}
    for world in (4, 8):
        cases = [dict(kind="step", name=name, config=TINY, mesh=sizes,
                      attention=attn, accum=2, tc=tc,
                      params=jax_side["steps"][name][0],
                      batches=jax_side["batches"])
                 for name, sizes, attn, w in STEPS if w == world]
        if world == 4:
            cases += [
                dict(kind="vocab", name="vocab", config=TINY,
                     params=jax_side["params"], tokens=jax_side["tokens"],
                     targets=jax_side["targets"]),
                dict(kind="clip", name="clip", config=TINY,
                     mesh={"fsdp": 2, "tp": 2}, grads=jax_side["grads"]),
                dict(kind="resume", name="resume", config=TINY,
                     mesh={"fsdp": 2, "tp": 2},
                     dir=str(tmp_path_factory.mktemp("resume"))),
                dict(kind="world1", name="world1", config=TINY,
                     batches=jax_side["batches"]),
                dict(kind="remat", name="remat", config=TINY,
                     mesh={"fsdp": 2, "sp": 2}, batches=jax_side["batches"])]
            cases += [dict(kind="eval", name=f"eval_{name}", config=TINY,
                           mesh=sizes, batches=jax_side["held_out"])
                      for name, sizes in EVALS.items()]
        else:
            cases += [dict(kind="restore", name=name, config=CKPT,
                           dir=str(tmp_path_factory.mktemp(name)),
                           **{"from": src, "to": dst})
                      for name, (src, dst) in RESTORES.items()]
        out.update(tmesh.spawn(
            torch_dist_ranks.train_suite, world, {"cases": cases},
            device="cpu", timeout=SPAWN_TIMEOUT,
            collective_timeout=COLLECTIVE_TIMEOUT,
            store_dir=str(tmp_path_factory.mktemp("world")))[0])
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _trees_close(got, want, tol):
    leaves = jax.tree.leaves(want)
    mine = jax.tree.leaves(got)
    assert len(leaves) == len(mine)
    for g, w in zip(mine, leaves):
        _close(g, w, tol)


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_sharded_step_matches_the_reference(jax_side, port_side, name):
    """Two steps (accum 2, padded targets) on the same mesh shape: the
    global-mean loss of each step and the gathered params."""
    _, want_losses, want_params, _ = jax_side["steps"][name]
    got = port_side[name]
    _close(got["losses"], want_losses, LOSS_TOL)
    _trees_close(got["params"], want_params, PARAM_TOL)


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_sharded_step_gradients_match_the_reference(jax_side, port_side,
                                                    name):
    """The first step's gradients (accum 2, padded targets), reduced over
    the data axes and gathered, against the reference's step on the same
    mesh shape, each leaf within GRAD_TOL of its largest element: a
    gradient summed over an axis once too often, or averaged where it is
    summed, is off by the axis' size."""
    want = jax.tree.leaves(jax_side["steps"][name][3])
    got = jax.tree.leaves(port_side[name]["grads"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("path", ["whole", "chunked"])
def test_vocab_parallel_ce_and_embedding_match(jax_side, port_side, path):
    """tp = 2: the vocab-sharded lookup and CE (whole logits and chunked)
    against the reference's unsharded loss and its embedding and LM-head
    grads."""
    want, got = jax_side["vocab"][path], port_side["vocab"][path]
    _close(got["loss"], want["loss"], LOSS_TOL)
    for name in ("embed", "lm_head"):
        _close(got[name], want[name], GRAD_TOL)


def test_clip_norm_counts_each_element_once(jax_side, port_side):
    want = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                       for g in jax.tree.leaves(jax_side["grads"])))
    np.testing.assert_allclose(port_side["clip"]["norm"], want, rtol=1e-6)


def test_sharded_step_on_one_rank_is_the_one_device_step(port_side):
    """A mesh of one rank issues make_train_step's ops: losses and params
    bit-equal."""
    assert port_side["world1"] == {"losses_equal": True,
                                   "params_equal": True}


@pytest.mark.parametrize("remat", ["True", "attn", "mlp"])
def test_remat_policies_hold_on_a_mesh(port_side, remat):
    """fsdp 2 x sp 2 (ring): each remat policy recomputes the fsdp
    gathers and the ring's rotations in its backward, and changes no
    value: losses equal, params within 1e-6 of no remat."""
    got = port_side["remat"][remat]
    assert got["losses_equal"] and got["max_param_diff"] <= 1e-6


def test_trainer_on_a_mesh_resumes_bit_equal(port_side):
    got = port_side["resume"]
    assert got["resumed_step"] == 4
    assert got["losses"]["a"] == got["losses"]["b"]
    assert all(np.isfinite(got["losses"]["a"]))
    assert got["params_equal"]


def test_trainer_on_a_mesh_evaluates_and_counts_the_whole_batch(port_side):
    got = port_side["resume"]
    a, b = got["eval"]
    assert a == b and a["tokens"] == 2 * 8 * 32 - 2 * 8 and a["step"] == 6
    # b resumed at 4 and saw 2 batches of 8 x 32 (every rank's rows)
    assert got["tokens_seen"] == 2 * 8 * 32


@pytest.mark.parametrize("name", list(EVALS))
def test_trainer_on_a_mesh_evaluates_the_global_loss(jax_side, port_side,
                                                     name):
    """Trainer(mesh=...).evaluate against the reference's loss of the
    same params on each held-out batch, weighted by its valid tokens
    (targets 30% padding, so the batches weigh differently)."""
    got = port_side[f"eval_{name}"]
    jc = jt.TransformerConfig(**TINY)
    params = jax.tree.map(jnp.asarray, got["params"])
    loss = jax.jit(lambda p, t, tg: jtr.loss_fn(p, t, tg, jc))
    total = count = 0
    for tokens, targets in jax_side["held_out"]:
        n = int((targets >= 0).sum())
        total += float(loss(params, tokens, targets)) * n
        count += n
    assert got["eval"]["tokens"] == count
    _close(got["eval"]["loss"], total / count, LOSS_TOL)


@pytest.mark.parametrize("name,label", [("tp2_to_tp4", "tp4"),
                                        ("dp4_to_dp3_dp5", "dp3"),
                                        ("dp4_to_dp3_dp5", "dp5")])
def test_cross_mesh_restore_is_bit_equal(port_side, name, label):
    """Written on one mesh, restored onto another from the rules: every
    leaf of params and optimizer state bit-equal, the step kept, and
    training goes on on the new mesh."""
    got = port_side[name][label]
    assert got["equal"] and got["step"] == 3
    assert np.isfinite(got["loss"])
    if label == "tp4":
        # wq (L, d/fsdp, heads/tp, k): now 4-way over its heads
        assert got["wq_local"] == (2, 16, 1, 8)
