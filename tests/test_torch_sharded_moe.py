"""The port's MoE family on a mesh (models/moe.py
``make_sharded_moe_train_step``, ``pipelined_moe_forward_hidden``, the
Trainer on a mesh, checkpoints across ep) against the JAX package on the
same mesh shapes.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted; the port's in one gloo world of 8
spawned processes (tests/torch_dist_ranks.py), started once for the
module. Params start from the JAX side's init (convert.py, experts
sharded over ep), batches are numpy (8 rows of 16 tokens, padded
targets), laid out for the microbatches on pp meshes.

Config: tests/test_torch_sharded_train.py's tiny flagship (2 layers,
d_model 64, 4 heads of 16, 2 kv heads, d_ff 128, vocab 512, f32) with 4
experts, top-2, capacity factor 1.25 (it binds: tokens are dropped), and
per case routing groups that lie inside a data rank, span every data
rank (one group of the whole batch over dp2 x fsdp2), follow the
sequence (pp2 x ep2 x tp2), are a microbatch split over dp (pp2 x dp2,
4 microbatches of 2 rows, groups of 2 rows), or span the sequence
blocks of sp (sp2 x dp2, ring attention). Tolerances are that file's:
losses 1e-5, f32 params 2e-6 after two steps, the first step's
gradients 5e-4 of each leaf's largest element, evaluation 1e-5; resumes
and restores bit-equal. A routing choice that differs from the JAX
package's would move a loss by far more than 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.parallel import partition_rules as jpr
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import partition_rules as tpr

import torch_dist_ranks

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
MOE = dict(n_experts=4, experts_per_token=2, capacity_factor=1.25)
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
GRAD_TOL = 5e-4
SPAWN_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 60.0

# name: (mesh, route_group_size, n_microbatches); 8 x 16 tokens = 128
STEPS = {
    "dp2_fsdp2_span": ({"dp": 2, "fsdp": 2}, 128, None),
    "ep2_tp2_dp2": ({"ep": 2, "tp": 2, "dp": 2}, 32, None),
    "ep4_tp2": ({"ep": 4, "tp": 2}, 32, None),
    "pp2_ep2_tp2": ({"pp": 2, "ep": 2, "tp": 2}, 16, None),
    "pp2_dp2_split": ({"pp": 2, "dp": 2}, 32, 4),
    "sp2_dp2": ({"sp": 2, "dp": 2}, 32, None),
}
EVAL_MESH = {"ep": 2, "tp": 2}


def _moe(group):
    return dict(MOE, route_group_size=group)


def _jax_mesh(sizes):
    cfg = MeshConfig(**sizes)
    return build_mesh(cfg, devices=jax.devices()[:cfg.size])


def _batches(n, b=8, s=16, seed=20, pad_frac=0.1):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        tokens = rng.integers(0, TINY["vocab_size"], (b, s))
        targets = np.roll(tokens, -1, axis=1)
        targets[rng.random(targets.shape) < pad_frac] = -1
        out.append((tokens.astype(np.int32), targets.astype(np.int32)))
    return out


def _jax_steps(sizes, group, n_micro, batches):
    """The reference's make_sharded_moe_train_step on the same mesh
    shape: (its init params, losses, params after the steps, the first
    step's gradients), numpy."""
    mesh = _jax_mesh(sizes)
    mc = jm.MoEConfig(**TINY, **_moe(group))
    init_fn, step_fn = jm.make_sharded_moe_train_step(
        mesh, mc, jtr.TrainConfig(warmup_steps=2),
        n_microbatches=n_micro)
    params, opt = init_fn(jax.random.key(0))
    start = jax.tree.map(np.asarray, params)
    losses = []
    for tokens, targets in batches:
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens),
                                    jnp.asarray(targets))
        losses.append(float(loss))
    tc = jtr.TrainConfig(warmup_steps=2, grad_clip=1e9, fused_adamw=True)
    init_fn, grad_step = jm.make_sharded_moe_train_step(
        mesh, mc, tc, n_microbatches=n_micro)
    p, opt = init_fn(jax.random.key(0))
    _, opt, _ = grad_step(p, opt, *map(jnp.asarray, batches[0]))
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - tc.b1), opt.mu)
    return start, losses, jax.tree.map(np.asarray, params), grads


def _jax_refusal(sizes, group, params, tokens):
    """(type, message) of what the reference's pipelined MoE forward
    raises on this mesh, 4 microbatches, or None."""
    mc = jm.MoEConfig(**TINY, **_moe(group))
    try:
        jax.jit(lambda p, t: jm.pipelined_moe_forward_hidden(
            p, t, mc, _jax_mesh(sizes), 4))(params, tokens)
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


# the refusals: pp x sp; groups of 4 rows, which 4 microbatches of 2
# rows would change
REFUSALS = {"pp2_sp2": ({"pp": 2, "sp": 2}, 16),
            "pp2_variant": ({"pp": 2}, 64)}


@pytest.fixture(scope="module")
def jax_side():
    batches = _batches(2)
    steps = {name: _jax_steps(sizes, group, n_micro, batches)
             for name, (sizes, group, n_micro) in STEPS.items()}
    held_out = _batches(2, seed=40, pad_frac=0.3)
    mc = jm.MoEConfig(**TINY, **_moe(32))
    ep = jax.jit(jm.init_moe_params, static_argnums=1)(jax.random.key(3),
                                                       mc)
    with JaxTrainer(_jax_mesh(EVAL_MESH), mc) as trainer:
        trainer.params = ep
        evaluated = trainer.evaluate(held_out)
    refusals = {name: _jax_refusal(sizes, group, ep, batches[0][0])
                for name, (sizes, group) in REFUSALS.items()}
    return {"batches": batches, "steps": steps, "held_out": held_out,
            "eval_params": jax.tree.map(np.asarray, ep), "eval": evaluated,
            "refusals": refusals}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Rank 0's results of one world of 8 ranks."""
    tc = {"warmup_steps": 2}
    cases = [dict(kind="step", name=name, config=TINY, moe=_moe(group),
                  mesh=sizes, n_micro=n_micro, accum=1, tc=tc,
                  params=jax_side["steps"][name][0],
                  batches=jax_side["batches"])
             for name, (sizes, group, n_micro) in STEPS.items()]
    cases += [
        dict(kind="trainer_eval", name="eval", config=TINY, moe=_moe(32),
             mesh=EVAL_MESH, params=jax_side["eval_params"],
             batches=jax_side["held_out"]),
        dict(kind="resume", name="resume", config=TINY, moe=_moe(32),
             mesh={"ep": 2, "tp": 2},
             dir=str(tmp_path_factory.mktemp("resume"))),
        dict(kind="restore", name="restore", config=TINY, moe=_moe(16),
             dir=str(tmp_path_factory.mktemp("restore") / "ckpt"),
             **{"from": {"ep": 2, "fsdp": 2}, "to": {"ep4": {"ep": 4}}}),
        dict(kind="world1_families", name="world1", config=TINY,
             moe=_moe(32),
             batches=[(t[None], tg[None]) for t, tg in jax_side["batches"]])]
    cases += [dict(kind="moe_errors", name=f"refusal_{name}", config=TINY,
                   moe=_moe(group), meshes={name: sizes},
                   params=jax_side["eval_params"],
                   tokens=jax_side["batches"][0][0])
              for name, (sizes, group) in REFUSALS.items()]
    return tmesh.spawn(
        torch_dist_ranks.train_suite, 8, {"cases": cases}, device="cpu",
        timeout=SPAWN_TIMEOUT, collective_timeout=COLLECTIVE_TIMEOUT,
        store_dir=str(tmp_path_factory.mktemp("world")))[0]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_moe_step_matches_the_reference(jax_side, port_side, name):
    """Two steps on the mesh: the global losses (CE + the aux, counted
    once) and the gathered params."""
    _, want_losses, want_params, _ = jax_side["steps"][name]
    got = port_side[name]
    _close(got["losses"], want_losses, LOSS_TOL)
    leaves = jax.tree.leaves(want_params)
    assert len(jax.tree.leaves(got["params"])) == len(leaves)
    for g, w in zip(jax.tree.leaves(got["params"]), leaves):
        _close(g, w, PARAM_TOL)
    # every replica of a leaf (its ranks along the axes it is not sharded
    # on: pp for the embedding, ep and tp for the attention weights) the
    # same, params and first-step grads
    assert got["replicas_equal"]


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_moe_step_gradients_match_the_reference(jax_side, port_side,
                                                        name):
    """The first step's gradients: the router's through the gathered
    logits (a global group's aux is every rank's), the experts' over ep,
    each within 5e-4 of its leaf's largest element."""
    want = jax.tree.leaves(jax_side["steps"][name][3])
    got = jax.tree.leaves(port_side[name]["grads"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("name", list(REFUSALS))
def test_pipelined_moe_refuses_as_the_reference(jax_side, port_side, name):
    """pp x sp, and routing groups a microbatch would change: the same
    error and message as the reference's."""
    want = jax_side["refusals"][name]
    assert want is not None
    assert port_side[f"refusal_{name}"][name] == want


def test_moe_trainer_on_a_mesh_evaluates_as_the_reference(jax_side,
                                                          port_side):
    """Trainer(MoEConfig, mesh=ep2 x tp2).evaluate of the same params
    (the router aux left out) against the reference Trainer's."""
    want, got = jax_side["eval"], port_side["eval"]["eval"]
    assert got["tokens"] == want["tokens"]
    _close(got["loss"], want["loss"], LOSS_TOL)


def test_moe_trainer_on_a_mesh_resumes_bit_equal(port_side):
    got = port_side["resume"]
    assert got["resumed_step"] == 4
    assert got["losses"]["a"] == got["losses"]["b"]
    assert all(np.isfinite(got["losses"]["a"]))
    assert got["params_equal"]


def test_moe_checkpoint_restores_from_ep2_onto_ep4_bit_equal(port_side):
    got = port_side["restore"]["ep4"]
    assert got["equal"] and got["step"] == 3 and np.isfinite(got["loss"])
    # w_gate (L, E, d, f): one expert a rank
    assert got["w_gate_local"] == (2, 1, 64, 128)


@pytest.mark.parametrize("family", ["moe", "lora"])
def test_sharded_moe_and_lora_steps_on_one_rank_are_the_one_device_steps(
        port_side, family):
    """A mesh of one rank runs make_moe_train_step's and
    make_lora_step's ops: losses and params bit-equal."""
    assert port_side["world1"][family] == {"losses_equal": True,
                                           "params_equal": True}


def test_moe_rules_lay_out_the_moe_step(jax_side):
    """MOE_RULES (rules_for of an MoEConfig) match the sharded MoE
    step's specs on every leaf of its params, and the reference's
    table."""
    c = tm.MoEConfig(**TINY, **_moe(32))
    params = convert.to_torch(jax_side["eval_params"])
    assert tpr.rules_for(c) is tpr.MOE_RULES
    assert tpr.match_partition_rules(tpr.MOE_RULES, params) == \
        tt.param_specs(c)
    assert tpr.MOE_RULES == tuple((r, tuple(p)) for r, p in jpr.MOE_RULES)
    assert tm.moe_param_logical_specs(c) == jm.moe_param_logical_specs(c)
