"""The port's LoRA step on a mesh (models/lora.py
``make_sharded_lora_step``, ``lora_logical_specs``, the Trainer's lora
mode on a mesh) against the JAX package on the same mesh shapes.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted; the port's in one gloo world of 4
spawned processes (tests/torch_dist_ranks.py). The base and the
adapters start from the JAX side's (convert.py): the base sharded by
``param_specs``, the adapters by ``lora_specs``; B is drawn nonzero, so
A's first gradient is not zero.

Config: tests/test_torch_sharded_train.py's tiny flagship (2 layers,
d_model 64, 4 heads of 16, 2 kv heads, d_ff 128, vocab 512, f32); rank 4,
alpha 8, on wq, wk, wv, wo, w_gate and w_down (each way of splitting a
base weight over tp and fsdp); batches of 8 x 16 with padded targets.
Tolerances are that file's: losses 1e-5, adapters 2e-6 after two steps,
the first step's adapter gradients 5e-4 of each leaf's largest element,
evaluation 1e-5; the base bit-identical after.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import lora as jl
from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import lora as tl
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel.mesh import AXES

import torch_dist_ranks

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
LORA = dict(rank=4, alpha=8.0,
            targets=("wq", "wk", "wv", "wo", "w_gate", "w_down"))
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
GRAD_TOL = 5e-4
SPAWN_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 60.0

STEPS = {"fsdp2_tp2": {"fsdp": 2, "tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}
EVAL_MESH = {"fsdp": 2, "tp": 2}


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


def _start(jc, lora):
    """(base, adapters) numpy: the JAX inits, with B drawn nonzero."""
    base = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0), jc)
    lp = jl.init_lora_params(jax.random.key(1), jc, lora)
    rng = np.random.default_rng(2)
    lp = jax.tree.map(np.asarray, lp)
    for ab in lp["blocks"].values():
        ab["B"] = (0.02 * rng.standard_normal(ab["B"].shape)).astype(
            np.float32)
    return jax.tree.map(np.asarray, base), lp


def _jax_steps(sizes, base, lp, batches):
    """The reference's make_sharded_lora_step on the same mesh shape from
    the same adapters: (losses, adapters after the steps, the first
    step's adapter gradients), numpy."""
    mesh = _jax_mesh(sizes)
    jc, lora = jt.TransformerConfig(**TINY), jl.LoRAConfig(**LORA)
    init_fn, step_fn = jl.make_sharded_lora_step(
        mesh, jc, lora, tc=jtr.TrainConfig(warmup_steps=2))
    _, opt = init_fn(jax.random.key(0))
    params = jax.tree.map(jnp.asarray, lp)
    losses = []
    for tokens, targets in batches:
        params, opt, loss = step_fn(base, params, opt, jnp.asarray(tokens),
                                    jnp.asarray(targets))
        losses.append(float(loss))
    tc = jtr.TrainConfig(warmup_steps=2, grad_clip=1e9, fused_adamw=True)
    init_fn, grad_step = jl.make_sharded_lora_step(mesh, jc, lora, tc=tc)
    _, opt = init_fn(jax.random.key(0))
    _, opt, _ = grad_step(base, jax.tree.map(jnp.asarray, lp), opt,
                          *map(jnp.asarray, batches[0]))
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - tc.b1), opt.mu)
    return losses, jax.tree.map(np.asarray, params), grads


@pytest.fixture(scope="module")
def jax_side():
    jc, lora = jt.TransformerConfig(**TINY), jl.LoRAConfig(**LORA)
    base, lp = _start(jc, lora)
    batches = _batches(2)
    steps = {name: _jax_steps(sizes, base, lp, batches)
             for name, sizes in STEPS.items()}
    held_out = _batches(2, seed=40, pad_frac=0.3)
    with JaxTrainer(_jax_mesh(EVAL_MESH), jc, lora=lora,
                    base_params=base) as trainer:
        trainer.params = jax.tree.map(jnp.asarray, lp)
        evaluated = trainer.evaluate(held_out)
    return {"base": base, "lora_params": lp, "batches": batches,
            "steps": steps, "held_out": held_out, "eval": evaluated}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Rank 0's results of one world of 4 ranks."""
    cases = [dict(kind="step", name=name, config=TINY, lora=LORA,
                  mesh=sizes, accum=1, tc={"warmup_steps": 2},
                  base=jax_side["base"], params=jax_side["lora_params"],
                  batches=jax_side["batches"])
             for name, sizes in STEPS.items()]
    cases.append(dict(kind="trainer_eval", name="eval", config=TINY,
                      lora=LORA, mesh=EVAL_MESH, base=jax_side["base"],
                      params=jax_side["lora_params"],
                      batches=jax_side["held_out"]))
    return tmesh.spawn(
        torch_dist_ranks.train_suite, 4, {"cases": cases}, device="cpu",
        timeout=SPAWN_TIMEOUT, collective_timeout=COLLECTIVE_TIMEOUT,
        store_dir=str(tmp_path_factory.mktemp("world")))[0]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_lora_step_matches_the_reference(jax_side, port_side, name):
    """Two adapter steps on the mesh: the global-mean losses and the
    gathered adapters; the base is never written."""
    want_losses, want_params, _ = jax_side["steps"][name]
    got = port_side[name]
    _close(got["losses"], want_losses, LOSS_TOL)
    leaves = jax.tree.leaves(want_params)
    assert len(jax.tree.leaves(got["params"])) == len(leaves)
    for g, w in zip(jax.tree.leaves(got["params"]), leaves):
        _close(g, w, PARAM_TOL)
    assert got["base_kept"]
    # every replica of a leaf (its ranks along the axes it is not sharded
    # on: pp for the embedding, ep and tp for the attention weights) the
    # same, params and first-step grads
    assert got["replicas_equal"]


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_lora_step_gradients_match_the_reference(jax_side,
                                                         port_side, name):
    """The first step's adapter gradients: A's summed over tp (its
    contraction runs over the tp-split output axes) and B's over fsdp (the
    fsdp-split input axis), as well as over the data axes."""
    want = jax.tree.leaves(jax_side["steps"][name][2])
    got = jax.tree.leaves(port_side[name]["grads"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_lora_trainer_on_a_mesh_evaluates_as_the_reference(jax_side,
                                                           port_side):
    """Trainer(lora=..., mesh=fsdp2 x tp2).evaluate (the merge of the
    rank's shards) against the reference Trainer's."""
    want, got = jax_side["eval"], port_side["eval"]["eval"]
    assert got["tokens"] == want["tokens"]
    _close(got["loss"], want["loss"], LOSS_TOL)


class _Shape:
    """Axis sizes in a DeviceMesh's interface."""
    mesh_dim_names = AXES

    def __init__(self, **sizes):
        self.sizes = [sizes.get(a, 1) for a in AXES]

    def size(self, i):
        return self.sizes[i]


@pytest.mark.parametrize("case", ["pp", "bf16_params"])
def test_sharded_lora_step_refuses_as_the_reference(case):
    """A pp mesh and bf16_params: the reference's ValueError and
    message."""
    jc, lora = jt.TransformerConfig(**TINY), jl.LoRAConfig(**LORA)
    tc = dict(bf16_params=case == "bf16_params")
    sizes = {"pp": 2} if case == "pp" else {"tp": 2}
    with pytest.raises(ValueError) as want:
        jl.make_sharded_lora_step(_jax_mesh(sizes), jc, lora,
                                  tc=jtr.TrainConfig(**tc))
    with pytest.raises(ValueError) as got:
        tl.make_sharded_lora_step(_Shape(**sizes),
                                  tt.TransformerConfig(**TINY),
                                  tl.LoRAConfig(**LORA),
                                  tc=ttr.TrainConfig(**tc))
    assert str(got.value) == str(want.value)


def test_lora_specs_follow_the_reference():
    c = tt.TransformerConfig(**TINY)
    lora = tl.LoRAConfig(**LORA)
    assert tl.lora_logical_specs(c, lora) == jl.lora_logical_specs(
        jt.TransformerConfig(**TINY), jl.LoRAConfig(**LORA))
    specs = tl.lora_specs(c, lora)["blocks"]
    # A on the base's input axes, B on its output axes, the rank whole
    assert specs["wq"] == {"A": (None, "fsdp", None),
                           "B": (None, None, "tp", None)}
    assert specs["w_down"] == {"A": (None, "tp", None),
                               "B": (None, None, "fsdp")}
