"""The port's train-state checkpoints (kubeflow_tpu_torch/runtime/
checkpoint.py ``TrainCheckpointer`` and the Trainer's resume) on the CPU:
the reference's retention, interval, empty and evicted semantics
(tests/test_checkpoint.py), bit-exact round trips of the bf16
``MasterOptState``, saves that the next in-place step cannot race, a
failed background write that surfaces, a Trainer that resumes on the
uninterrupted trajectory bit for bit, and a JAX-trained state that the
port saves, restores and continues like JAX does.

Tolerances: round trips and resumed trajectories are bit-equal (the same
arithmetic on the same bits). The JAX continuation: losses 1e-5, params
2e-6 and grads 1e-5 on the plain attention path, grads 5e-4 through
flash (the reference's own pin), as tests/test_torch_train.py.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.runtime import data as tdata
from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
from kubeflow_tpu_torch.runtime.trainer import Trainer

SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=48, max_seq_len=64, dtype="float32")
TINY = dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
LOSS_TOL, PARAM_TOL = 1e-5, 2e-6
WAIT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(bf16=False, seed=0, steps=1):
    """A train state of the SMALL config after ``steps`` steps, and its
    step function."""
    tc = ttr.TrainConfig(warmup_steps=1, bf16_params=bf16)
    init_fn, step_fn = ttr.make_train_step(tt.TransformerConfig(**SMALL),
                                           tc, "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(seed))
    for tokens, targets in _batches(steps, seed=1):
        params, opt, _ = step_fn(params, opt, tokens, targets)
    return params, opt, step_fn


def _batches(n, seed):
    return [tuple(torch.from_numpy(x) for x in batch)
            for batch in tdata.synthetic_lm_batches(4, 16, 128, n_batches=n,
                                                    seed=seed)]


def _snapshot(params, opt):
    """Every leaf cloned, the host count beside them."""
    clone = ttr.tree_map(lambda t: t.detach().clone(),
                         {"params": params, "opt": _opt_tree(opt)})
    return clone, _count(opt)


def _opt_tree(opt) -> dict:
    inner = opt.inner if isinstance(opt, ttr.MasterOptState) else opt
    tree = {"mu": inner.mu, "nu": inner.nu}
    if isinstance(opt, ttr.MasterOptState):
        tree["master"] = opt.master
    return tree


def _count(opt) -> int:
    return (opt.inner if isinstance(opt, ttr.MasterOptState) else opt).count


def _assert_bit_equal(got: dict, want: dict) -> None:
    g, w = ttr.tree_leaves(got), ttr.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


# ---------------------------------------------------- the reference's cases
def test_retention_and_interval(tmp_path):
    params, opt, _ = _state()
    with TrainCheckpointer(tmp_path / "ckpt", max_to_keep=2,
                           save_interval_steps=10) as ckpt:
        assert ckpt.save(0, params, opt)
        assert not ckpt.save(5, params, opt)       # off-cadence: skipped
        assert ckpt.save(7, params, opt, force=True)
        assert ckpt.save(10, params, opt)
        assert ckpt.save(20, params, opt)
        ckpt.wait()
        assert ckpt.all_steps() == [10, 20]        # max_to_keep=2
        assert ckpt.latest_step() == 20
        assert not ckpt.save(20, params, opt)      # not newer: skipped


def test_restore_empty_dir_returns_none(tmp_path):
    params, opt, _ = _state()
    with TrainCheckpointer(tmp_path / "empty") as ckpt:
        assert ckpt.restore(params, opt) is None
        assert ckpt.restore_params(params) is None
        assert ckpt.latest_step() is None


def test_restore_evicted_step_returns_none(tmp_path):
    params, opt, _ = _state()
    with TrainCheckpointer(tmp_path / "ckpt", max_to_keep=1) as ckpt:
        ckpt.save(0, params, opt)
        ckpt.save(1, params, opt)
        ckpt.wait()
        assert ckpt.all_steps() == [1]
        assert ckpt.restore(params, opt, step=0) is None


# ------------------------------------------------------------ round trips
@pytest.mark.parametrize("bf16", [False, True])
def test_state_round_trips_bit_for_bit(tmp_path, bf16):
    """bf16 params + f32 masters (MasterOptState) and the plain f32
    state: a restore into a state of another seed gives back every leaf
    bit for bit, its dtype, the NamedTuple types and the step count."""
    params, opt, _ = _state(bf16=bf16, steps=2)
    want = _snapshot(params, opt)
    with TrainCheckpointer(tmp_path / "ckpt") as ckpt:
        assert ckpt.save(2, params, opt)
        ckpt.wait()
        like_p, like_o, _ = _state(bf16=bf16, seed=9, steps=0)
        step, r_params, r_opt = ckpt.restore(like_p, like_o)
        p_step, p_only = ckpt.restore_params(_state(bf16=bf16, seed=8,
                                                    steps=0)[0])
    assert step == p_step == 2
    assert type(r_opt) is type(opt)
    if bf16:
        assert type(r_opt.inner) is ttr.FusedAdamWState
        assert all(p.dtype == torch.bfloat16
                   for p in ttr.tree_leaves(r_params))
        assert all(m.dtype == torch.float32
                   for m in ttr.tree_leaves(r_opt.master))
    assert all(p.requires_grad for p in ttr.tree_leaves(r_params))
    got = _snapshot(r_params, r_opt)
    _assert_bit_equal(got[0], want[0])
    assert got[1] == want[1] == 2
    _assert_bit_equal(p_only, want[0]["params"])


def test_restore_rejects_another_shape(tmp_path):
    params, opt, _ = _state()
    with TrainCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(1, params, opt)
        ckpt.wait()
        wide = ttr.init_train_state(tt.init_params(
            torch.Generator().manual_seed(0),
            tt.TransformerConfig(**{**SMALL, "d_ff": 64}), "cpu"),
            ttr.TrainConfig())
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(*wide)


def test_async_save_is_not_raced_by_the_next_in_place_step(tmp_path):
    """save at step n, run step n+1 at once (it updates params, masters
    and moments in place) while the write is held back, then let the
    write finish: the checkpoint holds step n, not n+1."""
    params, opt, step_fn = _state(bf16=True, steps=1)
    want = _snapshot(params, opt)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    write, go = ckpt._write, threading.Event()

    def held_write(*args):
        assert go.wait(timeout=WAIT)
        write(*args)
    ckpt._write = held_write
    try:
        assert ckpt.save(1, params, opt)
        tokens, targets = _batches(1, seed=5)[0]
        params, opt, _ = step_fn(params, opt, tokens, targets)
        moved = _snapshot(params, opt)
        go.set()
        ckpt.wait()
        restored = ckpt.restore(*_state(bf16=True, seed=3, steps=0)[:2])
    finally:
        go.set()
        ckpt.close()
    got = _snapshot(restored[1], restored[2])
    _assert_bit_equal(got[0], want[0])
    assert got[1] == 1 and moved[1] == 2
    assert not torch.equal(ttr.tree_leaves(moved[0])[0],
                           ttr.tree_leaves(want[0])[0])


@pytest.mark.parametrize("surfaces_at", ["wait", "save", "close"])
def test_failed_background_write_raises(tmp_path, surfaces_at):
    params, opt, _ = _state()
    ckpt = TrainCheckpointer(tmp_path / "ckpt")

    def full(*_):
        raise OSError("no space left on device")
    ckpt._write = full
    assert ckpt.save(1, params, opt)            # the write fails later
    with pytest.raises(OSError, match="no space"):
        if surfaces_at == "wait":
            ckpt.wait()
        elif surfaces_at == "save":
            ckpt._writes[0][1].exception(timeout=WAIT)
            ckpt.save(2, params, opt)
        else:
            ckpt.close()
    ckpt.close()                                 # raised once, not again
    assert ckpt.all_steps() == []


def test_half_written_step_is_never_listed(tmp_path, monkeypatch):
    """A write that dies before its rename leaves no step behind."""
    params, opt, _ = _state()
    saver, calls = torch.save, []

    def dying_save(obj, fh):
        calls.append(1)
        if len(calls) == 2:                      # opt_state.pt
            raise OSError("died mid-write")
        saver(obj, fh)
    monkeypatch.setattr(torch, "save", dying_save)
    with TrainCheckpointer(tmp_path / "ckpt", async_save=False) as ckpt:
        with pytest.raises(OSError, match="mid-write"):
            ckpt.save(3, params, opt)
        assert ckpt.all_steps() == [] and ckpt.restore(params, opt) is None
    assert list((tmp_path / "ckpt").iterdir()) == []


# ---------------------------------------------------------------- Trainer
def _small():
    return tt.TransformerConfig(**SMALL)


def _steps(directory):
    with TrainCheckpointer(directory, async_save=False) as ckpt:
        return ckpt.all_steps()


def test_trainer_resumes_on_the_uninterrupted_trajectory(tmp_path):
    """7 steps in one Trainer against 4 steps (checkpoints every 2), a
    new Trainer on the same directory, 3 more: it resumes at step 4 and
    its continued losses and final state equal the uninterrupted run's
    bit for bit."""
    tc = ttr.TrainConfig(warmup_steps=2, bf16_params=True)
    data = list(tdata.synthetic_lm_batches(4, 16, 128, n_batches=7, seed=3))
    with Trainer(_small(), tc, device="cpu") as whole:
        whole.fit(data, steps=7, log_every=1)
    with Trainer(_small(), tc, device="cpu", checkpoint_dir=tmp_path,
                 checkpoint_interval=2, max_checkpoints=3) as first:
        first.fit(data[:4], steps=4, log_every=1)
    assert _steps(tmp_path) == [2, 4]
    with Trainer(_small(), tc, device="cpu", seed=11,
                 checkpoint_dir=tmp_path, checkpoint_interval=2) as resumed:
        assert resumed.stats.step == 4
        resumed.fit(data[4:], steps=3, log_every=1)
        assert [s for s, _ in resumed.stats.losses] == [5, 6, 7]
        assert list(resumed.stats.losses) == list(whole.stats.losses)[4:]
        _assert_bit_equal(_snapshot(resumed.params, resumed.opt_state)[0],
                          _snapshot(whole.params, whole.opt_state)[0])
        assert _count(resumed.opt_state) == 7
    # the interval saved step 6; max_checkpoints=3 keeps 2, 4 and 6
    assert _steps(tmp_path) == [2, 4, 6]


def test_trainer_save_is_idempotent(tmp_path):
    with Trainer(_small(), ttr.TrainConfig(warmup_steps=1), device="cpu",
                 checkpoint_dir=tmp_path, checkpoint_interval=2) as tr:
        tr.fit(_np_batches(3), steps=3, log_every=3)
        tr.save()                    # step 3 is off the interval: forced
        tr.save()                    # written already: nothing again
        assert tr.checkpointer.all_steps() == [2, 3]
    with Trainer(_small(), device="cpu", checkpoint_dir=tmp_path) as again:
        assert again.stats.step == 3


def test_trainer_without_a_checkpoint_starts_at_step_zero(tmp_path):
    with Trainer(_small(), device="cpu", checkpoint_dir=tmp_path / "new",
                 checkpoint_interval=100) as tr:
        assert tr.stats.step == 0
        tr.fit(_np_batches(2), steps=2)
        assert tr.checkpointer.all_steps() == []


def _np_batches(n):
    return list(tdata.synthetic_lm_batches(4, 16, 128, n_batches=n, seed=4))


# ----------------------------------------------------------- JAX parity
def _jax_batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, TINY["vocab_size"], (4, 16)).astype(
            np.int32)
        targets = np.roll(tokens, -1, axis=1)
        targets[rng.random(tokens.shape) < 0.1] = -1
        out.append((tokens, targets))
    return out


@pytest.mark.parametrize("attention,grad_tol", [("xla", 1e-5),
                                                ("flash", 5e-4)])
def test_jax_trained_state_continues_through_a_port_checkpoint(
        tmp_path, attention, grad_tol):
    """JAX trains 2 steps on a one-device mesh; its params and AdamW
    state (converted, opt_state_to_torch) go through the port's
    checkpoint into a fresh port state, bit for bit. From there the
    port's grads equal jax.grad's and both continue 2 steps on the same
    batches: the losses and params agree at the train tolerances."""
    jc = jt.TransformerConfig(**TINY, attention=attention)
    tc_port = tt.TransformerConfig(**dataclasses.asdict(jc))
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    init_fn, step_fn = jtr.make_sharded_train_step(
        mesh, jc, jtr.TrainConfig(warmup_steps=2))
    jp, jo = init_fn(jax.random.key(0))
    before, after = _jax_batches(2, seed=30), _jax_batches(2, seed=31)
    for tokens, targets in before:
        jp, jo, _ = step_fn(jp, jo, jnp.asarray(tokens),
                            jnp.asarray(targets))
    moved_p = convert.to_torch(jax.tree.map(np.asarray, jp))
    moved_o = convert.opt_state_to_torch(jax.tree.map(np.asarray, jo))
    assert moved_o.count == 2

    tc = ttr.TrainConfig(warmup_steps=2)
    port_init, port_step = ttr.make_train_step(tc_port, tc, "cpu")
    with TrainCheckpointer(tmp_path / "ckpt") as ckpt:
        assert ckpt.save(2, moved_p, moved_o)
        ckpt.wait()
        step, tp, to = ckpt.restore(*port_init(
            torch.Generator().manual_seed(5)))
    assert step == 2 and to.count == 2
    _assert_bit_equal(tp, moved_p)
    _assert_bit_equal({"mu": to.mu, "nu": to.nu},
                      {"mu": moved_o.mu, "nu": moved_o.nu})

    tokens, targets = after[0]
    want_g = jax.jit(jax.grad(jtr.loss_fn), static_argnums=3)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    _, got_g = ttr.value_and_grad(
        ttr.build_loss(tc_port, tc), tp, torch.from_numpy(tokens),
        torch.from_numpy(targets))
    for g, w in zip(ttr.tree_leaves(got_g), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=grad_tol,
                                   atol=grad_tol)

    want_l, got_l = [], []
    for tokens, targets in after:
        jp, jo, jl = step_fn(jp, jo, jnp.asarray(tokens),
                             jnp.asarray(targets))
        tp, to, tl = port_step(tp, to, torch.from_numpy(tokens),
                               torch.from_numpy(targets))
        want_l.append(float(jl))
        got_l.append(tl.item())
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_TOL, atol=LOSS_TOL)
    for g, w in zip(ttr.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)
    assert to.count == convert.opt_state_to_torch(
        jax.tree.map(np.asarray, jo)).count == 4
