"""The port's slice bootstrap (kubeflow_tpu_torch/runtime/bootstrap.py)
against the reference's (kubeflow_tpu/runtime/bootstrap.py).

The env parsing and the expected counts get the reference's answers on
tests/test_runtime.py's inputs, the accelerator names mapped to the H100
table (``v5e-16``, 4 workers of 4 chips, becomes ``h100-32``, 4 workers
of 8 cards; each count comes from its own package's table). A world of
one is formed in this process on gloo; the reference's two-worker
tests/test_multihost.py (``slow``) runs here as a fast case: two OS
processes (tests/torch_dist_ranks.py ``bootstrap_worker``) get the env
the controller injects, form a gloo world through ``initialize_slice``
and run ``make_sharded_train_step`` at dp 2 from the JAX step's own
init. Their losses are held to the reference's step at dp 2 to 1e-5 and
the updated params to 2e-6 (tests/test_torch_sharded_train.py's
tolerances).
"""

from __future__ import annotations

import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime import bootstrap as jboot
from kubeflow_tpu.tpu import topology as jtopo
from kubeflow_tpu_torch.gpu import topology as ttopo
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel.mesh import leave_world
from kubeflow_tpu_torch.runtime import bootstrap as tboot

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
WORKER_TIMEOUT = 120

HOSTS = ",".join(f"nb-{i}.nb-workers.ns.svc" for i in range(4))
# (name, the reference's env, the port's env): test_runtime.py's inputs
ENVS = [
    ("four_workers",
     {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": HOSTS,
      "TPU_ACCELERATOR_TYPE": "v5e-16", "TPU_TOPOLOGY": "4x4"},
     {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": HOSTS,
      "TPU_ACCELERATOR_TYPE": "h100-32", "TPU_TOPOLOGY": "4x8"}),
    ("defaults", {}, {}),
    ("bad_port", {"KFTPU_COORDINATOR_PORT": "http"},
     {"KFTPU_COORDINATOR_PORT": "http"}),
    ("port", {"KFTPU_COORDINATOR_PORT": "9000",
              "TPU_WORKER_HOSTNAMES": "a, b"},
     {"KFTPU_COORDINATOR_PORT": "9000", "TPU_WORKER_HOSTNAMES": "a, b"}),
]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("name,ref_env,port_env", ENVS,
                         ids=[e[0] for e in ENVS])
def test_slice_env_matches_the_reference(name, ref_env, port_env):
    ref = jboot.SliceEnv.from_env(ref_env)
    got = tboot.SliceEnv.from_env(port_env)
    for field in ("worker_id", "hostnames", "num_workers", "multi_host",
                  "coordinator_address", "coordinator_port"):
        assert getattr(got, field) == getattr(ref, field), field
    want = jtopo.parse_short_name(ref.accelerator).chips \
        if ref.accelerator else ref.num_workers
    assert jboot.expected_device_count(ref) == want
    want = ttopo.parse_short_name(got.accelerator).cards \
        if got.accelerator else got.num_workers
    assert tboot.expected_device_count(got) == want


def test_expected_device_count_fallback():
    for accelerator in ("", "h100-3"):   # none, and one that does not parse
        env = tboot.SliceEnv(worker_id=0, hostnames=("a", "b"),
                             accelerator=accelerator)
        ref = jboot.SliceEnv(worker_id=0, hostnames=("a", "b"))
        assert tboot.expected_device_count(env, cards_per_worker=4) == \
            jboot.expected_device_count(ref, chips_per_worker=4) == 8
        assert tboot.expected_device_count(env) == 2


@pytest.fixture
def world_of_one():
    env = tboot.SliceEnv(0, ("localhost",), coordinator_port=_free_port())
    tboot.initialize_slice(env, device="cpu", timeout=30)
    try:
        yield env
    finally:
        leave_world()
    assert tmesh._world_timeout is None


def test_world_of_one_reports_the_references_keys(world_of_one):
    report = tboot.verify_slice(world_of_one, expected=1, timeout_s=5)
    ref = jboot.verify_slice(jboot.SliceEnv(0, ("localhost",)), expected=1,
                             timeout_s=5)
    assert set(report) == set(ref)
    assert report["backend"] == "gloo"
    assert report["device_count"] == report["local_device_count"] == 1
    # the meshes built in the world get its timeout
    assert tmesh._world_timeout.total_seconds() == 30
    # initialize_slice is idempotent on a world of the slice's size, and
    # refuses one of another size
    assert tboot.initialize_slice(world_of_one, device="cpu") is world_of_one
    with pytest.raises(RuntimeError, match="already formed"):
        tboot.initialize_slice(
            tboot.SliceEnv(0, ("localhost", "localhost")), device="cpu")


def test_a_wrong_expectation_raises_timeout(world_of_one):
    env = tboot.SliceEnv(0, ("localhost",), accelerator="h100-16")
    with pytest.raises(TimeoutError):
        tboot.verify_slice(env, timeout_s=0.1)
    with pytest.raises(TimeoutError):
        jboot.verify_slice(jboot.SliceEnv(0, ("localhost",),
                                          accelerator="v5e-16"),
                           timeout_s=0.1)


def test_no_cpu_fallback():
    """Without CUDA, initialize_slice raises unless the CPU is asked for,
    and forms no world; verify_slice without a world raises."""
    env = tboot.SliceEnv(0, ("localhost",), coordinator_port=_free_port())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tboot.initialize_slice(env)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tboot.initialize_slice(env, device="cuda")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_slice"):
        tboot.verify_slice(env, expected=1)


def test_a_rank_whose_coordinator_is_absent_fails_within_the_timeout():
    env = tboot.SliceEnv(1, ("localhost", "localhost"),
                         coordinator_port=_free_port())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        tboot.initialize_slice(env, device="cpu", timeout=2)
    assert time.monotonic() - t0 < 20
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,kw,local_env,want", [
    # cards per worker from the node table: worker 1 of h100-16, card 3
    (dict(worker_id=1, hostnames=("w0", "w1"), accelerator="h100-16"),
     {"local_rank": 3}, None, (11, 16)),
    # LOCAL_RANK when no local rank is passed
    (dict(worker_id=1, hostnames=("w0", "w1"), accelerator="h100-16"),
     {}, "5", (13, 16)),
    # the caller's count when the accelerator does not parse, else 1
    (dict(worker_id=1, hostnames=("w0", "w1"), accelerator="v5e-16"),
     {"cards_per_worker": 4, "local_rank": 2}, None, (6, 8)),
    (dict(worker_id=1, hostnames=("w0", "w1")), {}, None, (1, 2)),
], ids=["table", "local_rank_env", "argument", "one_card"])
def test_rank_layout(monkeypatch, env, kw, local_env, want):
    """rank = worker id x cards per worker + local rank, world = workers
    x cards per worker, the rendezvous at worker 0."""
    joined = {}
    monkeypatch.setattr(tboot, "join_world",
                        lambda dev, **k: joined.update(k, dev=dev))
    if local_env is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_env)
    tboot.initialize_slice(tboot.SliceEnv(**env, coordinator_port=1234),
                           device="cpu", timeout=7, **kw)
    assert (joined["rank"], joined["world_size"]) == want
    assert joined["init_method"] == "tcp://w0:1234"
    assert joined["timeout"] == 7
    assert joined["dev"].type == "cpu"


def test_local_rank_outside_the_worker_is_refused():
    env = tboot.SliceEnv(0, ("localhost",), accelerator="h100-4")
    with pytest.raises(ValueError, match="local rank 4"):
        tboot.initialize_slice(env, device="cpu", local_rank=4)
    assert not dist.is_initialized()


# ------------------------------------------------ two workers, one world
def _batches(n=2, b=4, s=32, seed=20, pad_frac=0.1):
    tokens, targets = [], []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        t = rng.integers(0, TINY["vocab_size"], (b, s))
        tg = np.roll(t, -1, axis=1)
        tg[rng.random(tg.shape) < pad_frac] = -1
        tokens.append(t.astype(np.int32))
        targets.append(tg.astype(np.int32))
    return np.stack(tokens), np.stack(targets)


def _flatten(tree, prefix="params"):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_two_workers_form_one_world_and_train_as_the_reference(tmp_path):
    tokens, targets = _batches()
    mesh = build_mesh(MeshConfig(dp=2), devices=jax.devices()[:2])
    init_fn, step_fn = jtr.make_sharded_train_step(
        mesh, jt.TransformerConfig(**TINY), jtr.TrainConfig(warmup_steps=2))
    params, opt = init_fn(jax.random.key(0))
    job = tmp_path / "job.npz"
    np.savez(job, tokens=tokens, targets=targets,
             config=np.array(json.dumps(TINY)), **_flatten(params))
    want_losses = []
    for t, tg in zip(tokens, targets):
        params, opt, loss = step_fn(params, opt, jnp.asarray(t),
                                    jnp.asarray(tg))
        want_losses.append(float(loss))

    port = str(_free_port())
    procs = []
    for worker_id in (0, 1):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   TPU_WORKER_ID=str(worker_id),
                   TPU_WORKER_HOSTNAMES="localhost,localhost",
                   KFTPU_COORDINATOR_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_ranks.py"),
             str(job), str(tmp_path / f"out{worker_id}.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for worker_id, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {worker_id}:\n{err[-3000:]}"

    want_params = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for worker_id in (0, 1):
        with open(tmp_path / f"out{worker_id}.pkl", "rb") as fh:
            got = pickle.load(fh)
        assert got["report"]["worker_id"] == worker_id
        assert got["report"]["device_count"] == 2
        assert got["report"]["local_device_count"] == 1
        assert got["report"]["backend"] == "gloo"
        assert got["replicas_equal"]
        np.testing.assert_allclose(got["losses"], want_losses,
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        mine = jax.tree.leaves(got["params"])
        assert len(mine) == len(want_params)
        for g, w in zip(mine, want_params):
            np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL)
