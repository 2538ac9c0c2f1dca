"""The port's LoRA finetuning (kubeflow_tpu_torch/models/lora.py, the
Trainer's lora mode, the server's --lora-config/--lora-checkpoint) against
the JAX package on the same params.

Config: vocab 128, d_model 64, 2 layers, 4 heads, 2 KV heads, d_ff 128,
float32; ``LoRAConfig()`` (rank 8, alpha 16, wq/wk/wv/wo) unless a case
says otherwise. JAX params and adapters are carried across with
convert.py; the JAX side's flash kernels run in interpret mode.

Tolerances: a zero-init adapter merges to the base bit for bit; merge in
f32 1e-6, in bf16 one bf16 ulp; adapter-step losses 1e-4 relative and
adapters 2e-6 (Adam moves a weight by at most ~lr a step); greedy ids
exact.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import lora as jl
from kubeflow_tpu.models import train as jtr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime import data as jdata
from kubeflow_tpu.runtime.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import lora as tl
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.runtime import server as torch_server
from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
from kubeflow_tpu_torch.runtime.trainer import Trainer

V = 128
TINY = dict(vocab_size=V, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=64, dtype="float32")
LOSS_RTOL = 1e-4
PARAM_TOL = 2e-6
WAIT = 120


def _configs(**kw):
    jc = jt.TransformerConfig(**{**TINY, **kw})
    return jc, tt.TransformerConfig(**dataclasses.asdict(jc))


def _t_leaves(tree):
    return [x.detach().float().numpy() for x in ttr.tree_leaves(tree)]


def _batch(seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (b, s)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    return tokens, targets


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base():
    """(JAX base params, numpy base params)."""
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0),
                                                   _configs()[0])
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def adapters():
    """JAX adapters with a nonzero B (a trained adapter's shape of
    values), as numpy."""
    jc, _ = _configs()
    lp = jl.init_lora_params(jax.random.key(3), jc, jl.LoRAConfig())
    rng = np.random.default_rng(4)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), lp)


# ------------------------------------------------------------------- merge
def test_zero_init_adapter_is_identity(base):
    _, np_params = base
    _, tc = _configs()
    tp = convert.to_torch(np_params)
    lp = tl.init_lora_params(torch.Generator().manual_seed(0), tc,
                             tl.LoRAConfig(), device="cpu")
    assert sorted(lp["blocks"]) == ["wk", "wo", "wq", "wv"]
    assert all(torch.count_nonzero(ab["B"]) == 0
               for ab in lp["blocks"].values())
    merged = tl.merge_lora(tp, lp, tl.LoRAConfig())
    for a, b in zip(ttr.tree_leaves(merged), ttr.tree_leaves(tp)):
        assert torch.equal(a, b)
    tokens = torch.from_numpy(_batch(1)[0])
    assert torch.equal(tt.forward(merged, tokens, tc),
                       tt.forward(tp, tokens, tc))


def test_init_shapes_and_scale_follow_the_reference():
    jc, tc = _configs()
    lcfg = tl.LoRAConfig(targets=("wo", "w_down", "wq"))
    lp = tl.init_lora_params(torch.Generator().manual_seed(0), tc, lcfg,
                             device="cpu")
    want = jax.eval_shape(lambda: jl.init_lora_params(
        jax.random.key(0), jc, jl.LoRAConfig(targets=lcfg.targets)))
    got = jax.tree.map(lambda t: tuple(t.shape), lp)
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    a = lp["blocks"]["wo"]["A"]           # fan-in heads x head_dim = 64
    assert abs(a.std().item() - 1 / 8) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(base, adapters, dtype):
    """A bf16 base merges as the reference's: the delta is cast to bf16
    before the add."""
    jp, _ = base
    jdt = jnp.dtype(dtype)
    jbase = jax.tree.map(lambda p: p.astype(jdt), jp)
    want = jax.jit(jl.merge_lora, static_argnums=2)(
        jbase, jax.tree.map(jnp.asarray, adapters), jl.LoRAConfig())
    got = tl.merge_lora(convert.to_torch(jax.tree.map(np.asarray, jbase)),
                        convert.to_torch(adapters), tl.LoRAConfig())
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for g, w in zip(ttr.tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == tt._DTYPES[dtype]
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=tol, atol=tol)


# ------------------------------------------------------------------- steps
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_three_adapter_steps_match_the_sharded_lora_step(base, attention):
    """Adapters and their AdamW state from the reference's init_fn, 3 steps
    on both sides (warmup 2): the losses, the adapters after them, and a
    base that neither step wrote."""
    jp, np_params = base
    jc, tc = _configs(attention=attention)
    lcfg = jl.LoRAConfig()
    tcfg = dict(warmup_steps=2)
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    init_fn, step_fn = jl.make_sharded_lora_step(mesh, jc, lcfg,
                                                 jtr.TrainConfig(**tcfg))
    jlp, jopt = init_fn(jax.random.key(3))
    start = jax.tree.map(np.asarray, jlp)
    _, port_step = tl.make_lora_step(tc, tl.LoRAConfig(),
                                     ttr.TrainConfig(**tcfg), device="cpu")
    tp = convert.to_torch(np_params)
    before = [t.clone() for t in ttr.tree_leaves(tp)]
    lp = ttr.tree_map(lambda p: p.requires_grad_(), convert.to_torch(start))
    opt = ttr.make_optimizer(ttr.TrainConfig(**tcfg)).init(lp)
    want, got = [], []
    for i in range(3):
        tokens, targets = _batch(10 + i)
        jlp, jopt, loss = step_fn(jp, jlp, jopt, jnp.asarray(tokens),
                                  jnp.asarray(targets))
        want.append(float(loss))
        lp, opt, loss = port_step(tp, lp, opt, torch.from_numpy(tokens),
                                  torch.from_numpy(targets))
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for g, w in zip(_t_leaves(lp), jax.tree.leaves(jlp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    assert opt.count == 3
    for a, b in zip(ttr.tree_leaves(tp), before):
        assert torch.equal(a, b) and not a.requires_grad


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_refusals_use_the_reference_messages(base):
    """bf16_params for the adapter step, LoRA on an MoE config, and lora
    mode without base params: each refused as the reference refuses it."""
    jp, np_params = base
    jc, tc = _configs()
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    bf16 = _message(lambda: tl.make_lora_step(
        tc, tl.LoRAConfig(), ttr.TrainConfig(bf16_params=True),
        device="cpu"))
    assert bf16 == _message(lambda: jl.make_sharded_lora_step(
        mesh, jc, jl.LoRAConfig(), jtr.TrainConfig(bf16_params=True)))
    with pytest.raises(ValueError, match="bf16_params is a dense-step"):
        Trainer(tc, ttr.TrainConfig(bf16_params=True), device="cpu",
                lora=tl.LoRAConfig(), base_params=convert.to_torch(
                    np_params))
    moe = tm.MoEConfig(**dataclasses.asdict(tc))
    with pytest.raises(ValueError, match="LoRA targets the dense family; "
                                         "MoE adapter routing is not "
                                         "implemented"):
        Trainer(moe, device="cpu", lora=tl.LoRAConfig(),
                base_params=convert.to_torch(np_params))
    with pytest.raises(ValueError, match=r"lora mode requires base_params "
                                         r"\(the pretrained weights being "
                                         r"finetuned\)"):
        Trainer(tc, device="cpu", lora=tl.LoRAConfig())


def test_lora_num_params_and_config_validation():
    from kubeflow_tpu_torch.tools.train_step_time import FLAGSHIP
    jflag = jt.TransformerConfig(**dataclasses.asdict(FLAGSHIP))
    assert tl.lora_num_params(FLAGSHIP, tl.LoRAConfig()) == 688_128 == \
        jl.lora_num_params(jflag, jl.LoRAConfig())
    targets = ("w_gate", "w_up", "w_down", "wo")
    jc, tc = _configs()
    assert tl.lora_num_params(tc, tl.LoRAConfig(rank=4, targets=targets)) \
        == jl.lora_num_params(jc, jl.LoRAConfig(rank=4, targets=targets))
    assert tl.LoRAConfig(rank=4, alpha=2.0).scale == 0.5
    for kw in (dict(rank=0), dict(targets=("wq", "w_fused", "bias"))):
        assert _message(lambda: tl.LoRAConfig(**kw)) == \
            _message(lambda: jl.LoRAConfig(**kw))


# ----------------------------------------------------------------- trainer
def test_adapter_trainer_checkpoints_adapters_and_resumes_bit_equal(
        base, tmp_path):
    """Trainer A (lora mode) checkpoints its step 4: adapters and their
    optimizer state only. Trainer B resumes there; both run steps 5 and
    6 and agree bit for bit; the base is untouched."""
    _, np_params = base
    _, tc = _configs()
    tp = convert.to_torch(np_params)
    before = [t.clone() for t in ttr.tree_leaves(tp)]
    tcfg = ttr.TrainConfig(warmup_steps=2, learning_rate=1e-2)
    batches = [_batch(30 + i) for i in range(6)]
    kw = dict(device="cpu", lora=tl.LoRAConfig(), base_params=tp,
              checkpoint_dir=tmp_path)
    with Trainer(tc, tcfg, checkpoint_interval=4, max_checkpoints=1,
                 **kw) as a:
        a.fit(batches[:4], steps=4, log_every=1)
        a.checkpointer.wait()
        manifest = json.loads((tmp_path / "4" / "manifest.json").read_text())
        assert sorted(manifest["trees"]["params"]["dict"]["blocks"]["dict"]) \
            == ["wk", "wo", "wq", "wv"]
        assert "embed" not in manifest["trees"]["params"]["dict"]
        with Trainer(tc, tcfg, seed=9, **kw) as b:
            assert b.stats.step == 4
            a.fit(batches[4:], steps=2, log_every=1)
            b.fit(batches[4:], steps=2, log_every=1)
            assert [x for _, x in a.stats.losses][-2:] == \
                [x for _, x in b.stats.losses]
            for x, y in zip(ttr.tree_leaves(a.params),
                            ttr.tree_leaves(b.params)):
                assert torch.equal(x, y)
        assert a.stats.losses[-1][1] < a.stats.losses[0][1]
    for x, y in zip(ttr.tree_leaves(tp), before):
        assert torch.equal(x, y)


def test_lora_trainer_evaluates_the_merged_model(base, adapters):
    """evaluate() on the merged tree equals the JAX lora-mode Trainer's on
    the same base and adapters; merged_params() is merge_lora."""
    jp, np_params = base
    jc, tc = _configs()
    heldout = list(jdata.synthetic_lm_batches(4, 16, V, seed=3,
                                              n_batches=2))
    mesh = build_mesh(MeshConfig.auto(1), devices=jax.devices()[:1])
    with JaxTrainer(mesh, jc, lora=jl.LoRAConfig(), base_params=jp) as jtrn:
        jtrn.params = jax.tree.map(jnp.asarray, adapters)
        want = jtrn.evaluate(heldout)
    tp = convert.to_torch(np_params)
    with Trainer(tc, device="cpu", lora=tl.LoRAConfig(),
                 base_params=tp) as tr:
        tr.params = convert.to_torch(adapters)
        got = tr.evaluate(heldout)
        merged = tr.merged_params()
        ref = tl.merge_lora(tp, tr.params, tl.LoRAConfig())
    assert got["tokens"] == want["tokens"]
    assert abs(got["loss"] - want["loss"]) < 1e-5
    for a, b in zip(ttr.tree_leaves(merged), ttr.tree_leaves(ref)):
        assert torch.equal(a, b)
    with Trainer(tc, device="cpu") as plain, \
            pytest.raises(ValueError, match="merged_params"):
        plain.merged_params()


# ------------------------------------------------------------------ server
def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("engine", ["bucketed", "continuous"])
def test_server_serves_the_jax_merged_ids(base, tmp_path, engine):
    """A lora-mode Trainer's checkpoint served with --checkpoint (the base),
    --lora-config and --lora-checkpoint: the greedy ids of JAX generate on
    the JAX-merged params."""
    jp, np_params = base
    jc, tc = _configs()
    tp = convert.to_torch(np_params)
    with TrainCheckpointer(tmp_path / "base") as ckpt:
        ckpt.save(1, *ttr.init_train_state(tp, ttr.TrainConfig()))
    lcfg = tl.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
    with Trainer(tc, ttr.TrainConfig(warmup_steps=1, learning_rate=1e-2),
                 device="cpu", lora=lcfg, base_params=tp,
                 checkpoint_dir=tmp_path / "lora",
                 checkpoint_interval=1) as tr:
        tr.fit([_batch(40 + i) for i in range(2)], steps=2)
        trained = convert.to_numpy(tr.params)
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    (tmp_path / "lora.json").write_text(json.dumps(dict(
        rank=4, alpha=8.0, targets=["wq", "wv", "wo"])))
    srv = torch_server.build_server([
        "--device", "cpu", "--port", "0", "--engine", engine,
        "--config", str(tmp_path / "model.json"),
        "--checkpoint", str(tmp_path / "base"),
        "--lora-config", str(tmp_path / "lora.json"),
        "--lora-checkpoint", str(tmp_path / "lora")]).start()
    prompt = _batch(50)[0][0, :7]
    try:
        ids = _post(srv.url, {"prompt": prompt.tolist(),
                              "max_new_tokens": 8})["ids"]
    finally:
        srv.stop()
    jmerged = jl.merge_lora(jp, jax.tree.map(jnp.asarray, trained),
                            jl.LoRAConfig(rank=4, alpha=8.0,
                                          targets=("wq", "wv", "wo")))
    want = np.asarray(jd.generate(jmerged, jnp.asarray(prompt)[None], jc,
                                  8))[0].tolist()
    assert ids == want
    assert all(np.abs(trained["blocks"][t]["B"]).max() > 0
               for t in ("wq", "wv", "wo"))


def test_server_exits_on_an_empty_adapter_directory(tmp_path):
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    (tmp_path / "lora.json").write_text("{}")
    with pytest.raises(SystemExit, match="no adapter checkpoint found in"):
        torch_server.build_server([
            "--device", "cpu", "--config", str(tmp_path / "model.json"),
            "--lora-config", str(tmp_path / "lora.json"),
            "--lora-checkpoint", str(tmp_path)])


def test_adapter_tree_round_trips_exactly(adapters):
    back = convert.to_numpy(convert.to_torch(adapters))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(adapters)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
