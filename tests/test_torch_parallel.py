"""The port's multi-device layer (kubeflow_tpu_torch/parallel: mesh,
partition rules, collectives, ring and Ulysses attention) against the
JAX package's ``kubeflow_tpu.parallel``.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted. The port's side runs in gloo worlds of
spawned processes (tests/torch_dist_ranks.py, which imports no JAX; each
rank one torch thread), started once for the module with a timeout on
the rendezvous, every collective and the join, so a deadlocked rank
fails the module instead of hanging it.

Tolerances (f32): attention outputs 2e-5 and grads 5e-4, the reference's
own pins for its attention kernels (tests/test_ops.py): the ring
accumulates its blocks in another order than the reference's autodiff,
and Ulysses' local attention is the plain one on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import partition_rules as jpr
from kubeflow_tpu.parallel import ring as jring
from kubeflow_tpu.parallel import sharding as jsh
from kubeflow_tpu.parallel import ulysses as jul
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import partition_rules as tpr
from kubeflow_tpu_torch.parallel import sharding as tsh

import torch_dist_ranks

OUT_TOL = 2e-5
GRAD_TOL = 5e-4
WORLD = 4
SPAWN_TIMEOUT = 240.0       # the whole world, join included
COLLECTIVE_TIMEOUT = 60.0   # the rendezvous and each collective

# (name, fn, mesh, causal, heads, kv heads); b 2, s 32, d 16
ATTENTION = [
    ("ring_sp2_causal", "ring", {"sp": 2}, True, 4, 4),
    ("ring_sp2_full", "ring", {"sp": 2}, False, 4, 4),
    ("ring_sp4_causal", "ring", {"sp": 4}, True, 4, 4),
    ("ring_sp4_full", "ring", {"sp": 4}, False, 4, 4),
    ("ring_sp2_tp2_causal", "ring", {"sp": 2, "tp": 2}, True, 4, 4),
    # GQA: the un-repeated K/V exchanged, then repeated
    ("ulysses_sp2_gqa", "ulysses", {"sp": 2}, True, 4, 2),
    # kv heads (2) do not divide over sp (4): repeated before the exchange
    ("ulysses_sp4_gqa", "ulysses", {"sp": 4}, True, 4, 2),
    # kv heads (1) do not divide over tp (2): replicated over tp
    ("ulysses_sp2_tp2_kv1", "ulysses", {"sp": 2, "tp": 2}, True, 4, 1),
    ("ulysses_sp2_tp2_gqa_full", "ulysses", {"sp": 2, "tp": 2}, False, 8, 4),
]


def _jax_mesh(sizes: dict):
    cfg = jmesh.MeshConfig(**sizes)
    return jmesh.build_mesh(cfg, devices=jax.devices()[:cfg.size])


def _attention_inputs(seed, heads, kv_heads, b=2, s=32, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, heads, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kv_heads, d), dtype=np.float32)
            for _ in range(2))
    dout = rng.standard_normal((b, s, heads, d), dtype=np.float32)
    return q, k, v, dout


def _jax_attention(fn, sizes, causal, q, k, v, dout):
    """The reference's output and (dq, dk, dv) for cotangent dout; ring
    takes K/V repeated to q's heads, as the model calls it."""
    mesh = _jax_mesh(sizes)
    n_rep = q.shape[2] // k.shape[2]
    if fn == "ring":
        def f(q, k, v):
            return jring.ring_attention(q, jt.repeat_kv(k, n_rep),
                                        jt.repeat_kv(v, n_rep), mesh=mesh,
                                        causal=causal)
    else:
        def f(q, k, v):
            return jul.ulysses_attention(q, k, v, mesh=mesh, causal=causal,
                                         n_rep=n_rep)
    out, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(dout)))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One gloo world of 4 spawned ranks runs every multi-rank case;
    returns (the cases, rank 0's results)."""
    cases = []
    for i, (name, fn, sizes, causal, h, g) in enumerate(ATTENTION):
        q, k, v, dout = _attention_inputs(i, h, g)
        # ring's K/V come repeated to q's heads; under tp, kv heads that
        # do not divide over tp stay whole (replicated) on every rank
        if fn == "ring":
            k, v = (np.repeat(x, h // g, axis=2) for x in (k, v))
        cases.append(dict(kind="attention", name=name, fn=fn, mesh=sizes,
                          causal=causal, n_rep=q.shape[2] // k.shape[2],
                          q=q, k=k, v=v, dout=dout,
                          kv_replicated=k.shape[2] % sizes.get("tp", 1) != 0))
    rng = np.random.default_rng(9)
    arrays = {
        "wq": ((None, "dp", "tp", None),
               rng.standard_normal((2, 4, 4, 3), dtype=np.float32)),
        "embed": (("tp", "dp"), rng.standard_normal((6, 4),
                                                    dtype=np.float32)),
        "two_axes_one_dim": ((("dp", "tp"), None),
                             rng.standard_normal((8, 3), dtype=np.float32)),
        "replicated": ((None, None), rng.standard_normal(
            (3, 5), dtype=np.float32)),
    }
    cases += [dict(kind="comm"), dict(kind="hybrid"),
              dict(kind="placements", arrays=arrays)]
    out = tmesh.spawn(
        torch_dist_ranks.parallel_suite, WORLD, cases,
        device="cpu", timeout=SPAWN_TIMEOUT,
        collective_timeout=COLLECTIVE_TIMEOUT,
        store_dir=str(tmp_path_factory.mktemp("world")))
    return {c.get("name", c["kind"]): c for c in cases}, out[0]


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,kw", [(8, {}), (8, {"tp": 2}),
                                  (8, {"tp": 2, "sp": 2}),
                                  (8, {"tp": 2, "fsdp": 2}),
                                  (6, {"tp": 2}), (4, {"pp": 2, "ep": 2})])
def test_mesh_config_auto_matches(n, kw):
    want = jmesh.MeshConfig.auto(n, **kw)
    got = tmesh.MeshConfig.auto(n, **kw)
    assert got.axis_sizes() == want.axis_sizes()
    assert got.size == want.size == n


def test_axes_and_auto_refusals_match():
    assert tmesh.AXES == jmesh.AXES
    for bad in (dict(n_devices=6, tp=4), dict(n_devices=8, tp=2, fsdp=3)):
        with pytest.raises(ValueError):
            jmesh.MeshConfig.auto(**bad)
        with pytest.raises(ValueError):
            tmesh.MeshConfig.auto(**bad)


def test_group_by_slice_matches():
    class Dev:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s
    devs = [Dev(i, s) for i, s in enumerate([1, 0, 1, 0, 2])]
    want = [[d.id for d in g] for g in jmesh.group_by_slice(devs)]
    assert [[d.id for d in g] for g in tmesh.group_by_slice(devs)] == want
    assert tmesh.group_by_slice(range(4)) == [[0, 1, 2, 3]]


def test_world_on_cuda_without_a_card_raises():
    """device="cuda" never drops to gloo or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tmesh.world("cuda", rank=0, world_size=1,
                         store_path="/nonexistent/store"):
            pass
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.spawn(print, 1, device="cuda", timeout=5)


def test_a_deadlocked_rank_fails_within_the_timeout(tmp_path):
    """Rank 0 waits in a collective rank 1 never joins: the collective
    times out and the spawn fails, well inside the spawn's own limit."""
    import time
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        tmesh.spawn(torch_dist_ranks.deadlock, 2,
                    device="cpu", timeout=60, collective_timeout=3,
                    store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


# ----------------------------------------------------------------- rules
def test_default_rules_and_specs_match():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    jr, tr = jsh.PartitionRules(), tsh.PartitionRules()
    for axes in (("batch", "seq"), ("vocab", "embed"),
                 ("layers", "embed", "heads", "head_dim"), (None, "mlp")):
        assert tr.spec(*axes) == tuple(jr.spec(*axes))
    with pytest.raises(KeyError):
        tr.spec("nope")


def test_param_logical_specs_match():
    jc = jt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=48)
    tc = tt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=48)
    assert tt.param_logical_specs(tc) == jt.param_logical_specs(jc)


def _jax_specs(tree):
    """A tree of jax PartitionSpecs as the port's spec tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def test_regex_rules_reproduce_the_hand_specs_on_params_and_state():
    """TRANSFORMER_RULES matched on the port's params, AdamW state and
    bf16 masters give each leaf its param's spec under DEFAULT_RULES, as
    the reference's rules give its own trees."""
    cfg = tt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48,
                               dtype="float32")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    want = tt.param_specs(cfg)
    assert tpr.match_partition_rules(tpr.TRANSFORMER_RULES, params) == want
    jc = jt.TransformerConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
        "d_ff")})
    jparams = jax.eval_shape(lambda: jt.init_params(jax.random.key(0), jc))
    assert _jax_specs(jpr.match_partition_rules(
        jpr.TRANSFORMER_RULES, jparams)) == want
    tp, state = ttr.init_train_state(params, ttr.TrainConfig(
        bf16_params=True))
    specs = tpr.match_partition_rules(tpr.TRANSFORMER_RULES, state)
    assert specs.master == want and specs.inner.mu == want
    assert specs.inner.count == ()
    assert ttr.opt_state_shardings(state, want) == specs
    with pytest.raises(ValueError, match="no partition rule"):
        tpr.match_partition_rules(tpr.TRANSFORMER_RULES,
                                  {"stray": torch.zeros(4, 4)})
    from kubeflow_tpu_torch.models.moe import MoEConfig
    assert tpr.rules_for(cfg) is tpr.TRANSFORMER_RULES
    assert tpr.rules_for(MoEConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
        "d_ff")})) is tpr.MOE_RULES
    assert tpr.MOE_RULES == tuple((r, tuple(p)) for r, p in jpr.MOE_RULES)


def test_shard_and_gather_fns_round_trip_without_a_mesh():
    w = torch.arange(24.0).reshape(2, 3, 4)
    shard, gather = tpr.make_shard_and_gather_fns(
        None, {"w": (None, "fsdp", "tp")})
    assert torch.equal(gather["w"](shard["w"](w)), w)


class FakeMesh:
    """The DeviceMesh surface a layout reads (axis names and sizes), for
    checks that start no world."""
    mesh_dim_names = tmesh.AXES

    def __init__(self, **sizes):
        self.shape = tuple(sizes.get(a, 1) for a in tmesh.AXES)

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, name):
        return 0


def test_shardings_are_the_references_placements():
    """param_shardings and batch_sharding give the reference's
    NamedSharding specs, as DTensor placements (one per mesh axis)."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = tt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48)
    sh = tsh.param_shardings(FakeMesh(), tt.param_logical_specs(cfg))
    R = Replicate()
    # wq P(None, fsdp, tp, None); embed P(tp, fsdp); norms replicated
    assert sh["blocks"]["wq"].placements == (R, Shard(1), R, R, Shard(2), R)
    assert sh["embed"].placements == (R, Shard(1), R, R, Shard(0), R)
    assert sh["final_norm"].placements == (R,) * 6
    batch = tsh.batch_sharding(FakeMesh())
    assert batch.spec == tuple(jsh.PartitionRules().spec("batch", "seq"))
    assert batch.placements == (Shard(0), Shard(0), R, Shard(1), R, R)
    assert tsh.batch_sharding(FakeMesh(), accum=True).spec[0] is None


def test_model_refuses_a_mesh_it_cannot_run_on():
    """Checked before any collective: pp without the layer axis on it
    (the default rules), tp that does not divide the kv heads, and
    attention that sees one sequence block under sp."""
    cfg = tt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48)

    with pytest.raises(ValueError, match="'layers' axis on pp"):
        tt.check_mesh(cfg, FakeMesh(pp=2))
    with pytest.raises(ValueError, match="kv_heads|does not divide"):
        tt.check_mesh(cfg, FakeMesh(tp=4))
    tt.check_mesh(cfg, FakeMesh(tp=2, fsdp=2, sp=2))
    with pytest.raises(ValueError, match="ring or ulysses"):
        tt._select_attention(cfg.replace(attention="xla"),
                             torch.device("cpu"), FakeMesh(sp=2))
    assert tt._select_attention(cfg, torch.device("cpu"),
                                FakeMesh(sp=2)) == "ring"


# ------------------------------------------------------- ring and Ulysses
@pytest.mark.parametrize("name", [a[0] for a in ATTENTION])
def test_attention_matches_the_reference(ranks, name):
    cases, got = ranks
    case = cases[name]
    want = _jax_attention(case["fn"], case["mesh"], case["causal"],
                          *(case[n] for n in ("q", "k", "v", "dout")))
    mine = got[name]
    np.testing.assert_allclose(mine["out"], want[0], rtol=OUT_TOL,
                               atol=OUT_TOL)
    for g, w in zip((mine["dq"], mine["dk"], mine["dv"]), want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_collectives_backward_is_the_transpose(ranks):
    assert ranks[1]["comm"] == {"all_gather": True, "all_to_all": True,
                                "ring_shift": True, "reduce_from": True,
                                "copy_to": True}


def test_shards_are_dtensors_local_shards(ranks):
    got = ranks[1]["placements"]
    assert got and all(got.values()), got


def test_hybrid_mesh_matches_the_reference(ranks):
    """2 slices of (tp 2): dp spans the slices, ranks chunked contiguously
    as the reference chunks virtual devices."""
    per_slice = jmesh.MeshConfig(fsdp=1, tp=2)
    jm, jfull = jmesh.build_hybrid_mesh(2, per_slice,
                                        devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    got = ranks[1]["hybrid"]
    np.testing.assert_array_equal(got["ranks"], ids)
    assert got["config"] == jfull.axis_sizes()
