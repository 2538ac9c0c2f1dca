"""The port's serving engines over a mesh (runtime/serving.py on params
from runtime/sharded_decode.py) against the JAX package's engines on its
sharded params, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces: ``ContinuousBatchedGenerator``,
``BatchedGenerator`` and ``generate`` on ``shard_decode_params(params,
build_mesh(MeshConfig.auto(8, tp=4)), cfg)``, the int8 engine
(``quantize=True, kv_quant=True``) on ``auto(8, tp=2)``, and a 4-expert
MoE on ``auto(8, tp=2, ep=2)`` and ``auto(8, ep=2)``. The port's runs in
one gloo world of 4 spawned processes (tests/torch_dist_ranks.py
``serving_suite``), started once for the module, on ``auto(4, tp=2)``
(fsdp 2 x tp 2), ``auto(4, tp=4)``, ``auto(4, tp=2, ep=2)`` and
``auto(4, ep=2)`` (fsdp 2 x ep 2): every rank builds each engine, rank 0
drives it, and every rank reports the requests it admitted (a
follower's from the driver's plans) with their ids. Params come from the
JAX init (convert.py); f32, so greedy ids are exact. The MoE's capacity
factor 8 does not bind, so its ids do not depend on the rows beside
them.

Config: tests/test_sharded_decode.py's tiny model (vocab 128, d_model
64, 2 layers, 8 heads of 8, 4 kv heads, d_ff 128, max_seq_len 64); the
draft is its 1-layer twin with d_ff 64.

A second world of 3 ranks, whose collectives time out after 15 s, idles
both engines on tp 2 meshes of ranks 0 and 1 for 17 s between two
requests: the followers wait for the driver in the plan broadcast, on
the mesh's plan group, whose wait that timeout does not end. Then each
engine fails on rank 1 inside its device work, and closes on both ranks
once the driver's collective times out. Rank 2 only helps make the
meshes, so that each has a tp group of its own: a tp group over the
whole world would be the world's own group, which the failure leaves
out of step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime import serving as js
from kubeflow_tpu.runtime.sharded_decode import shard_decode_params
from kubeflow_tpu_torch.parallel import mesh as tmesh

import torch_dist_ranks

CONFIG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
              n_kv_heads=4, d_ff=128, max_seq_len=64, dtype="float32")
DRAFT = dict(CONFIG, n_layers=1, d_ff=64)
MOE = dict(CONFIG, n_experts=4, experts_per_token=2, capacity_factor=8.0)
MAX_NEW = 10
WAIT = 60.0


def _jax_engine_ids(engine, prompts):
    return [[int(t) for t in engine.generate_sync(p, MAX_NEW, timeout=WAIT)]
            for p in prompts]


@pytest.fixture(scope="module")
def jax_side():
    jc, dc = jt.TransformerConfig(**CONFIG), jt.TransformerConfig(**DRAFT)
    mc = jm.MoEConfig(**MOE)
    init = jax.jit(jt.init_params, static_argnums=1)
    jp, jdp = init(jax.random.key(0), jc), init(jax.random.key(1), dc)
    jmp = jax.jit(jm.init_moe_params, static_argnums=1)(jax.random.key(2),
                                                        mc)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, 128, (4, 12)).astype(np.int32)
    long_prompt = rng.integers(0, 128, (20,)).astype(np.int32)
    out = {"params": jax.tree.map(np.asarray, jp),
           "draft_params": jax.tree.map(np.asarray, jdp),
           "moe_params": jax.tree.map(np.asarray, jmp),
           "prompts": prompts, "long_prompt": long_prompt}
    tp4 = shard_decode_params(jp, build_mesh(MeshConfig.auto(8, tp=4)), jc)
    gen = jax.jit(jd.generate, static_argnums=(2, 3))
    out["generate"] = np.asarray(gen(tp4, jnp.asarray(prompts), jc,
                                     MAX_NEW)).tolist()
    out["generate_long"] = np.asarray(gen(
        tp4, jnp.asarray(long_prompt[None]), jc, MAX_NEW))[0].tolist()
    with js.ContinuousBatchedGenerator(tp4, jc, n_slots=4,
                                       prefill_chunk=8) as engine:
        out["continuous"] = _jax_engine_ids(engine,
                                            list(prompts) + [long_prompt])
    with js.BatchedGenerator(tp4, jc, max_batch=4) as engine:
        out["bucketed"] = _jax_engine_ids(engine, prompts)
    tp2 = shard_decode_params(jp, build_mesh(MeshConfig.auto(8, tp=2)), jc)
    with js.ContinuousBatchedGenerator(tp2, jc, n_slots=4, prefill_chunk=8,
                                       quantize=True,
                                       kv_quant=True) as engine:
        out["int8"] = _jax_engine_ids(engine, prompts)
    for name, axes in (("tp2_ep2", dict(tp=2, ep=2)),
                       ("fsdp2_ep2", dict(ep=2))):
        sharded = shard_decode_params(
            jmp, build_mesh(MeshConfig.auto(8, **axes)), mc)
        out[f"moe_{name}_generate"] = np.asarray(gen(
            sharded, jnp.asarray(prompts), mc, MAX_NEW)).tolist()
        with js.ContinuousBatchedGenerator(sharded, mc, n_slots=4,
                                           prefill_chunk=8) as engine:
            out[f"moe_{name}_continuous"] = _jax_engine_ids(engine,
                                                            prompts)
    return out


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    job = {k: jax_side[k] for k in ("params", "draft_params", "moe_params",
                                    "prompts", "long_prompt")}
    job.update(config=CONFIG, draft_config=DRAFT, moe_config=MOE,
               max_new=MAX_NEW)
    return tmesh.spawn(torch_dist_ranks.serving_suite, 4, job, device="cpu",
                       timeout=240.0, collective_timeout=60.0,
                       store_dir=str(tmp_path_factory.mktemp("world")))


IDLE_TIMEOUT = 15.0
IDLE_S = 17.0


@pytest.fixture(scope="module")
def idle_side(jax_side, tmp_path_factory):
    job = {"config": CONFIG, "params": jax_side["params"],
           "prompts": jax_side["prompts"][:2], "max_new": MAX_NEW,
           "timeout": IDLE_TIMEOUT, "idle": IDLE_S}
    return tmesh.spawn(torch_dist_ranks.idle_suite, 3, job, device="cpu",
                       timeout=240.0, collective_timeout=IDLE_TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp("idle")))


def _same_on_every_rank(port_side, case):
    """The case's requests and counters as rank 0 saw them, after
    checking every follower admitted the same requests, got the same ids
    and counted the same chunks, hits, ticks and cancellations."""
    views = [ranks[case] for ranks in port_side]
    for view in views[1:]:
        assert view["outcomes"] == views[0]["outcomes"]
        assert view["counters"] == views[0]["counters"]
    return views[0]


def test_jax_engines_equal_jax_generate(jax_side):
    """The references agree among themselves: the JAX engines on the
    sharded params return JAX generate's ids."""
    assert jax_side["continuous"] == jax_side["generate"] + \
        [jax_side["generate_long"]]
    assert jax_side["bucketed"] == jax_side["generate"]


@pytest.mark.parametrize("mesh", ["tp2", "tp4"])
def test_continuous_engine_on_a_mesh_equals_jax(jax_side, port_side, mesh):
    """Greedy requests one after the other, one admitted while another
    decodes, one cancelled at its second token and a 20-token prompt
    twice (the second hits the prefix cache): ids equal the JAX engine's
    on every rank, and every rank counts the same admissions, chunks,
    hits and cancellation."""
    view = _same_on_every_rank(port_side, f"{mesh}_continuous")
    got = port_side[0][f"{mesh}_continuous"]["driven"]
    want = jax_side["continuous"]
    assert got["plain"] == want[:2]
    assert got["late"] == want[2] and got["running"] == want[3]
    assert got["cancelled"] is True
    assert got["prefix"] == [want[4], want[4]]
    c = view["counters"]
    assert c["admitted_while_running"] >= 1
    assert c["cancelled_total"] == 1
    # 20 tokens in chunks of 8: the second admission copies 2 chunks
    assert c["prefix_cache_hits_total"] >= 2
    assert "CancelledError" in view["outcomes"]


@pytest.mark.parametrize("mesh", ["tp2", "tp4"])
def test_bucketed_engine_on_a_mesh_equals_jax(jax_side, port_side, mesh):
    """Four same-shape requests coalesce into one broadcast batch: ids
    equal the JAX BatchedGenerator's on every rank."""
    view = _same_on_every_rank(port_side, f"{mesh}_bucketed")
    assert port_side[0][f"{mesh}_bucketed"]["driven"] == \
        jax_side["bucketed"]
    assert sorted(view["outcomes"]) == sorted(jax_side["bucketed"])


@pytest.mark.parametrize("case", ["tp2_sync4", "tp2_spec"])
def test_multi_step_sync_and_speculation_on_a_mesh(jax_side, port_side,
                                                   case):
    """steps_per_sync=4, and speculation with a draft sharded over the
    same mesh (k=3): the greedy ids are JAX generate's on every rank."""
    view = _same_on_every_rank(port_side, case)
    assert port_side[0][case]["driven"] == jax_side["generate"]
    if case == "tp2_spec":
        assert view["counters"]["spec_ticks"] >= 1
        assert view["counters"]["spec_drafted"] > 0


def test_sampling_on_a_mesh_equals_the_unsharded_engine(port_side):
    """Temperature 0.8 at seed 5, one request after the other: every rank
    draws the same ids, and they are the unsharded engine's at the same
    seed."""
    view = _same_on_every_rank(port_side, "tp2_sampled")
    got = port_side[0]["tp2_sampled"]["driven"]
    assert got == port_side[0]["unsharded_sampled"]
    assert view["outcomes"] == got
    assert all(0 <= t < CONFIG["vocab_size"] for ids in got for t in ids)


def test_int8_engine_on_a_mesh_equals_jax(jax_side, port_side):
    """quantize=True with kv_quant=True over tp 2: ids equal the JAX
    engine's with the same flags on its sharded tree, and each rank's
    int8 weights and scales are its slice of the unsharded tree's
    quantize_params (the scales' max runs over the whole contraction
    axis, tp-split for wo and w_down)."""
    _same_on_every_rank(port_side, "tp2_int8")
    assert port_side[0]["tp2_int8"]["driven"] == jax_side["int8"]
    assert all(ranks["int8_scales_equal"] for ranks in port_side)


@pytest.mark.parametrize("mesh", ["tp2_ep2", "fsdp2_ep2"])
def test_moe_on_a_mesh_equals_jax(jax_side, port_side, mesh):
    """The 4-expert MoE with its experts over ep (2 a rank): generate and
    the continuous engine equal JAX's on the same mesh shape. Under fsdp
    2 every rank holds the whole batch at decode, so routing that
    gathered rows over the data axes would count each twice and move the
    ids."""
    view = _same_on_every_rank(port_side, f"moe_{mesh}_continuous")
    for ranks in port_side:
        assert ranks[f"moe_{mesh}_generate"].tolist() == \
            jax_side[f"moe_{mesh}_generate"]
    assert port_side[0][f"moe_{mesh}_continuous"]["driven"] == \
        jax_side[f"moe_{mesh}_continuous"]
    assert view["outcomes"] == jax_side[f"moe_{mesh}_generate"]
    experts, mlp = (2, 64) if mesh == "tp2_ep2" else (2, 128)
    assert port_side[0][f"moe_{mesh}_local_w_gate"] == (2, experts, 64, mlp)


def _failure_served_on(jax_side, port_side, where):
    driver = port_side[0][f"tp2_failure_{where}"]
    assert "another rank" in driver["first"]
    assert driver["fail_seconds"] < 60.0
    assert driver["second"] == jax_side["generate"][1]
    for ranks in port_side:
        view = ranks[f"tp2_failure_{where}"]
        assert view["outcomes"] == ["RuntimeError", jax_side["generate"][1]]
        assert view["active_after"] is False
    for ranks in port_side[1:]:
        assert "first rank" in \
            ranks[f"tp2_failure_{where}"]["follower_submit"]


def test_a_failure_on_one_rank_fails_every_rank_then_serves_on(jax_side,
                                                               port_side):
    """A tick's delivery that raises on rank 1 only, after the tick's
    collectives: the request fails on the driver (naming another rank)
    and on every follower within the collective timeout, every rank
    rebuilds its state, and the next request's ids are JAX's; a
    follower's submit raises."""
    _failure_served_on(jax_side, port_side, "delivery")


def test_a_failure_before_the_collectives_fails_every_rank_then_serves_on(
        jax_side, port_side):
    """An admission that raises on rank 1 only, before the iteration's
    first collective: every rank agrees on it before entering one, fails
    the request, rebuilds its state, and serves the next request with
    JAX's ids."""
    _failure_served_on(jax_side, port_side, "admission")


@pytest.mark.parametrize("engine", ["bucketed", "continuous"])
def test_a_failure_inside_the_collectives_closes_every_rank(idle_side,
                                                             engine):
    """Rank 1 raises as it enters the device work, leaving the driver in
    a collective that rank 1 never joins: the driver's request fails when
    that collective times out (15 s), rank 1's fails with its own error,
    the engine thread ends on both ranks and the driver refuses later
    requests."""
    driver = idle_side[0]["broken"][engine]
    assert driver["first"] != "served"
    assert IDLE_TIMEOUT <= driver["fail_seconds"] < IDLE_TIMEOUT + 30.0
    assert "closed" in driver["later_submit"]
    for ranks in idle_side[:2]:
        view = ranks["broken"][engine]
        assert view["thread_ended"] is True
        assert len(view["outcomes"]) == 1
        assert not isinstance(view["outcomes"][0], list)


@pytest.mark.parametrize("engine", ["bucketed", "continuous"])
def test_an_engine_idle_past_the_worlds_timeout_serves_on(jax_side,
                                                          idle_side, engine):
    """A request, 17 s with nothing to do (the world's collectives time
    out after 15 s), another request: both served with the reference's
    ids, and the follower ran both."""
    assert IDLE_S > IDLE_TIMEOUT
    want = jax_side["generate"][:2]
    assert idle_side[0][engine] == want
    for ranks in idle_side[:2]:
        assert ranks["outcomes"][engine] == want


def test_a_mesh_serves_one_engine_at_a_time(idle_side):
    """A second engine on a mesh an engine serves on is refused on every
    rank: the two engines' plans would interleave on the mesh's one plan
    group."""
    for ranks in idle_side[:2]:
        assert "another engine serves on this mesh" in \
            ranks["second_engine"]
