"""The port's tensor-parallel decode (runtime/sharded_decode.py and the
decode functions on its params) against the JAX package's
``shard_decode_params`` on the same mesh shape, and the port's
``dryrun_multidevice`` on 4 CPU ranks.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces, jitted; the port's in a gloo world of 4
spawned processes (tests/torch_dist_ranks.py) on a dp 2 x tp 2 mesh:
every rank decodes the same prompt (SPMD). Params come from the JAX
init (convert.py). f32 everywhere, so greedy ids are exact: sharded ids
equal JAX's and the unsharded port's; logits of prefill, a decode step at
per-row positions and a verify window agree with the unsharded port's to
1e-5 (the tp sums run in another order) and with JAX's to 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import speculative as js
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.runtime.sharded_decode import shard_decode_params
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.tools.dryrun_multidevice import dryrun_multidevice

import torch_dist_ranks

CONFIG = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128, dtype="float32")
DRAFT = dict(CONFIG, n_layers=1, d_ff=64)
MESH = {"dp": 2, "tp": 2}
MAX_NEW = 12
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side():
    jc, dc = jt.TransformerConfig(**CONFIG), jt.TransformerConfig(**DRAFT)
    init = jax.jit(jt.init_params, static_argnums=1)
    jp, jdp = init(jax.random.key(0), jc), init(jax.random.key(1), dc)
    mesh = build_mesh(MeshConfig(**MESH), devices=jax.devices()[:4])
    sp, sdp = (shard_decode_params(p, mesh, c)
               for p, c in ((jp, jc), (jdp, dc)))
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, CONFIG["vocab_size"], (2, 8)).astype(np.int32)
    window = rng.integers(0, CONFIG["vocab_size"], (2, 4)).astype(np.int32)
    out = {"params": jax.tree.map(np.asarray, jp),
           "draft_params": jax.tree.map(np.asarray, jdp),
           "prompt": prompt, "window": window}
    for kv_quant in (False, True):
        key = "int8" if kv_quant else "f32"
        out[f"generate_{key}"] = [np.asarray(jd.generate(
            p, jnp.asarray(prompt), jc, MAX_NEW, kv_quant=kv_quant))
            for p in (sp, jp)]
    P = prompt.shape[1]
    pos = jnp.asarray([P, P - 2], jnp.int32)
    logits, cache = jd.prefill(sp, jnp.asarray(prompt), jc)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    step_logits, cache = jd.decode_step(sp, cache, tok, pos, jc)
    win_logits, _ = jd.decode_window(sp, cache, jnp.asarray(window), pos + 1,
                                     jc)
    out["steps"] = {"prefill": np.asarray(logits),
                    "step": np.asarray(step_logits),
                    "window": np.asarray(win_logits)}
    spec = {}
    for name, (t, d, dconf, kvq) in (
            ("self", (sp, sp, jc, False)), ("draft", (sp, sdp, dc, False)),
            ("draft_int8", (sp, sdp, dc, True))):
        ids, stats = js.speculative_generate(
            t, d, jnp.asarray(prompt), jc, dconf, max_new_tokens=MAX_NEW,
            k=3, kv_quant=kvq)
        spec[name] = {"ids": np.asarray(ids),
                      "accepted": int(np.asarray(stats.accepted).sum()),
                      "drafted": int(np.asarray(stats.drafted).sum())}
    out["spec"] = spec
    return out


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    job = {k: jax_side[k] for k in ("params", "draft_params", "prompt",
                                    "window")}
    job.update(config=CONFIG, draft_config=DRAFT, mesh=MESH, max_new=MAX_NEW)
    return tmesh.spawn(torch_dist_ranks.decode_suite, 4, job, device="cpu",
                       timeout=240.0, collective_timeout=60.0,
                       store_dir=str(tmp_path_factory.mktemp("world")))[0]


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_sharded_generate_ids_equal_jax_and_unsharded(jax_side, port_side,
                                                      cache):
    """Greedy generate on tp-sharded weights and a cache of each rank's kv
    heads (full precision and int8): the ids of the reference on its
    sharded params, of the reference unsharded and of the port
    unsharded, all equal."""
    want_sharded, want_full = jax_side[f"generate_{cache}"]
    got_sharded, got_full = port_side[f"generate_{cache}"]
    np.testing.assert_array_equal(want_sharded, want_full)
    np.testing.assert_array_equal(got_sharded, want_sharded)
    np.testing.assert_array_equal(got_full, want_sharded)


@pytest.mark.parametrize("what", ["prefill", "step", "window"])
def test_sharded_decode_logits_match(jax_side, port_side, what):
    """prefill, decode_step at per-row positions and decode_window on the
    sharded params: logits against the unsharded port and the reference,
    and the same greedy picks."""
    got = port_side["steps"]["sharded"][what]
    full = port_side["steps"]["full"][what]
    want = jax_side["steps"][what]
    np.testing.assert_allclose(got, full, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_sharded_cache_holds_each_ranks_kv_heads(port_side):
    """tp 2 splits the 2 kv heads: wk (L, d, 1, k) and a cache of
    (L, B, S, 1, D) on each rank, against (L, B, S, 2, D) unsharded."""
    assert port_side["local_wk"] == (2, 64, 1, 16)
    assert port_side["steps"]["sharded"]["cache_k"] == (2, 2, 128, 1, 16)
    assert port_side["steps"]["full"]["cache_k"] == (2, 2, 128, 2, 16)


@pytest.mark.parametrize("name", ["self", "draft", "draft_int8"])
def test_sharded_speculative_ids_equal_jax(jax_side, port_side, name):
    """speculative_generate on the sharded target: with itself as the
    draft (every proposal accepted), with a sharded 1-layer draft, and
    with an int8 target cache; ids equal the reference's and greedy
    generate's."""
    want, got = jax_side["spec"][name], port_side["spec"][name]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    generate_ids = jax_side["generate_int8" if "int8" in name
                            else "generate_f32"][0]
    np.testing.assert_array_equal(got["ids"], generate_ids)
    if name != "draft_int8":
        assert (got["accepted"], got["drafted"]) == \
            (want["accepted"], want["drafted"])
    if name == "self":
        assert got["accepted"] == got["drafted"] > 0


def test_dryrun_multidevice_on_four_cpu_ranks():
    """Layouts 1 (fsdp/tp/sp ring), 2 (pp), 3 (ep2) and 6 (tp serving)
    at n = 4; those that need a multiple of 8 (ep4, pp x ep, pp x sp, the
    hybrid mesh) are skipped, as in the reference, with a line that says
    so."""
    lines = dryrun_multidevice(4, "cpu", timeout=240.0)
    ran = [ln for ln in lines if "skipped" not in ln]
    assert [ln.split(":")[0] for ln in ran] == [
        "[dryrun] fsdp+tp+sp(ring)", "[dryrun] pp(gpipe)+tp",
        "[dryrun] ep(moe)+tp", "[dryrun] tp-serving"]
    assert "accepted 18/18" in ran[-1]


@pytest.mark.parametrize("engine", ["BatchedGenerator",
                                    "ContinuousBatchedGenerator"])
def test_engines_refuse_submit_on_a_follower(port_side, engine):
    """Every rank of the mesh builds the engine on its sharded params;
    only the mesh's first rank (the driver) takes requests, and submit
    on every other rank raises, naming the driver
    (tests/test_torch_sharded_serving.py drives the engines)."""
    every = port_side["follower_submit"][engine]
    assert every[0] == "driver"
    assert len(every) == 4
    for msg in every[1:]:
        assert "first rank" in msg and "driver" in msg
