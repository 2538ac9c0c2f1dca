"""The port's elastic training and migration (runtime/elastic.py,
runtime/migrate.py and the handshake names of utils/names.py,
utils/k8s.py) against the JAX package's, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices
tests/conftest.py forces: ``ElasticTrainer(MeshConfig(fsdp=2), 3, ...)``
shrinks to 2 slices and grows back, as in tests/test_elastic.py, its
``ElasticAgent`` drives a 2 → 1 resize through a ``ClusterStore``, its
agents walk the annotation sequences of tests/test_elastic.py, and its
migration drivers write their tokens. The port's trainers run in one
gloo world of 6 spawned processes (tests/torch_dist_ranks.py
``elastic_suite``), started once for the module: the mesh takes the
world's first ranks, the rest stand by. They start from the JAX side's
initial params (a step-0 checkpoint; convert.py) and train on the same
numpy batches. Tolerances are the sharded train step's: losses 1e-5,
params 2e-6; a resize and a migration on the same mesh are bit-equal.

Config: tests/test_elastic.py's tiny model (vocab 128, d_model 32, 2
layers, 4 heads, 4 kv heads, d_ff 48, f32, max_seq_len 64), batches of
12 x 16 tokens (12 divides every data extent: 6, 4 and 6 again).
"""

from __future__ import annotations

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.api import types as api
from kubeflow_tpu.cluster.store import ClusterStore
from kubeflow_tpu.models.train import TrainConfig as JaxTrainConfig
from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from kubeflow_tpu.runtime import elastic as je
from kubeflow_tpu.runtime import migrate as jmig
from kubeflow_tpu.runtime.data import synthetic_lm_batches
from kubeflow_tpu.utils import k8s as jk8s
from kubeflow_tpu.utils import names as jnames
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel.mesh import MeshConfig
from kubeflow_tpu_torch.runtime import elastic as te
from kubeflow_tpu_torch.runtime import migrate as tmig
from kubeflow_tpu_torch.utils import k8s as tk8s
from kubeflow_tpu_torch.utils import names as tnames

import torch_dist_ranks

CONFIG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=4, d_ff=48, dtype="float32", max_seq_len=64)
TC = dict(warmup_steps=1)
PER_SLICE = dict(dp=1, fsdp=2)
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
NS = "elastic-ns"


def _batches(n, seed=3, rows=12):
    return list(synthetic_lm_batches(rows, 16, 128, n_batches=n, seed=seed))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_elastic(tmp, n_slices, batches, agent_walk=False):
    """The reference's ElasticTrainer on the 8 CPU devices: its initial
    params, and per fit chunk the params after it and the losses; with
    ``agent_walk`` its ElasticAgent drives the Draining → Resharding(1)
    walk between two fits through a ClusterStore."""
    out = {"params": {}}
    with je.ElasticTrainer(JaxMeshConfig(**PER_SLICE), n_slices,
                           JaxConfig(**CONFIG), JaxTrainConfig(**TC),
                           tmp, devices=jax.devices()[:8]) as et:
        out["init"] = _np(et.params)
        if agent_walk:
            store = ClusterStore()
            store.create(api.new_notebook("nb", NS,
                                          annotations=_agent_annotations()))
            agent = je.ElasticAgent(et, store, NS, "nb")
            et.fit(batches[0], steps=2, log_every=1)
            trail = []
            for annotations in _AGENT_WALK:
                if annotations is not None:
                    store.patch(api.KIND, NS, "nb", {"metadata": {
                        "annotations": annotations}})
                agent.poll_once()
                nb = store.get(api.KIND, NS, "nb")
                trail.append({
                    "ack": jk8s.get_annotation(
                        nb, jnames.ELASTIC_ACK_ANNOTATION),
                    "n_slices": et.n_slices, "step": et.stats.step,
                    "mesh_dp": et.mesh.shape["dp"]})
            et.fit(batches[1], steps=2, log_every=1)
            out["trail"] = trail
            out["current"] = jk8s.get_annotation(
                store.get(api.KIND, NS, "nb"),
                jnames.ELASTIC_CURRENT_SLICES_ANNOTATION)
            out["state"] = (et.stats.step, et.params, et.opt_state)
        else:
            for i, (chunk, steps) in enumerate(zip(batches, (4, 3, 3))):
                if i:
                    et.shrink() if i == 1 else et.grow()
                et.fit(chunk, steps=steps, log_every=1)
                out["params"][et.stats.step] = _np(et.params)
            out["events"] = [e[:3] for e in et.resize_events]
        out["losses"] = list(et.stats.losses)
    return out


def _agent_annotations():
    return {jnames.ELASTIC_ANNOTATION: "true",
            jnames.ELASTIC_SLICES_ANNOTATION: "2",
            jnames.ELASTIC_CURRENT_SLICES_ANNOTATION: "2"}


_AGENT_WALK = (
    {jnames.ELASTIC_RESIZE_ANNOTATION: "Draining",
     jnames.ELASTIC_TARGET_ANNOTATION: "1"},
    None,
    {jnames.ELASTIC_RESIZE_ANNOTATION: "Resharding"},
    {jnames.ELASTIC_RESIZE_ANNOTATION: None,
     jnames.ELASTIC_ACK_ANNOTATION: None},
)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    cycle_batches = [_batches(4), _batches(3, seed=5), _batches(3, seed=7)]
    agent_batches = [_batches(2, seed=11), _batches(2, seed=13)]
    cycle = _jax_elastic(tmp / "cycle", 3, cycle_batches)
    agent = _jax_elastic(tmp / "agent", 2, agent_batches, agent_walk=True)
    # the migration token of the reference's driver for the directory the
    # port's will use (the reference's checkpoint then moves aside)
    mig_dir = tmp_path_factory.mktemp("port") / "migration"
    store = ClusterStore()
    store.create(api.new_notebook("nb", NS))
    nb = store.get(api.KIND, NS, "nb")
    step, params, opt_state = agent["state"]
    driver = jmig.CheckpointMigrationDriver(
        lambda notebook: mig_dir, lambda notebook: (step, params, opt_state),
        None)
    token = driver.checkpoint(store, nb)
    shutil.move(str(mig_dir), str(tmp / "reference-migration"))
    agent.pop("state")
    return {"cycle": cycle, "agent": agent, "cycle_batches": cycle_batches,
            "agent_batches": agent_batches, "mig_dir": str(mig_dir),
            "token": token, "token_step": step}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    job = {"config": CONFIG, "tc": TC, "per_slice": PER_SLICE,
           "init": jax_side["cycle"]["init"],
           "batches": jax_side["cycle_batches"],
           "agent_batches": jax_side["agent_batches"],
           "annotations": _agent_annotations(),
           "dir": str(root / "cycle"), "agent_dir": str(root / "agent"),
           "mig_seed": str(root / "mig-seed"), "mig_dir": jax_side["mig_dir"],
           "mig_batches": _batches(6, seed=17, rows=4)}
    return tmesh.spawn(torch_dist_ranks.elastic_suite, 6, job, device="cpu",
                       timeout=300.0, collective_timeout=60.0,
                       store_dir=str(tmp_path_factory.mktemp("world")))


def _close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


# ----------------------------------------------------------------- names
@pytest.mark.parametrize("name", [
    "RUNTIME_STEP_ANNOTATION", "RESUMED_STEP_ANNOTATION",
    "ELASTIC_ANNOTATION", "ELASTIC_SLICES_ANNOTATION",
    "ELASTIC_CURRENT_SLICES_ANNOTATION", "ELASTIC_RESIZE_ANNOTATION",
    "ELASTIC_TARGET_ANNOTATION", "ELASTIC_ACK_ANNOTATION"])
def test_handshake_names_equal_the_reference(name):
    assert getattr(tnames, name) == getattr(jnames, name)


def test_constants_and_k8s_helpers_equal_the_reference():
    assert te.ELASTIC_BLIP_STEPS == je.ELASTIC_BLIP_STEPS
    assert (te.ACK_DRAINING, te.ACK_RESHARDING, te.ACK_ABORTED) == \
        (je.ACK_DRAINING, je.ACK_RESHARDING, je.ACK_ABORTED)
    assert tmig.TOKEN_VERSION == jmig.TOKEN_VERSION
    nb = api.new_notebook("nb", NS, annotations={"a": "1"})
    for fn in ("name", "namespace", "kind"):
        assert getattr(tk8s, fn)(nb) == getattr(jk8s, fn)(nb)
    for key in ("a", "missing"):
        assert tk8s.get_annotation(nb, key) == jk8s.get_annotation(nb, key)
    assert tk8s.get_annotation({}, "a", "d") == \
        jk8s.get_annotation({}, "a", "d")


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("step", [4, 7, 10])
def test_shrink_grow_params_equal_jax(jax_side, port_side, step):
    """3 → 2 → 3 slices of fsdp 2: the params after each fit chunk
    (steps 4, 7 and 10) equal the reference ElasticTrainer's."""
    _close(port_side[0]["cycle"]["params"][step],
           jax_side["cycle"]["params"][step], PARAM_TOL)


def test_shrink_grow_losses_and_events_equal_jax(jax_side, port_side):
    """Every step's loss, the step counter and the resize events equal
    the reference's; the loss history and tokens are carried across both
    rebuilds on every rank, standby ranks included."""
    want = jax_side["cycle"]
    for ranks in port_side:
        got = ranks["cycle"]
        assert [s for s, _ in got["losses"]] == [s for s, _ in
                                                 want["losses"]]
        np.testing.assert_allclose([x for _, x in got["losses"]],
                                   [x for _, x in want["losses"]],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got["step"] == 10
        assert got["events"] == want["events"] == [(3, 2, 4), (2, 3, 7)]
        assert got["tokens_seen"] == 10 * 12 * 16


def test_resize_keeps_the_state_bit_equal(port_side):
    """The state gathered just before a resize equals the one restored
    on the new mesh, bit for bit, on every rank of both meshes."""
    for ranks in port_side:
        assert ranks["cycle"]["carried"] == [True, True]
    got = port_side[0]["cycle"]
    assert got["mesh_dp"][:4] == [3, 3, 2, 2] and got["mesh_dp"][-1] == 3


def test_standby_ranks_do_nothing(port_side):
    """On 2 slices the world's ranks 4 and 5 stand by: no mesh, fit and
    evaluate return without drawing a batch; they rejoin on grow."""
    for rank, ranks in enumerate(port_side):
        cyc = ranks["cycle"]
        standby = rank >= 4
        # note() before the shrink, after it, after fit 2, before the
        # grow, after it, after fit 3
        assert cyc["standby"] == [False, False, standby, standby, standby,
                                  False, False]
        if standby:
            assert cyc["standby_fit_step"] == 4
            assert cyc["standby_eval"] is None
            assert cyc["mesh_dp"][2] is None


def test_resize_noop_and_bounds(port_side):
    for ranks in port_side:
        cyc = ranks["cycle"]
        assert cyc["events_after_noop"] == 2
        assert ">= 1" in cyc["resize_0"]
        assert "exceed" in cyc["resize_4"]


def test_growing_back_reuses_the_mesh_of_that_count(port_side):
    """3 → 2 → 3 builds two meshes, not three: every rank (standby ones
    too) keeps the mesh of each slice count, and the mesh ranks train on
    the first 3-slice mesh again after growing back."""
    for ranks in port_side:
        assert ranks["cycle"]["meshes_made"] == 2
    for ranks in port_side:   # 3 slices of 2: every rank is in the mesh
        assert ranks["cycle"]["mesh_reused"] is True


def test_resize_events_bounded_oldest_dropped(port_side):
    cyc = port_side[0]["cycle"]
    assert cyc["capped_maxlen"] == 1
    assert cyc["capped_events"] == [(2, 3)]


def test_checkpoint_dir_is_mandatory():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        te.ElasticTrainer(MeshConfig(fsdp=2), 2,
                          TransformerConfig(**CONFIG))


# ----------------------------------------------------------------- agents
def _store(current="3"):
    store = ClusterStore()
    store.create(api.new_notebook("nb", NS, annotations={
        jnames.ELASTIC_ANNOTATION: "true",
        jnames.ELASTIC_SLICES_ANNOTATION: "3",
        jnames.ELASTIC_CURRENT_SLICES_ANNOTATION: current}))
    return store


def _set(store, annotations):
    store.patch(api.KIND, NS, "nb", {"metadata": {
        "annotations": annotations}})


def _walk(agent_cls, script):
    """Run one annotation script against a fresh ClusterStore; what the
    agent and the Notebook showed after each poll."""
    store = _store()
    agent = agent_cls(store, NS, "nb", current_slices=3)
    seen = []
    for step in script:
        if step == "restart":
            agent.steps = 0
            continue
        if step is not None:
            _set(store, step)
        agent.poll_once()
        nb = store.get(api.KIND, NS, "nb")
        seen.append((agent.steps, agent.resizes, agent.current,
                     list(agent.violations), agent.mfu(),
                     {k: v for k, v in
                      nb["metadata"].get("annotations", {}).items()
                      if k.startswith("tpu.kubeflow.org/elastic")}))
    return seen


_SCRIPTS = {
    "drain_then_reshard": [
        None,
        {jnames.ELASTIC_RESIZE_ANNOTATION: "Draining",
         jnames.ELASTIC_TARGET_ANNOTATION: "2"},
        None,
        {jnames.ELASTIC_RESIZE_ANNOTATION: "Resharding"},
        {jnames.ELASTIC_RESIZE_ANNOTATION: None,
         jnames.ELASTIC_ACK_ANNOTATION: None}],
    "aborted_latch": [{jnames.ELASTIC_ACK_ANNOTATION: "Aborted"}],
    "restart": [None] * 10 + ["restart", None],
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_simulated_agent_walks_like_the_reference(script):
    """The annotation sequences of tests/test_elastic.py against the
    reference's ClusterStore: after every poll the port's simulated
    agent and the reference's show the same steps, resizes, slice count,
    violations, MFU and Notebook annotations."""
    got = _walk(te.SimulatedElasticAgent, _SCRIPTS[script])
    want = _walk(je.SimulatedElasticAgent, _SCRIPTS[script])
    assert got == want
    if script == "restart":
        assert any("reset" in v for v in got[-1][3])
    if script == "drain_then_reshard":
        assert got[-1][1] == 1 and got[-1][2] == 2


def test_real_agent_drives_the_resize_like_the_reference(jax_side,
                                                         port_side):
    """ElasticAgent over the 6-rank world bound to a 2-slice trainer:
    the same acks, slice counts and steps after each poll as the
    reference's agent over a ClusterStore, the controller-written
    current-slices untouched, the state carried bit for bit across the
    agent's resize and the losses of the fits around it equal to the
    reference's; every rank acts on rank 0's reading."""
    want = jax_side["agent"]
    got = port_side[0]["agent"]
    assert [{k: t[k] for k in ("ack", "n_slices", "step", "mesh_dp")}
            for t in got["trail"]] == want["trail"]
    assert got["current"] == want["current"] == "2"
    np.testing.assert_allclose([x for _, x in got["losses"]],
                               [x for _, x in want["losses"]],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    for rank, ranks in enumerate(port_side):
        assert ranks["agent"]["carried"] is True
        trail = ranks["agent"]["trail"]
        assert [t["n_slices"] for t in trail] == [2, 2, 1, 1]
        assert [t["standby"] for t in trail][-1] == (rank >= 2)
        # a standby rank's stats are those of the last resize
        assert ranks["agent"]["step"] == (2 if rank >= 2 else 4)


# -------------------------------------------------------------- migration
def _migration_store(step="123"):
    store = ClusterStore()
    store.create(api.new_notebook("mig-nb", "ns", annotations={
        jnames.RUNTIME_STEP_ANNOTATION: step}))
    return store, store.get(api.KIND, "ns", "mig-nb")


def test_simulated_migration_tokens_equal_the_reference():
    """The same notebook gives the same token bytes; resuming either
    driver's token stamps the same resumed step."""
    store, nb = _migration_store()
    token = tmig.SimulatedMigrationDriver().checkpoint(store, nb)
    assert token == jmig.SimulatedMigrationDriver().checkpoint(store, nb)
    tmig.SimulatedMigrationDriver().resume(store, nb, token)
    assert jk8s.get_annotation(store.get(api.KIND, "ns", "mig-nb"),
                               jnames.RESUMED_STEP_ANNOTATION) == "123"


@pytest.mark.parametrize("bad", ["not-json", "future-version", "no-step"])
def test_bad_tokens_raise_migration_error(bad):
    store, nb = _migration_store()
    token = {"not-json": "not-json",
             "future-version": json.dumps({"v": tmig.TOKEN_VERSION + 1,
                                           "step": 3}),
             "no-step": json.dumps({"v": tmig.TOKEN_VERSION})}[bad]
    for driver in (tmig.SimulatedMigrationDriver(),
                   tmig.CheckpointMigrationDriver(None, None, None)):
        with pytest.raises(tmig.MigrationError,
                           match="version" if bad == "future-version"
                           else "bad checkpoint token"):
            driver.resume(store, nb, token)


def test_legacy_token_and_a_missing_step(tmp_path):
    """A token without "v" resumes as v1; a step absent from the
    directory raises MigrationError."""
    store, nb = _migration_store("42")
    legacy = json.dumps({"step": 42})
    tmig.SimulatedMigrationDriver().resume(store, nb, legacy)
    assert jk8s.get_annotation(store.get(api.KIND, "ns", "mig-nb"),
                               jnames.RESUMED_STEP_ANNOTATION) == "42"
    like = {"w": torch.zeros(2)}
    driver = tmig.CheckpointMigrationDriver(
        lambda notebook: tmp_path, None, lambda notebook: (like, like))
    token = json.dumps({"v": 1, "step": 9, "directory": str(tmp_path)})
    with pytest.raises(tmig.MigrationError, match="no checkpoint at step 9"):
        driver.resume(store, nb, token)


def test_checkpoint_migration_token_equals_the_reference(jax_side,
                                                         port_side):
    """The port's CheckpointMigrationDriver on a 2-rank mesh writes the
    reference's token byte for byte (same step, same directory), and
    only the mesh's first rank stamps the resumed step."""
    mig = port_side[0]["migration"]
    assert mig["token"] == jax_side["token"]
    assert jax_side["token_step"] == 4
    assert mig["resumed_annotation"] == "4"


@pytest.mark.parametrize("mesh", ["fsdp2", "tp2"])
def test_migration_resumes_bit_equal(port_side, mesh):
    """Checkpointed at step 4 and resumed into a fresh Trainer (another
    seed) on the same fsdp 2 mesh and on tp 2: the restored state is the
    checkpointed one bit for bit; on the same mesh steps 5-6 are the
    uninterrupted Trainer's bit for bit, on tp 2 within the loss pin."""
    mig = port_side[0]["migration"]
    assert mig[f"{mesh}_step"] == 4
    assert mig[f"{mesh}_restored_equal"] is True
    if mesh == "fsdp2":
        assert mig["fsdp2_losses"] == mig["losses_a"]
    else:
        np.testing.assert_allclose(mig["tp2_losses"], mig["losses_a"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


def test_a_trainer_outside_its_mesh_is_refused(port_side):
    for rank, ranks in enumerate(port_side):
        outside = ranks["migration"]["outside"]
        if rank < 2:
            assert outside is None
        else:
            assert f"rank {rank} is not in the mesh" in outside
