"""Rank entry points of the multi-rank parity tests
(tests/test_torch_parallel.py, test_torch_sharded_train.py,
test_torch_sharded_decode.py, test_torch_pipeline.py,
test_torch_sharded_moe.py, test_torch_sharded_lora.py,
test_torch_sharded_serving.py, test_torch_elastic.py), and the worker
of the bootstrapped slice (test_torch_bootstrap.py, run as a script).

Each function runs in every process of a gloo world on the CPU started by
``kubeflow_tpu_torch.parallel.mesh.spawn``, and returns rank 0's results
(numpy) to the parent, which holds them against the JAX package;
``bootstrap_worker`` forms its world itself, from the env the controller
injects. This
module imports torch, numpy and the port, never JAX: the parent computes
the JAX side and passes its inputs in as numpy arrays.

A case runs on a mesh over the first ranks of the world (``_mesh``):
every rank builds every mesh (process groups are made collectively), and
the ranks outside it skip the case.
"""

from __future__ import annotations

import json
import math
import pickle
import sys
import time
from concurrent.futures import CancelledError

import numpy as np
import torch
import torch.distributed as dist

from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, param_specs)
from kubeflow_tpu_torch.parallel import comm
from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_hybrid_mesh,
                                              build_mesh, mesh_config)
from kubeflow_tpu_torch.parallel.partition_rules import gather_tree
from kubeflow_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor
from kubeflow_tpu_torch.runtime.data import shard_batch


def _mesh(sizes: dict):
    """(mesh over the first ranks, whether this rank is in it)."""
    cfg = MeshConfig(**sizes)
    mesh = build_mesh(cfg, "cpu", ranks=range(cfg.size))
    return mesh, dist.get_rank() < cfg.size


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _np_tree(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return tree


def _full_params(params, mesh, config, rules=None):
    return _np_tree(gather_tree(params, param_specs(config, rules), mesh))


def _model_config(config: dict, case: dict):
    """The case's model: a TransformerConfig, or an MoEConfig when the
    case carries ``moe`` (the MoE fields); ``attention`` if it names one."""
    from kubeflow_tpu_torch.models.moe import MoEConfig
    kw = dict(config)
    if case.get("attention"):
        kw["attention"] = case["attention"]
    if case.get("moe") is not None:
        return MoEConfig(**kw, **case["moe"])
    return TransformerConfig(**kw)


# --------------------------------------------------------------- parallel
def _attention_case(case: dict) -> dict:
    from kubeflow_tpu_torch.parallel.ring import ring_attention
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    spec_q = (None, "sp", "tp", None)
    spec_kv = (None, "sp", None, None) if case.get("kv_replicated") \
        else spec_q
    q = shard_tensor(_t(case["q"]), spec_q, mesh).requires_grad_()
    k, v = (shard_tensor(_t(case[n]), spec_kv, mesh).requires_grad_()
            for n in ("k", "v"))
    if case["fn"] == "ring":
        out = ring_attention(q, k, v, mesh=mesh, causal=case["causal"])
    else:
        out = ulysses_attention(q, k, v, mesh=mesh, causal=case["causal"],
                                n_rep=case["n_rep"])
    out.backward(shard_tensor(_t(case["dout"]), spec_q, mesh))
    grads = [k.grad, v.grad]
    if case.get("kv_replicated"):
        # each tp rank's grad of the replicated K/V covers its own heads
        grads = [comm.all_reduce_(g, mesh, "tp") for g in grads]
    return {"out": unshard_tensor(out.detach(), spec_q, mesh).numpy(),
            "dq": unshard_tensor(q.grad, spec_q, mesh).numpy(),
            "dk": unshard_tensor(grads[0], spec_kv, mesh).numpy(),
            "dv": unshard_tensor(grads[1], spec_kv, mesh).numpy()}


def _comm_case() -> dict:
    """Each differentiated collective's backward is its transpose."""
    mesh, member = _mesh({"fsdp": 2, "sp": 2})
    if not member:
        return {}
    me = dist.get_rank()
    got = {}
    # all_gather over fsdp along dim 1 ↔ reduce-scatter: d/dx sum(w * y)
    # for the same w on both fsdp ranks is fsdp x this rank's slice of w
    x = torch.full((3, 2), float(me)).requires_grad_()
    w = torch.arange(12.0).reshape(3, 4)
    y = comm.all_gather(x, mesh, "fsdp", dim=1)
    (y * w).sum().backward()
    f = comm.axis_rank(mesh, "fsdp")
    got["all_gather"] = bool(torch.equal(x.grad, 2 * w[:, 2 * f:2 * f + 2]))
    # all_to_all there and back is the identity, in value and in grad
    x = torch.randn(2, 4, 6, 3, generator=torch.Generator().manual_seed(me))
    x.requires_grad_()
    z = comm.all_to_all(comm.all_to_all(x, mesh, "sp", split=2, concat=1),
                        mesh, "sp", split=1, concat=2)
    z.backward(torch.ones_like(z) * 3)
    got["all_to_all"] = bool(torch.equal(z, x)) and bool(
        torch.equal(x.grad, torch.full_like(x, 3.0)))
    # ring_shift: the previous rank's tensor; its grad goes back
    x = torch.full((2,), float(me)).requires_grad_()
    (y,) = comm.ring_shift((x,), mesh, "sp")
    prev = comm.axis_rank(mesh, "sp") ^ 1      # sp = 2: the other rank
    (y * (prev + 1)).sum().backward()
    s = comm.axis_rank(mesh, "sp")
    got["ring_shift"] = float(y[0]) == float(me - s + prev) and bool(
        torch.equal(x.grad, torch.full((2,), float(s + 1))))
    # reduce_from ↔ identity, copy_to ↔ all-reduce, over fsdp
    x = torch.full((2,), float(me)).requires_grad_()
    comm.reduce_from(x, mesh, "fsdp").sum().backward()
    got["reduce_from"] = bool(torch.equal(x.grad, torch.ones(2)))
    x = torch.full((2,), float(me)).requires_grad_()
    (comm.copy_to(x, mesh, "fsdp") * (f + 1)).sum().backward()
    got["copy_to"] = bool(torch.equal(x.grad, torch.full((2,), 3.0)))
    return got


def _placements_case(arrays: dict) -> dict:
    """shard_tensor equals DTensor's local shard under the placements."""
    from torch.distributed.tensor import distribute_tensor

    from kubeflow_tpu_torch.parallel.sharding import Sharding
    mesh, member = _mesh({"dp": 2, "tp": 2})
    if not member:
        return {}
    got = {}
    for name, (spec, full) in arrays.items():
        sh = Sharding(mesh, spec)
        local = distribute_tensor(_t(full), mesh, sh.placements).to_local()
        mine = sh.shard(_t(full))
        got[name] = bool(torch.equal(local, mine)) and bool(
            torch.equal(sh.gather(mine), _t(full)))
    return got


def _hybrid_case() -> dict:
    mesh, full = build_hybrid_mesh(2, MeshConfig(fsdp=1, tp=2), "cpu",
                                   ranks=range(4))
    return {"ranks": mesh.mesh.numpy(), "config": full.axis_sizes()}


def parallel_suite(rank: int, world: int, cases: list) -> dict:
    out = {}
    for case in cases:
        kind = case["kind"]
        if kind == "attention":
            out[case["name"]] = _attention_case(case)
        elif kind == "comm":
            out["comm"] = _comm_case()
        elif kind == "placements":
            out["placements"] = _placements_case(case["arrays"])
        elif kind == "hybrid":
            out["hybrid"] = _hybrid_case()
    return out


def deadlock(rank: int, world: int) -> None:
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(1))


def pipe_deadlock(rank: int, world: int) -> None:
    """Stage 1 of pp = 2 waits in a pipeline tick's receive whose send
    never comes (stage 0 idles past the collective timeout)."""
    import time
    mesh = build_mesh(MeshConfig(pp=2), "cpu")
    if rank == 1:
        comm.stage_shift([], [((2,), torch.float32)], torch.zeros(()), mesh,
                         "pp")
    else:
        time.sleep(8)


# ------------------------------------------------------------------ train
def _step_case(case: dict, config: dict) -> dict:
    """Two steps (and a third from the start with a clip that does not
    bind, for the first step's grads) of the family's sharded step from
    the case's params: dense or MoE (``make_sharded_train_step``), or
    LoRA adapters over the case's ``base`` (``make_sharded_lora_step``)."""
    from kubeflow_tpu_torch.models import lora as tl
    c = _model_config(config, case)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    rules = ttr.mesh_rules(mesh)
    n_micro = case.get("n_micro")
    lora = tl.LoRAConfig(**case["lora"]) if "lora" in case else None
    if lora is not None:
        base = convert.to_torch_sharded(case["base"], mesh, c)
        base_before = [x.clone() for x in ttr.tree_leaves(base)]
        specs = tl.lora_specs(c, lora)
    else:
        specs = param_specs(c, rules)

    def start(tc):
        params, opt = ttr.init_train_state(convert.to_torch_sharded(
            case["params"], mesh, c, rules, specs=specs), tc)
        if lora is None:
            _, step_fn = ttr.make_sharded_train_step(
                mesh, c, tc, accum_steps=case["accum"],
                n_microbatches=n_micro)
        else:
            _, lora_step = tl.make_sharded_lora_step(mesh, c, lora, tc)

            def step_fn(p, o, t, tg):
                return lora_step(base, p, o, t, tg)
        return step_fn, params, opt

    def batch(x):
        return _t(shard_batch(x, mesh, n_microbatches=n_micro))

    tc = ttr.TrainConfig(**case["tc"])
    step_fn, params, opt = start(tc)
    losses = []
    for tokens, targets in case["batches"]:
        params, opt, loss = step_fn(params, opt, batch(tokens),
                                    batch(targets))
        losses.append(loss.item())
    out = {"losses": losses,
           "params": _np_tree(gather_tree(params, specs, mesh)),
           "replicas_equal": _replicas_equal(params, specs, mesh)}
    if lora is not None:
        out["base_kept"] = all(torch.equal(a, b) for a, b in zip(
            ttr.tree_leaves(base), base_before))
    # one step more from the same start with a clip that does not bind:
    # the first moment is then (1 - b1) x the step's gradient, reduced
    # over the mesh, scale included
    tc = ttr.TrainConfig(**case["tc"], grad_clip=1e9)
    step_fn, params, opt = start(tc)
    tokens, targets = case["batches"][0]
    step_fn(params, opt, batch(tokens), batch(targets))
    out["grads"] = _np_tree(ttr.tree_map(
        lambda m: m / (1 - tc.b1), gather_tree(opt.mu, specs, mesh)))
    out["replicas_equal"] &= _replicas_equal(opt.mu, specs, mesh)
    return out


def _replicas_equal(tree, specs, mesh) -> bool:
    """Whether every rank holding the same slice of a leaf (the ranks
    along each axis it is not sharded on) holds the same values: a grad
    left partial on some replicas (on one pp stage, say) makes them
    drift apart, which the gathered tensors of one rank would not
    show."""
    from kubeflow_tpu_torch.parallel.sharding import sharded_axes
    same = True
    for x, spec in zip(ttr.tree_leaves(tree), ttr.tree_leaves(specs)):
        axes = [a for a in mesh.mesh_dim_names
                if a not in sharded_axes(spec)]
        hi = comm.all_reduce_(x.detach().clone(), mesh, axes, "max")
        lo = -comm.all_reduce_(-x.detach(), mesh, axes, "max")
        same &= bool(torch.equal(hi, x)) and bool(torch.equal(lo, x))
    # the answer of every rank: true only if no rank found a difference
    differs = torch.tensor(0.0 if same else 1.0)
    return comm.all_reduce_(differs, mesh, mesh.mesh_dim_names,
                            "max").item() == 0.0


def _vocab_case(case: dict, config: dict) -> dict:
    """Whole and chunked CE and the embedding/LM-head grads at tp = 2."""
    c = TransformerConfig(**config)
    mesh, member = _mesh({"tp": 2})
    if not member:
        return {}
    params = ttr.tree_map(lambda p: p.requires_grad_(),
                          convert.to_torch_sharded(case["params"], mesh, c))
    tokens, targets = _t(case["tokens"]), _t(case["targets"])
    specs = param_specs(c)
    out = {}
    for name, loss in (
            ("whole", lambda: ttr.loss_fn(params, tokens, targets, c, mesh)),
            ("chunked", lambda: ttr.fused_loss_fn(
                params, tokens, targets, c, chunk_tokens=8, mesh=mesh))):
        value = loss()
        g_embed, g_head = torch.autograd.grad(
            value, [params["embed"], params["lm_head"]])
        out[name] = {
            "loss": value.item(),
            "embed": unshard_tensor(g_embed, specs["embed"], mesh).numpy(),
            "lm_head": unshard_tensor(g_head, specs["lm_head"],
                                      mesh).numpy()}
    return out


def _clip_case(case: dict, config: dict) -> dict:
    """The clip norm of sharded grads against the full grads' norm."""
    from kubeflow_tpu_torch.parallel.sharding import sharded_axes
    c = TransformerConfig(**config)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    specs = ttr.tree_leaves(param_specs(c))
    local = [shard_tensor(_t(g), s, mesh)
             for g, s in zip(ttr.tree_leaves(case["grads"]), specs)]
    norm = ttr.global_norm(local, mesh, [tuple(sharded_axes(s))
                                         for s in specs])
    return {"norm": norm.item()}


def _resume_case(case: dict, config: dict) -> dict:
    """Trainer A checkpoints step 4; Trainer B resumes it; both run
    steps 5-6 on the same batches and evaluate."""
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    c = _model_config(config, case)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    tc = ttr.TrainConfig(warmup_steps=2)
    batches = list(synthetic_lm_batches(8, 32, c.vocab_size, n_batches=6,
                                        seed=3))
    held_out = list(synthetic_lm_batches(8, 32, c.vocab_size, n_batches=2,
                                         seed=4))
    kw = dict(mesh=mesh, checkpoint_dir=case["dir"], checkpoint_interval=4,
              max_checkpoints=1)
    out = {}
    with Trainer(c, tc, **kw) as a:
        a.fit(batches[:4], steps=4, log_every=1)
        a.save()
        with Trainer(c, tc, **kw) as b:
            out["resumed_step"] = b.stats.step
            losses = {}
            for name, tr in (("a", a), ("b", b)):
                tr.fit(batches[4:], steps=2, log_every=1)
                losses[name] = [x for _, x in tr.stats.losses][-2:]
            out["losses"] = losses
            out["params_equal"] = all(
                torch.equal(x, y) for x, y in zip(
                    ttr.tree_leaves(a.params), ttr.tree_leaves(b.params)))
            out["eval"] = [tr.evaluate(held_out) for tr in (a, b)]
            out["tokens_seen"] = b.stats.tokens_seen
    return out


def _eval_case(case: dict, config: dict) -> dict:
    """Trainer(mesh=...).evaluate on the held-out batches, and the
    Trainer's params gathered, for the parent to evaluate them too."""
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    c = TransformerConfig(**config)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    with Trainer(c, ttr.TrainConfig(), mesh=mesh) as tr:
        return {"eval": tr.evaluate(case["batches"]),
                "params": _full_params(tr.params, mesh, c)}


def _trainer_eval_case(case: dict, config: dict) -> dict:
    """Trainer(mesh=...).evaluate of the case's params (dense or MoE), or
    of its adapters over its base (LoRA), on the held-out batches."""
    from kubeflow_tpu_torch.models import lora as tl
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    c = _model_config(config, case)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    kw = {}
    specs = None
    if "lora" in case:
        lora = tl.LoRAConfig(**case["lora"])
        kw = dict(lora=lora, base_params=convert.to_torch(case["base"]))
        specs = tl.lora_specs(c, lora)
    with Trainer(c, ttr.TrainConfig(), mesh=mesh, **kw) as tr:
        tr.params = convert.to_torch_sharded(
            case["params"], mesh, c, ttr.mesh_rules(mesh), specs=specs)
        return {"eval": tr.evaluate(case["batches"])}


def _restore_case(case: dict, config: dict) -> dict:
    """A checkpoint of mesh ``from`` restored onto each mesh of ``to``:
    every leaf of params and optimizer state bit-equal, the step kept,
    and one more train step on the new mesh. With ``chain`` each mesh of
    ``to`` writes the state it restored again, and the next restores
    that (A → B → C, each hop bit-equal to A's state)."""
    from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
    c = _model_config(config, case)
    tc = ttr.TrainConfig(warmup_steps=1)

    def specs(mesh):
        return param_specs(c, ttr.mesh_rules(mesh))

    def full_state(params, opt, mesh):
        return [gather_tree(t, s, mesh) for t, s in (
            (params, specs(mesh)),
            (opt, ttr.opt_state_shardings(opt, specs(mesh))))]

    def batch(mesh, seed, rows=None):
        cfg = mesh_config(mesh)
        rows = rows or 2 * cfg.dp * cfg.fsdp * (2 * cfg.pp if cfg.pp > 1
                                                else 1)
        tokens = np.random.default_rng(seed).integers(0, c.vocab_size,
                                                      (rows, 16))
        targets = np.roll(tokens, -1, axis=1)
        return (_t(shard_batch(tokens, mesh)),
                _t(shard_batch(targets, mesh)))

    mesh, member = _mesh(case["from"])
    # every rank of the world gathers the want state (a collective of the
    # source mesh's ranks), so each later hop's members hold it
    want = None
    if member:
        init_fn, step_fn = ttr.make_sharded_train_step(mesh, c, tc)
        params, opt = init_fn(torch.Generator().manual_seed(0))
        params, opt, _ = step_fn(params, opt, *batch(mesh, 1, rows=8))
        with TrainCheckpointer(case["dir"], mesh=mesh,
                               param_specs=specs(mesh)) as ckpt:
            assert ckpt.save(3, params, opt)
        want = full_state(params, opt, mesh)
    want = _broadcast_from_zero(want)
    out = {}
    src = case["dir"]
    for hop, (label, sizes) in enumerate(case["to"].items()):
        new, member = _mesh(sizes)
        dst = f"{case['dir']}-{hop}" if case.get("chain") else None
        if member:
            init_fn, step_fn = ttr.make_sharded_train_step(new, c, tc)
            like_p, like_o = init_fn(torch.Generator().manual_seed(7))
            with TrainCheckpointer(src, mesh=new,
                                   param_specs=specs(new)) as ckpt:
                step, params, opt = ckpt.restore(like_p, like_o)
            got = full_state(params, opt, new)
            equal = all(torch.equal(x, y) for g, w in zip(got, want)
                        for x, y in zip(_leaves(g), _leaves(w)))
            if dst is not None:
                with TrainCheckpointer(dst, mesh=new,
                                       param_specs=specs(new)) as ckpt:
                    assert ckpt.save(3, params, opt)
            _, _, loss = step_fn(params, opt, *batch(new, 2))
            out[label] = {"step": step, "equal": equal,
                          "wq_local": tuple(params["blocks"]["wq"].shape),
                          "w_gate_local": tuple(
                              params["blocks"]["w_gate"].shape),
                          "loss": loss.item()}
        dist.barrier()
        if dst is not None:
            src = dst
    return out


def _broadcast_from_zero(obj):
    """Rank 0's picklable ``obj`` on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _world1_case(case: dict, config: dict) -> dict:
    """On a mesh of one rank the sharded step is make_train_step's."""
    c = TransformerConfig(**config)
    mesh, member = _mesh({})
    if dist.get_rank() != 0:
        return {}
    tc = ttr.TrainConfig(warmup_steps=2)
    runs = []
    for init_fn, step_fn in (
            ttr.make_sharded_train_step(mesh, c, tc, accum_steps=2),
            ttr.make_train_step(c, tc, "cpu", accum_steps=2)):
        params, opt = init_fn(torch.Generator().manual_seed(0))
        losses = []
        for tokens, targets in case["batches"]:
            params, opt, loss = step_fn(params, opt, _t(tokens),
                                        _t(targets))
            losses.append(loss)
        runs.append((losses, params))
    (la, pa), (lb, pb) = runs
    return {"losses_equal": all(torch.equal(x, y) for x, y in zip(la, lb)),
            "params_equal": all(torch.equal(x, y) for x, y in zip(
                ttr.tree_leaves(pa), ttr.tree_leaves(pb)))}


def _remat_case(case: dict, config: dict) -> dict:
    """Each remat policy's two steps against no remat, on a mesh where the
    fsdp gathers and the ring's rotations run inside the checkpointed
    regions (and again in their recompute)."""
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    tc = ttr.TrainConfig(warmup_steps=2)
    runs = {}
    for remat in (False, True, "attn", "mlp"):
        c = TransformerConfig(**config, remat=remat)
        init_fn, step_fn = ttr.make_sharded_train_step(mesh, c, tc)
        params, opt = init_fn(torch.Generator().manual_seed(0))
        losses = []
        for tokens, targets in case["batches"]:
            params, opt, loss = step_fn(params, opt,
                                        _t(shard_batch(tokens[0], mesh)),
                                        _t(shard_batch(targets[0], mesh)))
            losses.append(loss.item())
        runs[str(remat)] = (losses, ttr.tree_leaves(params))
    base_losses, base = runs.pop("False")
    return {k: {"losses_equal": losses == base_losses,
                "max_param_diff": max(float((a - b).abs().max())
                                      for a, b in zip(leaves, base))}
            for k, (losses, leaves) in runs.items()}


def _world1_families_case(case: dict, config: dict) -> dict:
    """On a mesh of one rank the MoE and LoRA sharded steps are the
    one-device steps: losses and params bit-equal."""
    from kubeflow_tpu_torch.models import lora as tl
    from kubeflow_tpu_torch.models import moe as tm
    mesh, member = _mesh({})
    if dist.get_rank() != 0:
        return {}
    tc = ttr.TrainConfig(warmup_steps=2)
    moe = _model_config(config, case)
    c = TransformerConfig(**config)
    lora = tl.LoRAConfig()
    base = init_params(torch.Generator().manual_seed(5), c, "cpu")
    out = {}
    for family, makers in (
            ("moe", (lambda: ttr.make_sharded_train_step(mesh, moe, tc),
                     lambda: tm.make_moe_train_step(moe, tc, "cpu"))),
            ("lora", (lambda: tl.make_sharded_lora_step(mesh, c, lora, tc),
                      lambda: tl.make_lora_step(c, lora, tc, "cpu")))):
        runs = []
        for make in makers:
            init_fn, step_fn = make()
            params, opt = init_fn(torch.Generator().manual_seed(0))
            losses = []
            for tokens, targets in case["batches"]:
                args = (params, opt, _t(tokens[0]), _t(targets[0]))
                if family == "lora":
                    args = (base,) + args
                params, opt, loss = step_fn(*args)
                losses.append(loss)
            runs.append((losses, ttr.tree_leaves(params)))
        (la, pa), (lb, pb) = runs
        out[family] = {
            "losses_equal": all(torch.equal(x, y) for x, y in zip(la, lb)),
            "params_equal": all(torch.equal(x, y) for x, y in zip(pa, pb))}
    return out


# --------------------------------------------------------------- pipeline
def _pipe_apply_case(case: dict) -> dict:
    """``pipeline_apply`` of a tanh layer stack at pp4 × dp2: the value
    and the grads of input and params (summed over dp), gathered."""
    from kubeflow_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                      split_stages)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    rows = (("dp", "fsdp"), None)
    params = {"w": shard_tensor(_t(case["w"]), ("pp", None, None), mesh),
              "b": shard_tensor(_t(case["b"]), ("pp", None), mesh)}
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = shard_tensor(_t(case["x"]), rows, mesh).requires_grad_()

    def stage_fn(p, h):
        for i in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][i] + p["b"][i])
        return h

    y = pipeline_apply(split_stages(params, 1), x, stage_fn, mesh=mesh,
                       n_microbatches=case["n_micro"])
    value = (y * shard_tensor(_t(case["cot"]), rows, mesh)).sum()
    gw, gb, gx = torch.autograd.grad(value, [params["w"], params["b"], x])
    for g in (value.detach(), gw, gb):
        comm.all_reduce_(g, mesh, ("dp", "fsdp"))
    return {"value": value.item(),
            "w": unshard_tensor(gw, ("pp", None, None), mesh).numpy(),
            "b": unshard_tensor(gb, ("pp", None), mesh).numpy(),
            "x": unshard_tensor(gx, rows, mesh).numpy()}


def _pipe_forward_case(case: dict, config: dict) -> dict:
    """``pipelined_forward``'s logits and the grads of sum(logits * cot)
    on the case's mesh, gathered (grads summed over the data axes)."""
    from kubeflow_tpu_torch.models.transformer import pipelined_forward
    from kubeflow_tpu_torch.parallel.sharding import sharded_axes
    c = TransformerConfig(**config)
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    rules = ttr.mesh_rules(mesh)
    n_micro = case["n_micro"]
    params = ttr.tree_map(lambda p: p.requires_grad_(),
                          convert.to_torch_sharded(case["params"], mesh, c,
                                                   rules))
    tokens = _t(shard_batch(case["tokens"], mesh, n_microbatches=n_micro))
    # the cotangent's rows and sequence laid out as shard_batch lays out
    # the tokens: each data rank's share of every microbatch
    cot = _t(case["cot"])
    B, S, V = cot.shape
    cot = shard_tensor(cot.reshape(n_micro, B // n_micro, S, V),
                       (None, ("dp", "fsdp"), "sp", None), mesh)
    cot = cot.reshape(-1, *cot.shape[2:])
    logits = pipelined_forward(params, tokens, c, mesh, n_micro, rules)
    value = (logits * cot).sum()
    specs = param_specs(c, rules)
    grads = torch.autograd.grad(value, ttr.tree_leaves(params))
    axes = ttr.data_axes(rules)
    for g, spec in zip(grads, ttr.tree_leaves(specs)):
        comm.all_reduce_(g, mesh, [a for a in axes
                                   if a not in sharded_axes(spec)])
    value = comm.all_reduce_(value.detach(), mesh, axes)
    full = comm.gather_dim(comm.gather_dim(logits.detach(), mesh, "sp", 1),
                           mesh, ("dp", "fsdp"), 0)
    # back from the microbatch-major layout to the batch's row order
    D = comm.axis_size(mesh, ("dp", "fsdp"))
    full = full.reshape(D, n_micro, -1, S, V).transpose(0, 1).reshape(
        B, S, V)
    return {"value": value.item(), "logits": full.numpy(),
            "grads": _np_tree(gather_tree(
                ttr.tree_unflatten(params, list(grads)), specs, mesh))}


def _pipe_comm_case() -> dict:
    """The pipeline's collectives on pp = 4: a tick's shift moves each
    stage's tensor to the next stage and its grad back; the broadcast
    from the last stage returns the grad to the last stage once."""
    mesh, member = _mesh({"pp": 4})
    if not member:
        return {}
    s = comm.axis_rank(mesh, "pp")
    got = {}
    x = torch.full((3,), float(s + 1)).requires_grad_()
    anchor = comm.anchor_of([x], x.device)
    # stage s sends (s + 1) forward, stage s + 1 receives it
    send = [x] if s < 3 else []
    recv = [((3,), torch.float32)] if s > 0 else []
    received, token = comm.stage_shift(send, recv, anchor, mesh, "pp")
    y = x * 0 if s == 0 else received[0] * 10
    y = comm.tie(y, token)
    y.sum().backward()
    got["shift_value"] = s == 0 or float(received[0][0].detach()) == s
    # the grad of stage s's x is the next stage's 10; the last stage
    # sends nothing and uses no x
    got["shift_grad"] = float(x.grad[0]) == 10.0 if s < 3 else \
        x.grad is None
    x = torch.full((2,), float(s)).requires_grad_()
    y = comm.broadcast_from_last(x, mesh, "pp")
    (y * 5).sum().backward()
    got["broadcast_value"] = bool(torch.equal(y, torch.full((2,), 3.0)))
    got["broadcast_grad"] = x.grad is not None and float(x.grad[0]) == 5.0 \
        if s == 3 else x.grad is None
    return got


def _moe_errors_case(case: dict, config: dict) -> dict:
    """The pipelined MoE's refusals: pp × sp, and routing groups that a
    microbatch would change."""
    from kubeflow_tpu_torch.models.moe import pipelined_moe_forward_hidden
    c = _model_config(config, case)
    out = {}
    for name, sizes in case["meshes"].items():
        mesh, member = _mesh(sizes)
        if not member:
            continue
        params = convert.to_torch_sharded(case["params"], mesh, c,
                                          ttr.mesh_rules(mesh))
        tokens = _t(shard_batch(case["tokens"], mesh, n_microbatches=4))
        try:
            pipelined_moe_forward_hidden(params, tokens, c, mesh, 4)
            out[name] = None
        except (ValueError, NotImplementedError) as exc:
            out[name] = (type(exc).__name__, str(exc))
    return out


def pipeline_suite(rank: int, world: int, job: dict) -> dict:
    out = {}
    for case in job["cases"]:
        kind = case["kind"]
        if kind == "pipe_apply":
            out[case["name"]] = _pipe_apply_case(case)
        elif kind == "pipe_forward":
            out[case["name"]] = _pipe_forward_case(case, case["config"])
        elif kind == "pipe_comm":
            out["pipe_comm"] = _pipe_comm_case()
        else:
            out.update(train_suite(rank, world, {"cases": [case]}))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def train_suite(rank: int, world: int, job: dict) -> dict:
    out = {}
    for case in job["cases"]:
        kind, config = case["kind"], case["config"]
        fn = {"step": _step_case, "vocab": _vocab_case, "clip": _clip_case,
              "resume": _resume_case, "restore": _restore_case,
              "world1": _world1_case, "remat": _remat_case,
              "eval": _eval_case, "trainer_eval": _trainer_eval_case,
              "moe_errors": _moe_errors_case,
              "world1_families": _world1_families_case}[kind]
        out[case["name"]] = fn(case, config)
    return out


# ----------------------------------------------------------------- decode
def decode_suite(rank: int, world: int, job: dict) -> dict:
    """tp-sharded decode against the same calls on the unsharded params."""
    from kubeflow_tpu_torch.models import decode as td
    from kubeflow_tpu_torch.models.speculative import speculative_generate
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    c = TransformerConfig(**job["config"])
    dc = TransformerConfig(**job["draft_config"])
    mesh = build_mesh(MeshConfig(**job["mesh"]), "cpu")
    full = convert.to_torch(job["params"])
    draft_full = convert.to_torch(job["draft_params"])
    sharded = shard_decode_params(full, mesh, c)
    draft = shard_decode_params(draft_full, mesh, dc)
    prompt = _t(job["prompt"])
    n = job["max_new"]
    out = {"local_wk": tuple(sharded["blocks"]["wk"].shape)}
    with torch.no_grad():
        for kv_quant in (False, True):
            key = "int8" if kv_quant else "f32"
            out[f"generate_{key}"] = [
                td.generate(p, prompt, c, n, kv_quant=kv_quant).numpy()
                for p in (sharded, full)]
        # prefill, then a decode step at per-row positions, then a window
        P = prompt.shape[1]
        pos = torch.tensor([P, P - 2])
        steps = {}
        for name, p in (("sharded", sharded), ("full", full)):
            logits, cache = td.prefill(p, prompt, c)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            step_logits, cache = td.decode_step(p, cache, tok, pos, c)
            window = _t(job["window"])
            win_logits, cache = td.decode_window(p, cache, window, pos + 1, c)
            steps[name] = {"prefill": logits.numpy(),
                           "step": step_logits.numpy(),
                           "window": win_logits.numpy(),
                           "cache_k": tuple(cache["k"].shape)}
        out["steps"] = steps
        spec = {}
        for name, (t, d, dconf) in (
                ("self", (sharded, sharded, c)),
                ("draft", (sharded, draft, dc))):
            ids, stats = speculative_generate(t, d, prompt, c, dconf,
                                              max_new_tokens=n, k=3)
            spec[name] = {"ids": ids.numpy(),
                          "accepted": int(stats.accepted.sum()),
                          "drafted": int(stats.drafted.sum())}
        ids, _ = speculative_generate(sharded, draft, prompt, c, dc,
                                      max_new_tokens=n, k=3, kv_quant=True)
        spec["draft_int8"] = {"ids": ids.numpy()}
        out["spec"] = spec
    out["finite"] = math.isfinite(float(np.abs(
        out["steps"]["sharded"]["window"]).max()))
    out["follower_submit"] = _follower_submits(sharded, c)
    return out


def _follower_submits(sharded, config) -> dict:
    """Each engine built over the mesh on every rank: what ``submit``
    raises on each follower (rank 0, the driver, takes requests)."""
    from kubeflow_tpu_torch.runtime import serving
    out = {}
    for name in ("BatchedGenerator", "ContinuousBatchedGenerator"):
        gen = getattr(serving, name)(sharded, config, device="cpu")
        msg = "driver"
        if dist.get_rank() != 0:
            try:
                gen.submit(np.arange(4, dtype=np.int32), 2)
                msg = "accepted"
            except RuntimeError as exc:
                msg = str(exc)
        gen.close()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, msg)
        out[name] = every
    return out


# ---------------------------------------------------------------- serving
def _record_requests(gen) -> list:
    """Every request ``gen`` admits on this rank, in admission order: the
    driver's own, a follower's built from the driver's plans."""
    seen = []
    if hasattr(gen, "_begin_admission"):
        begin = gen._begin_admission

        def recording(req, slot):
            seen.append(req)
            return begin(req, slot)
        gen._begin_admission = recording
    else:
        run = gen._run_batch

        def recording(batch):
            seen.extend(batch)
            return run(batch)
        gen._run_batch = recording
    return seen


def _outcomes(requests, timeout: float = 60.0) -> list:
    """Each request's ids, or the name of the exception it failed with."""
    out = []
    for req in requests:
        try:
            out.append([int(t) for t in req.future.result(timeout=timeout)])
        except BaseException as exc:  # noqa: BLE001 — reported
            out.append(type(exc).__name__)
    return out


# a group of the whole world for the tests' own barriers: the engine
# threads' collectives may run on the default group (a mesh axis spanning
# the world is that group), and two threads' collectives on one group
# would pair up in different orders on different ranks
_SYNC = []


def _sync() -> None:
    dist.barrier(group=_SYNC[0])


_COUNTERS = ("admitted_total", "admitted_while_running", "steps_total",
             "prefill_chunks_total", "prefix_cache_hits_total",
             "cancelled_total", "spec_ticks", "spec_drafted",
             "spec_accepted", "batches_total")


def _serve(engine_cls, params, config, drive, **kw) -> dict:
    """Build the engine on every rank, let the driver ``drive`` it after
    every rank is recording, close it on every rank once the driver is
    done (a follower's close waits for the driver's); this rank's view:
    its requests' outcomes in admission order, the counters, and what
    ``drive`` returned on the driver."""
    gen = engine_cls(params, config, device="cpu", **kw)
    seen = _record_requests(gen)
    _sync()
    got = None
    try:
        if dist.get_rank() == 0:
            got = drive(gen)
    finally:
        _sync()
        gen.close()
    return {"outcomes": _outcomes(seen), "driven": got,
            "counters": {k: getattr(gen, k) for k in _COUNTERS
                         if hasattr(gen, k)}}


def _ids(fut, timeout: float = 60.0) -> list:
    return [int(t) for t in fut.result(timeout=timeout)]


def _drive_dense(prompts, long_prompt, n):
    """The prompts one after the other, one admitted while another
    decodes, a cancellation, and a prefix-cache hit."""
    def drive(gen):
        out = {"plain": [_ids(gen.submit(p, n)) for p in prompts[:2]]}
        late, streamed = {}, []

        def admit_late(tok):
            streamed.append(tok)
            if len(streamed) == 3:
                late["f"] = gen.submit(prompts[2], n)
        first = gen.submit(prompts[3], n, on_token=admit_late)
        out["running"] = _ids(first)
        out["late"] = _ids(late["f"])
        holder, delivered = {}, []

        def cancel_at_2(tok):
            delivered.append(tok)
            if len(delivered) == 2:
                gen.cancel(holder["f"])
        holder["f"] = gen.submit(prompts[0], n, on_token=cancel_at_2)
        try:
            holder["f"].result(timeout=60)
            out["cancelled"] = False
        except CancelledError:
            out["cancelled"] = True
        out["prefix"] = [_ids(gen.submit(long_prompt, n)) for _ in range(2)]
        return out
    return drive


def _drive_each(prompts, n, **kw):
    """All the prompts at once."""
    def drive(gen):
        futs = [gen.submit(p, n, **kw) for p in prompts]
        return [_ids(f) for f in futs]
    return drive


def _drive_in_turn(prompts, n, **kw):
    """One prompt after the other: the same ticks, and so the same
    sampling draws, on every engine with the same seed."""
    def drive(gen):
        return [_ids(gen.submit(p, n, **kw)) for p in prompts]
    return drive


def _quant_scales_equal(full, sharded) -> bool:
    """Whether each rank's int8 weights and scales are its slice of the
    unsharded tree's ``quantize_params``."""
    from kubeflow_tpu_torch.models.quant import quantize_params
    qf, qs = quantize_params(full), quantize_params(sharded)
    mesh, specs = sharded.mesh, sharded.specs
    pairs = [(qf["lm_head"], qs["lm_head"], specs["lm_head"], (0,))]
    from kubeflow_tpu_torch.models.quant import BLOCK_AXES
    pairs += [(qf["blocks"][k], qs["blocks"][k], specs["blocks"][k], axes)
              for k, axes in BLOCK_AXES.items()]
    same = True
    for f, s, spec, axes in pairs:
        scale_spec = tuple(None if d in axes else e
                           for d, e in enumerate(spec))
        same &= torch.equal(shard_tensor(f["q"], spec, mesh), s["q"])
        same &= torch.equal(shard_tensor(f["s"], scale_spec, mesh), s["s"])
    return bool(same)


def serving_suite(rank: int, world: int, job: dict) -> dict:
    """Both engines over meshes of the whole world: dense on tp2 and tp4
    (greedy, a late admission, a cancellation, a prefix-cache hit,
    steps_per_sync 4, speculation with a sharded draft, sampling, int8),
    the MoE on tp x ep and fsdp x ep, and a failure on one rank. Returns
    this rank's view of each case."""
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.moe import MoEConfig
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator as Continuous)
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    _SYNC[:] = [dist.new_group()]
    c = TransformerConfig(**job["config"])
    dc = TransformerConfig(**job["draft_config"])
    mc = MoEConfig(**job["moe_config"])
    full = convert.to_torch(job["params"])
    draft_full = convert.to_torch(job["draft_params"])
    moe_full = convert.to_torch(job["moe_params"])
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    long_prompt = np.asarray(job["long_prompt"], np.int32)
    n = job["max_new"]
    out = {}
    with torch.no_grad():
        for name, tp in (("tp2", 2), ("tp4", 4)):
            mesh = build_mesh(MeshConfig.auto(world, tp=tp), "cpu")
            sh = shard_decode_params(full, mesh, c)
            out[f"{name}_continuous"] = _serve(
                Continuous, sh, c, _drive_dense(prompts, long_prompt, n),
                n_slots=4, prefill_chunk=8)
            out[f"{name}_bucketed"] = _serve(
                BatchedGenerator, sh, c, _drive_each(prompts, n),
                max_batch=4, max_wait_s=0.5)
            if tp == 2:
                out["tp2_sync4"] = _serve(Continuous, sh, c,
                                          _drive_each(prompts, n),
                                          n_slots=4, prefill_chunk=8,
                                          steps_per_sync=4)
                draft = shard_decode_params(draft_full, mesh, dc)
                out["tp2_spec"] = _serve(
                    Continuous, sh, c, _drive_each(prompts, n), n_slots=4,
                    prefill_chunk=8, draft_params=draft, draft_config=dc,
                    spec_k=3)
                out["tp2_sampled"] = _serve(
                    Continuous, sh, c,
                    _drive_in_turn(prompts, n, temperature=0.8), n_slots=4,
                    prefill_chunk=8, seed=5)
                out["tp2_int8"] = _serve(Continuous, sh, c,
                                         _drive_each(prompts, n), n_slots=4,
                                         prefill_chunk=8, quantize=True,
                                         kv_quant=True)
                out["int8_scales_equal"] = _quant_scales_equal(full, sh)
                if rank == 0:
                    # the unsharded engine at the same seed, on rank 0
                    out["unsharded_sampled"] = _serve_alone(
                        Continuous, full, c,
                        _drive_in_turn(prompts, n, temperature=0.8),
                        n_slots=4, prefill_chunk=8, seed=5)
                for where in ("admission", "delivery"):
                    out[f"tp2_failure_{where}"] = _failure_case(
                        Continuous, sh, c, prompts, n, where)
        for name, axes in (("tp2_ep2", dict(tp=2, ep=2)),
                           ("fsdp2_ep2", dict(ep=2))):
            mesh = build_mesh(MeshConfig.auto(world, **axes), "cpu")
            sh = shard_decode_params(moe_full, mesh, mc)
            out[f"moe_{name}_generate"] = generate(
                sh, torch.from_numpy(np.stack(prompts)), mc, n).numpy()
            out[f"moe_{name}_continuous"] = _serve(
                Continuous, sh, mc, _drive_each(prompts, n), n_slots=4,
                prefill_chunk=8)
            out[f"moe_{name}_local_w_gate"] = tuple(
                sh["blocks"]["w_gate"].shape)
    return out


def _serve_alone(engine_cls, params, config, drive, **kw):
    with engine_cls(params, config, device="cpu", **kw) as gen:
        return drive(gen)


def _fail_once(gen, name: str, before: bool, record=None) -> None:
    """Make ``gen``'s method ``name`` raise on its first call: before it
    runs with ``before`` (``record`` then sees its arguments, as the
    recording wrapper it replaces would), else after it returned."""
    method, failed = getattr(gen, name), []

    def flaky(*args):
        if failed:
            return method(*args)
        failed.append(1)
        if not before:
            method(*args)
        elif record is not None:
            record(*args)
        raise RuntimeError(f"injected {name} failure on rank 1")
    setattr(gen, name, flaky)


def _failure_case(engine_cls, params, config, prompts, n, where) -> dict:
    """A failure on rank 1 only, ``where`` = "admission" (raising as it
    begins the first admission, before the iteration's collectives) or
    "delivery" (as it collects the first tick's finished rows, after
    them): every rank fails the request, rebuilds its state, and serves
    the next one; a follower's submit raises."""
    gen = engine_cls(params, config, device="cpu", n_slots=2,
                     prefill_chunk=8)
    seen = _record_requests(gen)
    out = {}
    if dist.get_rank() == 1:
        if where == "admission":
            _fail_once(gen, "_begin_admission", True,
                       lambda req, slot: seen.append(req))
        else:
            _fail_once(gen, "_collect_finished", False)
    if dist.get_rank() != 0:
        try:
            gen.submit(prompts[0], n)
            out["follower_submit"] = "accepted"
        except RuntimeError as exc:
            out["follower_submit"] = str(exc)
    _sync()
    try:
        if dist.get_rank() == 0:
            t0 = time.monotonic()
            try:
                gen.submit(prompts[0], n).result(timeout=60)
                out["first"] = "served"
            except RuntimeError as exc:
                out["first"] = str(exc)
            out["fail_seconds"] = time.monotonic() - t0
            out["second"] = _ids(gen.submit(prompts[1], n))
    finally:
        _sync()
        gen.close()
    out["outcomes"] = _outcomes(seen)
    out["active_after"] = bool(gen._state["active"].any())
    return out


def _broken_cases(engines: dict, prompt, n) -> dict:
    """Each engine of ``engines`` (on a mesh of its own) fails on rank 1
    as it enters its first device work, before its collectives, which
    the driver then waits in until the world's timeout: each engine
    closes on every rank. The engines fail together. This rank's view of
    each: the request's outcome and its seconds on the driver, whether
    the engine thread ended and whether a later submit is refused."""
    seen = {name: _record_requests(gen) for name, gen in engines.items()}
    if dist.get_rank() == 1:
        for name, gen in engines.items():
            if hasattr(gen, "_tick"):
                _fail_once(gen, "_tick", True)
            else:
                _fail_once(gen, "_run_batch", True, seen[name].extend)
    _sync()
    out = {name: {} for name in engines}
    if dist.get_rank() == 0:
        t0 = time.monotonic()
        futs = {name: gen.submit(prompt, n) for name, gen in engines.items()}
        for name, fut in futs.items():
            try:
                fut.result(timeout=120)
                out[name]["first"] = "served"
            except Exception as exc:  # noqa: BLE001 — reported
                out[name]["first"] = type(exc).__name__
            out[name]["fail_seconds"] = time.monotonic() - t0
    for name, gen in engines.items():
        gen._thread.join(timeout=60)
        out[name]["thread_ended"] = not gen._thread.is_alive()
        if dist.get_rank() == 0:
            try:
                gen.submit(prompt, n)
                out[name]["later_submit"] = "accepted"
            except RuntimeError as exc:
                out[name]["later_submit"] = str(exc)
        gen.close()
        out[name]["outcomes"] = _outcomes(seen[name])
    return out


# ---------------------------------------------------------------- elastic
class DictClient:
    """A Notebook store of one process: ``get`` returns a copy,
    ``patch`` merges annotations (None deletes), as the control plane's
    client does for the calls the agents make."""

    def __init__(self, annotations: dict):
        self.obj = {"kind": "Notebook", "metadata": {
            "name": "nb", "namespace": "elastic-ns",
            "annotations": dict(annotations)}}
        self.calls = 0

    def get(self, kind, namespace, name):
        self.calls += 1
        import copy
        return copy.deepcopy(self.obj)

    def patch(self, kind, namespace, name, body):
        self.calls += 1
        anns = self.obj["metadata"]["annotations"]
        for k, v in body["metadata"]["annotations"].items():
            if v is None:
                anns.pop(k, None)
            else:
                anns[k] = v

    def annotation(self, key):
        return self.obj["metadata"]["annotations"].get(key)


class NoClient:
    """The client of a rank that must never read or patch."""

    def __getattr__(self, name):
        raise AssertionError(f"rank {dist.get_rank()} called client.{name}")


def _seed_checkpoint(directory, params_np, tc) -> None:
    """A step-0 checkpoint of the given (reference-initialised) params
    and their fresh optimizer state: a Trainer built on the directory
    starts from them."""
    from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
    params, opt = ttr.init_train_state(convert.to_torch(params_np), tc)
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(0, params, opt, force=True)


def _full_state(trainer, config) -> list:
    """Copies of the trainer's params and optimizer state as full
    tensors (a collective of its mesh; the optimizer updates the live
    ones in place)."""
    specs = param_specs(config, ttr.mesh_rules(trainer.mesh))
    return [[x.clone() for x in _leaves(gather_tree(trainer.params, specs,
                                                    trainer.mesh))],
            [x.clone() for x in _leaves(gather_tree(
                trainer.opt_state,
                ttr.opt_state_shardings(trainer.opt_state, specs),
                trainer.mesh))]]


def _bit_equal(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for la, lb in zip(a, b)
               for x, y in zip(la, lb))


def _raising_source():
    raise AssertionError("a standby rank drew a batch")
    yield  # noqa: unreachable — makes this a generator


def _elastic_cycle(job, c, tc, per) -> dict:
    """3 → 2 → 3 slices of ``per``: fit, shrink, fit, grow, fit."""
    from kubeflow_tpu_torch.runtime.elastic import ElasticTrainer
    rank = dist.get_rank()
    out = {"mesh_dp": [], "standby": [], "params": {}, "carried": []}
    with ElasticTrainer(per, 3, c, tc, job["dir"], device="cpu") as et:
        first_mesh = et.mesh
        def note(step):
            out["mesh_dp"].append(None if et.standby
                                  else mesh_config(et.mesh).dp)
            out["standby"].append(et.standby)
            if not et.standby:
                state = _full_state(et.trainer, c)
                if rank == 0:   # the leaves in sorted-key order
                    out["params"][step] = [x.numpy() for x in state[0]]
                return state
        for i, (chunk, steps) in enumerate(zip(job["batches"],
                                               (4, 3, 3))):
            if i:
                before = note(f"before_{i}")
                et.shrink() if i == 1 else et.grow()
                after = note(f"after_{i}")
                # a rank in both meshes holds the same state before and
                # after (standby on one side: nothing to hold)
                out["carried"].append(before is None or after is None
                                      or _bit_equal(before, after))
                if et.standby:
                    st = et.fit(_raising_source(), steps=steps)
                    out["standby_fit_step"] = st.step
                    out["standby_eval"] = et.evaluate(_raising_source())
            et.fit(chunk, steps=steps, log_every=1)
            note(et.stats.step)
        out["step"] = et.stats.step
        out["losses"] = list(et.stats.losses)
        out["tokens_seen"] = et.stats.tokens_seen
        out["events"] = [e[:3] for e in et.resize_events]
        # 3 → 2 → 3 made two meshes: growing back reused the first
        out["meshes_made"] = len(et._meshes)
        out["mesh_reused"] = et.mesh is first_mesh
        # no-ops and bounds, checked before any save
        et.resize(3)
        out["events_after_noop"] = len(et.resize_events)
        for bad in (0, 4):
            try:
                et.resize(bad)
                out[f"resize_{bad}"] = "accepted"
            except ValueError as exc:
                out[f"resize_{bad}"] = str(exc)
    with ElasticTrainer(per, 3, c, tc, job["dir"] + "-cap", device="cpu",
                        resize_events_cap=1) as et:
        et.shrink()
        et.grow()
        out["capped_events"] = [e[:2] for e in et.resize_events]
        out["capped_maxlen"] = et.resize_events.maxlen
    return out


def _agent_cycle(job, c, tc, per) -> dict:
    """ElasticAgent on every rank of the world, bound to a 2-slice
    ElasticTrainer: a Draining then Resharding-to-1 walk between fits.
    Rank 0 alone holds the Notebook."""
    from kubeflow_tpu_torch.runtime.elastic import (ElasticAgent,
                                                    ElasticTrainer)
    from kubeflow_tpu_torch.utils import names
    rank = dist.get_rank()
    client = DictClient(job["annotations"]) if rank == 0 else NoClient()
    trail = []
    with ElasticTrainer(per, 2, c, tc, job["agent_dir"],
                        device="cpu") as et:
        agent = ElasticAgent(et, client, "elastic-ns", "nb")

        def turn(annotations=None):
            if annotations is not None and rank == 0:
                client.patch("Notebook", "elastic-ns", "nb",
                             {"metadata": {"annotations": annotations}})
            agent.poll_once()
            trail.append({
                "ack": client.annotation(names.ELASTIC_ACK_ANNOTATION)
                if rank == 0 else None,
                "n_slices": et.n_slices, "step": et.stats.step,
                "standby": et.standby,
                "mesh_dp": None if et.standby else mesh_config(et.mesh).dp})
        et.fit(job["agent_batches"][0], steps=2, log_every=1)
        turn({names.ELASTIC_RESIZE_ANNOTATION: "Draining",
              names.ELASTIC_TARGET_ANNOTATION: "1"})
        turn()                                   # idempotent
        before = None if et.standby else _full_state(et.trainer, c)
        turn({names.ELASTIC_RESIZE_ANNOTATION: "Resharding"})
        after = None if et.standby else _full_state(et.trainer, c)
        carried = before is None or after is None or \
            _bit_equal(before, after)
        turn({names.ELASTIC_RESIZE_ANNOTATION: None,
              names.ELASTIC_ACK_ANNOTATION: None})
        et.fit(job["agent_batches"][1], steps=2, log_every=1)
        out = {"trail": trail, "step": et.stats.step, "carried": carried,
               "losses": list(et.stats.losses),
               "current": client.annotation(
                   names.ELASTIC_CURRENT_SLICES_ANNOTATION)
               if rank == 0 else None}
    return out


def _migration_cycle(job, c, tc) -> dict:
    """CheckpointMigrationDriver on a 2-rank mesh: Trainer A (fsdp 2) at
    step 4 checkpointed, then resumed into a fresh Trainer on the same
    mesh and into one on tp 2; each continues two steps beside A."""
    from kubeflow_tpu_torch.runtime.migrate import CheckpointMigrationDriver
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import names
    rank = dist.get_rank()
    fsdp, member = _mesh({"fsdp": 2})
    tp, _ = _mesh({"tp": 2})
    out = {}
    outside = None
    if not member:
        try:
            Trainer(c, tc, mesh=fsdp)
        except ValueError as exc:
            outside = str(exc)
    out["outside"] = outside
    if not member:
        return out
    client = DictClient({names.RUNTIME_STEP_ANNOTATION: "4"}) \
        if rank == 0 else NoClient()
    nb = {"kind": "Notebook", "metadata": {"name": "nb",
                                           "namespace": "elastic-ns"}}
    first, rest = job["mig_batches"][:4], job["mig_batches"][4:]
    with Trainer(c, tc, mesh=fsdp, checkpoint_dir=job["mig_seed"]) as a:
        a.fit(first, steps=4, log_every=1)
        at4 = _full_state(a, c)

        def driver(trainer, mesh):
            return CheckpointMigrationDriver(
                lambda notebook: job["mig_dir"],
                lambda notebook: (a.stats.step, a.params, a.opt_state),
                lambda notebook: (trainer.params, trainer.opt_state),
                mesh=mesh,
                param_specs=param_specs(c, ttr.mesh_rules(mesh)))
        out["token"] = driver(a, fsdp).checkpoint(client, nb)
        a.fit(rest, steps=2, log_every=1)
        out["losses_a"] = [x for _, x in a.stats.losses][-2:]
        for name, mesh in (("fsdp2", fsdp), ("tp2", tp)):
            with Trainer(c, tc, mesh=mesh, seed=1) as b:
                step, b.params, b.opt_state = driver(b, mesh).resume(
                    client, nb, out["token"])
                b.stats.step = step
                out[f"{name}_step"] = step
                out[f"{name}_restored_equal"] = _bit_equal(
                    _full_state(b, c), at4)
                b.fit(rest, steps=2, log_every=1)
                out[f"{name}_losses"] = [x for _, x in b.stats.losses]
    if rank == 0:
        out["resumed_annotation"] = client.annotation(
            names.RESUMED_STEP_ANNOTATION)
    return out


def elastic_suite(rank: int, world: int, job: dict) -> dict:
    """ElasticTrainer 3 → 2 → 3 over the world's 6 ranks (2 standby on 2
    slices), ElasticAgent driving a resize, and migration across meshes.
    Returns this rank's view."""
    c = TransformerConfig(**job["config"])
    tc = ttr.TrainConfig(**job["tc"])
    per = MeshConfig(**job["per_slice"])
    if rank == 0:
        for d in (job["dir"], job["dir"] + "-cap", job["agent_dir"],
                  job["mig_seed"]):
            _seed_checkpoint(d, job["init"], tc)
    dist.barrier()
    return {"cycle": _elastic_cycle(job, c, tc, per),
            "agent": _agent_cycle(job, c, tc, per),
            "migration": _migration_cycle(job, c, tc)}


def idle_suite(rank: int, world: int, job: dict) -> dict:
    """Both engines over tp 2 meshes of ranks 0 and 1, in a world of 3
    whose collectives time out after ``job["timeout"]`` seconds; rank 2
    only joins in making the meshes (groups are made collectively), so
    that each mesh has a tp group of its own rather than the world's.
    Each engine on a mesh of its own: a request, an idle longer than
    that timeout, another request; a second engine on a busy mesh is
    refused. Then each engine, on one more mesh, through a failure
    inside its device work on rank 1 (``_broken_cases``). This rank's
    view of each engine's requests, and of each failure (nothing on
    rank 2)."""
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator)
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    _SYNC[:] = [dist.new_group([0, 1])]
    meshes = [build_mesh(MeshConfig(tp=2), "cpu", ranks=[0, 1])
              for _ in range(4)]
    if rank == 2:
        return {}
    c = TransformerConfig(**job["config"])
    full = convert.to_torch(job["params"])
    sharded = [shard_decode_params(full, mesh, c) for mesh in meshes]
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    engines = {"bucketed": BatchedGenerator(sharded[0], c, device="cpu"),
               "continuous": ContinuousBatchedGenerator(sharded[1], c,
                                                        device="cpu")}
    seen = {name: _record_requests(gen) for name, gen in engines.items()}
    out = {}
    try:  # a second engine on a mesh that serves: its plans would mix
        ContinuousBatchedGenerator(sharded[0], c, device="cpu")
        out["second_engine"] = "built"
    except ValueError as exc:
        out["second_engine"] = str(exc)
    if rank == 0:
        for prompt in prompts:
            for name, gen in engines.items():
                out[name] = out.get(name, []) + [
                    _ids(gen.submit(prompt, job["max_new"]))]
            if prompt is not prompts[-1]:
                time.sleep(job["idle"])
    _sync()
    for gen in engines.values():
        gen.close()
    out["outcomes"] = {name: _outcomes(reqs) for name, reqs in seen.items()}
    out["broken"] = _broken_cases(
        {"bucketed": BatchedGenerator(sharded[2], c, device="cpu"),
         "continuous": ContinuousBatchedGenerator(sharded[3], c,
                                                  device="cpu",
                                                  n_slots=2)},
        prompts[0], job["max_new"])
    return out


# -------------------------------------------------------------- bootstrap
def _unflatten(flat: dict) -> dict:
    """{"a/b": x} → {"a": {"b": x}}."""
    tree: dict = {}
    for path, x in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = x
    return tree


def bootstrap_worker(job_path: str, out_path: str) -> None:
    """One worker process of a provisioned slice on the CPU: its world
    from the TPU_WORKER_* env (runtime/bootstrap.py, gloo), the slice
    verified at 2 ranks, then ``make_sharded_train_step`` at dp 2 from the
    job's params (the JAX step's own init, "params/<path>" entries of the
    .npz) over its batches. Writes the report, the losses and the
    gathered params to ``out_path`` (a pickle)."""
    from kubeflow_tpu_torch.parallel.mesh import leave_world
    from kubeflow_tpu_torch.runtime.bootstrap import (SliceEnv,
                                                      initialize_slice,
                                                      verify_slice)
    torch.set_num_threads(1)
    job = np.load(job_path)
    params = _unflatten({k.split("/", 1)[1]: job[k] for k in job.files
                         if k.startswith("params/")})
    case = {"mesh": {"dp": 2}, "accum": 1, "tc": {"warmup_steps": 2},
            "params": params,
            "batches": list(zip(job["tokens"], job["targets"]))}
    env = initialize_slice(SliceEnv.from_env(), device="cpu", timeout=60)
    try:
        report = verify_slice(env, expected=2)
        out = _step_case(case, json.loads(str(job["config"])))
    finally:
        leave_world()
    with open(out_path, "wb") as fh:
        pickle.dump({"report": report, "losses": out["losses"],
                     "params": out["params"],
                     "replicas_equal": out["replicas_equal"]}, fh)


if __name__ == "__main__":
    bootstrap_worker(*sys.argv[1:])
