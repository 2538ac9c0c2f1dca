"""Rank entry points of the multi-rank parity tests
(tests/test_torch_parallel.py, test_torch_sharded_train.py,
test_torch_sharded_decode.py, test_torch_pipeline.py,
test_torch_sharded_moe.py, test_torch_sharded_lora.py).

Each function runs in every process of a gloo world on the CPU started by
``kubeflow_tpu_torch.parallel.mesh.spawn``, and returns rank 0's results
(numpy) to the parent, which holds them against the JAX package. This
module imports torch, numpy and the port, never JAX: the parent computes
the JAX side and passes its inputs in as numpy arrays.

A case runs on a mesh over the first ranks of the world (``_mesh``):
every rank builds every mesh (process groups are made collectively), and
the ranks outside it skip the case.
"""

from __future__ import annotations

import math

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
    return out
