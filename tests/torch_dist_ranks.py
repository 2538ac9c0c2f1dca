"""Rank entry points of the multi-rank parity tests
(tests/test_torch_parallel.py, test_torch_sharded_train.py,
test_torch_sharded_decode.py).

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
from kubeflow_tpu_torch.models.transformer import TransformerConfig, param_specs
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


def _full_params(params, mesh, config):
    return _np_tree(gather_tree(params, param_specs(config), mesh))


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


# ------------------------------------------------------------------ train
def _step_case(case: dict, config: dict) -> dict:
    c = TransformerConfig(**config, attention=case["attention"])
    mesh, member = _mesh(case["mesh"])
    if not member:
        return {}
    tc = ttr.TrainConfig(**case["tc"])
    _, step_fn = ttr.make_sharded_train_step(mesh, c, tc,
                                             accum_steps=case["accum"])
    params, opt = ttr.init_train_state(
        convert.to_torch_sharded(case["params"], mesh, c), tc)
    losses = []
    for tokens, targets in case["batches"]:
        params, opt, loss = step_fn(params, opt,
                                    _t(shard_batch(tokens, mesh)),
                                    _t(shard_batch(targets, mesh)))
        losses.append(loss.item())
    out = {"losses": losses, "params": _full_params(params, mesh, c)}
    # one step more from the same start with a clip that does not bind:
    # the first moment is then (1 - b1) x the step's gradient, reduced
    # over the mesh, scale included
    tc = ttr.TrainConfig(**case["tc"], grad_clip=1e9)
    _, step_fn = ttr.make_sharded_train_step(mesh, c, tc,
                                             accum_steps=case["accum"])
    params, opt = ttr.init_train_state(
        convert.to_torch_sharded(case["params"], mesh, c), tc)
    tokens, targets = case["batches"][0]
    step_fn(params, opt, _t(shard_batch(tokens, mesh)),
            _t(shard_batch(targets, mesh)))
    out["grads"] = _np_tree(ttr.tree_map(
        lambda m: m / (1 - tc.b1), gather_tree(opt.mu, param_specs(c),
                                               mesh)))
    return out


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
    c = TransformerConfig(**config)
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


def _restore_case(case: dict, config: dict) -> dict:
    """A checkpoint of mesh ``from`` restored onto each mesh of ``to``:
    every leaf of params and optimizer state bit-equal, the step kept,
    and one more train step on the new mesh."""
    from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
    c = TransformerConfig(**config)
    tc = ttr.TrainConfig(warmup_steps=1)
    mesh, member = _mesh(case["from"])
    want = None
    if member:
        init_fn, step_fn = ttr.make_sharded_train_step(mesh, c, tc)
        params, opt = init_fn(torch.Generator().manual_seed(0))
        tokens = np.random.default_rng(1).integers(0, c.vocab_size, (8, 16))
        targets = np.roll(tokens, -1, axis=1)
        params, opt, _ = step_fn(params, opt, _t(shard_batch(tokens, mesh)),
                                 _t(shard_batch(targets, mesh)))
        with TrainCheckpointer(case["dir"], mesh=mesh,
                               param_specs=param_specs(c)) as ckpt:
            assert ckpt.save(3, params, opt)
        want = [gather_tree(t, s, mesh) for t, s in (
            (params, param_specs(c)),
            (opt, ttr.opt_state_shardings(opt, param_specs(c))))]
    out = {}
    for label, sizes in case["to"].items():
        new, member = _mesh(sizes)
        if not member:
            continue
        init_fn, step_fn = ttr.make_sharded_train_step(new, c, tc)
        like_p, like_o = init_fn(torch.Generator().manual_seed(7))
        with TrainCheckpointer(case["dir"], mesh=new,
                               param_specs=param_specs(c)) as ckpt:
            step, params, opt = ckpt.restore(like_p, like_o)
        got = [gather_tree(t, s, new) for t, s in (
            (params, param_specs(c)),
            (opt, ttr.opt_state_shardings(opt, param_specs(c))))]
        equal = all(torch.equal(x, y) for g, w in zip(got, want)
                    for x, y in zip(_leaves(g), _leaves(w)))
        cfg = mesh_config(new)
        batch = 2 * cfg.dp * cfg.fsdp
        tokens = np.random.default_rng(2).integers(0, c.vocab_size,
                                                   (batch, 16))
        targets = np.roll(tokens, -1, axis=1)
        _, _, loss = step_fn(params, opt, _t(shard_batch(tokens, new)),
                             _t(shard_batch(targets, new)))
        out[label] = {"step": step, "equal": equal,
                      "wq_local": tuple(params["blocks"]["wq"].shape),
                      "loss": loss.item()}
    return out


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
              "eval": _eval_case}[kind]
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
