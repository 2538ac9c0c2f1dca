"""Pipeline parallelism: GPipe microbatched layer stages over ``pp``.

Port of ``kubeflow_tpu/parallel/pipeline.py``. The stages lie on the
``pp`` mesh axis, contiguous blocks of layers; the schedule is GPipe's
fill and drain, T = n_micro + n_stages - 1 ticks, at each of which every
stage runs its layer block on its microbatch and passes the result on.

The reference runs the schedule as one traced ``fori_loop`` inside a
shard_map: every stage computes at every tick (the bubble ticks on
values the output masks away) and the activations rotate around the pp
ring with ``ppermute``. The port is SPMD: each rank runs its own stage
and only the ticks that carry a microbatch for it; the activations move
forward only, point to point between neighbours (``comm.stage_shift``:
the first stage receives nothing and the last sends nothing), and the
last stage's result is broadcast to every stage
(``comm.broadcast_from_last``). Autograd differentiates the loop: each
tick's exchange is an autograd Function whose backward sends the grads
the other way, so the backward runs the schedule in reverse. Three
things keep every rank in every backward exchange:

- each exchange returns a token, tied into the result at a zero grad,
  so a rank that only sends still runs that node's backward (it
  receives the grad of what it sent there);
- each exchange hangs from an anchor on the path to the stage's params
  and input, so ``autograd.grad`` does not prune a node that only
  receives;
- the input enters through ``comm.copy_to`` over pp: only stage 0 uses
  it, and its grad, summed over pp, is whole on every stage (so the
  embedding's grad is, as the LM head's is). The other stages tie it in.

On one rank (pp = 1) it is ``stage_fn`` on the stage's params, as in the
reference; the microbatch count is then not used.
"""

from __future__ import annotations

import torch

from . import comm


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_stages(stacked_params, n_stages: int):
    """Reshape a layer-stacked param tree (L, ...) → (n_stages, L/S, ...).
    The leading stage axis is what ``pp`` shards: on a pp mesh a rank's
    shard of the layer axis is its stage, ``split_stages(local, 1)``."""
    def reshape(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])
    return _tree_map(reshape, stacked_params)


def _leaves(x) -> tuple[list, object]:
    """(the tensors of ``x``, a tensor or a flat dict, in key order; the
    rebuild of a list of them)."""
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], lambda ls: dict(zip(keys, ls))
    return [x], lambda ls: ls[0]


def pipeline_apply(stage_params, x, stage_fn, *, mesh, n_microbatches: int,
                   extra_args: tuple = ()):
    """Run ``stage_fn(stage_params_i, activation, *extra_args) ->
    activation`` through the pp stages. ``stage_params`` is this rank's
    stage, leaves (1, L/S, ...); ``x`` (batch, ...) activations entering
    stage 0, a tensor or a flat dict of them (the MoE carries {x, aux}),
    the same on every pp rank; returns the last stage's output, on every
    pp rank. Each leaf's shape and dtype must be the same at every
    stage's input and output (true for transformer blocks).

    Microbatch m is rows [m·mb, (m+1)·mb) of ``x``: on a data-sharded
    mesh, each data rank's share of every global microbatch when the
    batch was laid out by ``runtime.data.shard_batch`` for
    ``n_microbatches``."""
    n_stages = comm.axis_size(mesh, "pp")
    params = _tree_map(lambda p: p[0], stage_params)
    if n_stages == 1:
        return stage_fn(params, x, *extra_args)
    leaves, rebuild = _leaves(x)
    batch = leaves[0].shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} "
                         f"microbatches")
    stage = comm.axis_rank(mesh, "pp")
    last = n_stages - 1
    leaves = [comm.copy_to(t, mesh, "pp") for t in leaves]
    micro = list(zip(*(t.chunk(n_microbatches, dim=0) for t in leaves)))
    specs = [(m.shape, m.dtype) for m in micro[0]]
    param_leaves = []
    _tree_map(param_leaves.append, params)
    anchor = comm.anchor_of(leaves + param_leaves, leaves[0].device)

    state, outs, tokens = None, [], []
    for t in range(n_microbatches + last):
        m = t - stage                     # the microbatch this tick
        out = ()
        if 0 <= m < n_microbatches:
            inp = micro[m] if stage == 0 else state
            out, _ = _leaves(stage_fn(params, rebuild(list(inp)),
                                      *extra_args))
            if stage == last:
                outs.append(out)
        send = out if stage < last else ()
        # the previous stage computed microbatch t - (stage - 1) this tick
        receive = stage > 0 and 0 <= m + 1 < n_microbatches
        if send or receive:
            state, token = comm.stage_shift(
                send, specs if receive else (), anchor, mesh, "pp")
            tokens.append(token)

    if stage == last:
        y = [torch.cat(parts, dim=0) for parts in zip(*outs)]
    else:
        y = [torch.empty((batch,) + tuple(s[1:]), dtype=dt,
                         device=leaves[0].device) for s, dt in specs]
    y = [comm.broadcast_from_last(t, mesh, "pp") for t in y]
    y[0] = comm.tie(y[0], *tokens, *(leaves if stage > 0 else ()))
    return rebuild(y)
