"""Collectives over named mesh axes, the ones autograd differentiates
included.

The JAX package has no such module: GSPMD inserts its collectives, and
shard_map bodies call ``lax`` collectives by axis name. Here each
collective takes a mesh and the name of one of its axes (or a tuple of
names: a collective over several axes is one over each in turn), and a
size-1 axis costs nothing: no call is made, as XLA makes none.

Every collective that takes part in autograd is an
``autograd.Function`` whose backward is the transposed collective:

- ``all_gather`` (a dim sharded over a data axis, as fsdp shards
  weights) ↔ reduce-scatter: each rank's grad of the gathered tensor is
  partial (its own data), so the grads are summed and each rank keeps
  its slice;
- ``gather_replicated`` (a tp-sharded dim gathered for computation that
  is replicated over tp) ↔ the rank's own slice of the grad;
- ``reduce_from`` (partial sums, after a row-parallel matmul) ↔
  identity; ``copy_to`` (identity, before a column-parallel matmul) ↔
  an all-reduce of the grads: Megatron's g and f;
- ``all_to_all`` ↔ the inverse all-to-all;
- ``ring_shift`` (send to the next rank, receive from the previous) ↔
  send to the previous, receive from the next;
- ``stage_shift`` (a pipeline tick: send to the next stage, receive from
  the previous, the two ends posting nothing) ↔ the grads the other way;
- ``broadcast_from_last`` (the last stage's result to every stage) ↔ the
  grad to the last stage once, as it is (every stage computes the same
  loss from the broadcast result, so the sum over stages would count it
  once per stage).

A rank that does not use what a differentiated collective gave it would
never run that node's backward, and its peers would wait for ever in
theirs. ``tie`` joins such a tensor to one the rank does use, with a
zero grad, so that every rank runs every backward collective.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# newer torch builds name these two collectives *_single and deprecate the
# older names, which are all that older builds have
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# ------------------------------------------------------------------ axes
def _names(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (1 without a mesh)."""
    n = 1
    if mesh is not None:
        for a in _names(axes):
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_rank(mesh, axes) -> int:
    """This rank's index along ``axes``, row-major over several (0
    without a mesh)."""
    i = 0
    for a in _names(axes):
        i = i * axis_size(mesh, a) + (mesh.get_local_rank(a)
                                      if mesh is not None else 0)
    return i


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _live(mesh, axes) -> list[str]:
    """The axes of ``axes`` whose size is above 1."""
    return [a for a in _names(axes) if axis_size(mesh, a) > 1]


# ------------------------------------------------- plain (no autograd)
def all_reduce_(x: torch.Tensor, mesh, axes, op: str = "sum"):
    """In-place all-reduce of ``x`` over ``axes`` (``op`` sum or max);
    returns ``x``. Not differentiated."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in _live(mesh, axes):
        dist.all_reduce(x, op=red, group=mesh.get_group(a))
    return x


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _all_gather_single(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _reduce_scatter_single(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r]


def gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes`` (row-major: the last
    axis innermost), not differentiated."""
    x = x.detach()
    for a in reversed(_live(mesh, axes)):
        x = _gather_dim(x, mesh.get_group(a), dim)
    return x


# -------------------------------------------------------- differentiated
class AllGather(torch.autograd.Function):
    """all-gather along ``dim`` ↔ reduce-scatter along ``dim``."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class GatherReplicated(torch.autograd.Function):
    """all-gather along ``dim`` ↔ the rank's own slice of the grad."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class ReduceFrom(torch.autograd.Function):
    """all-reduce (sum) ↔ identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyTo(torch.autograd.Function):
    """identity ↔ all-reduce (sum) of the grad."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_to_all(x: torch.Tensor, group, split: int,
                concat: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split), dim=0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class AllToAll(torch.autograd.Function):
    """``lax.all_to_all(tiled=True)``: ``split`` cut into n pieces, piece
    i to rank i, the pieces received concatenated along ``concat`` in
    rank order ↔ the same with ``split`` and ``concat`` swapped."""

    @staticmethod
    def forward(ctx, x, group, split: int, concat: int):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat, ctx.split), None,
                None, None)


def _shift(tensors, group, step: int) -> list[torch.Tensor]:
    """Send each tensor to the rank ``step`` places on along the group's
    ring, receive the same from the rank ``step`` places back."""
    ranks = dist.get_process_group_ranks(group)
    n, r = len(ranks), dist.get_rank(group)
    to, frm = ranks[(r + step) % n], ranks[(r - step) % n]
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _p2p(send, recv_specs, group, step: int, device) -> list[torch.Tensor]:
    """Send the tensors ``send`` to the rank ``step`` places on along the
    group (none when empty) and receive tensors of ``recv_specs``
    ((shape, dtype) pairs) from the rank ``step`` places back (none when
    empty), in one ``batch_isend_irecv``. No wrap-around: a rank with no
    such neighbour must pass nothing for it. The waits take the process
    group's timeout, so a peer that never posts fails the call."""
    ranks = dist.get_process_group_ranks(group)
    r = dist.get_rank(group)
    out = [torch.empty(shape, dtype=dt, device=device)
           for shape, dt in recv_specs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[r + step], group)
           for t in send]
    ops += [dist.P2POp(dist.irecv, o, ranks[r - step], group) for o in out]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class StageShift(torch.autograd.Function):
    """One pipeline tick over a group: the tensors ``send`` to the next
    rank, tensors of ``recv_specs`` from the previous ↔ the grads of what
    was received to the previous rank, the grads of what was sent from
    the next. Returns the received tensors and a token, a 0-d zero: a
    rank that only sends has nothing else to tie into its result.
    ``anchor`` is a tensor on the rank's path to every input it
    differentiates, so that ``autograd.grad`` runs the backward of a node
    that only receives (its outputs alone would not reach an input)."""

    @staticmethod
    def forward(ctx, group, recv_specs, anchor, *send):
        ctx.group, ctx.device = group, anchor.device
        ctx.send_specs = [(t.shape, t.dtype) for t in send]
        got = _p2p(send, recv_specs, group, +1, anchor.device)
        return (*got, anchor.new_zeros(()))

    @staticmethod
    def backward(ctx, *grads):
        back = _p2p(grads[:-1], ctx.send_specs, ctx.group, -1, ctx.device)
        return (None, None, None, *back)


class _Anchor(torch.autograd.Function):
    """A 0-d zero with an edge to each of ``tensors`` and no grad for
    any: a node hung from it lies on the path to every one of them."""

    @staticmethod
    def forward(ctx, like, *tensors):
        ctx.n = len(tensors)
        return like.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        return (None,) * (ctx.n + 1)


class BroadcastFromLast(torch.autograd.Function):
    """The last rank's ``x`` on every rank of the group (the others pass
    a tensor of its shape and dtype) ↔ the grad, unchanged, to the last
    rank's ``x`` and nothing to the others'."""

    @staticmethod
    def forward(ctx, x, group):
        ranks = dist.get_process_group_ranks(group)
        ctx.last = dist.get_rank(group) == len(ranks) - 1
        y = x.clone().contiguous()
        dist.broadcast(y, src=ranks[-1], group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), None


class Tie(torch.autograd.Function):
    """``x`` unchanged, with ``tied`` as extra inputs whose grad is zero:
    their producers' backward still runs."""

    @staticmethod
    def forward(ctx, x, *tied):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tied]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.like))


class RingShift(torch.autograd.Function):
    """Each tensor to the next rank of the ring, from the previous one ↔
    the grads to the previous rank, from the next one. One call moves
    all its tensors, so the sends and receives of a ring step pair up in
    the same order on every rank."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, +1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.group, -1))


# ------------------------------------------------------------- wrappers
def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Gather ``dim`` over ``axes`` (a data axis: the backward sums each
    rank's partial grad and scatters it)."""
    for a in reversed(_live(mesh, axes)):
        x = AllGather.apply(x, mesh.get_group(a), dim)
    return x


def gather_replicated(x: torch.Tensor, mesh, axes,
                      dim: int) -> torch.Tensor:
    """Gather ``dim`` over ``axes`` for computation replicated over them
    (the backward keeps the rank's own slice)."""
    for a in reversed(_live(mesh, axes)):
        x = GatherReplicated.apply(x, mesh.get_group(a), dim)
    return x


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum partial results over ``axes``; the grad passes unchanged."""
    for a in _live(mesh, axes):
        x = ReduceFrom.apply(x, mesh.get_group(a))
    return x


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; the grad is summed over ``axes``."""
    for a in _live(mesh, axes):
        x = CopyTo.apply(x, mesh.get_group(a))
    return x


def all_to_all(x: torch.Tensor, mesh, axis: str, split: int,
               concat: int) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return AllToAll.apply(x, mesh.get_group(axis), split, concat)


def ring_shift(tensors, mesh, axis: str) -> tuple[torch.Tensor, ...]:
    if axis_size(mesh, axis) == 1:
        return tuple(tensors)
    return RingShift.apply(mesh.get_group(axis), *tensors)


def stage_shift(send, recv_specs, anchor, mesh,
                axis: str) -> tuple[list[torch.Tensor], torch.Tensor]:
    """A pipeline tick over ``axis``: ``send`` (tensors, or nothing) to
    the next rank of the axis, tensors of ``recv_specs`` (or nothing)
    from the previous; the first rank receives nothing and the last
    sends nothing. Returns (the received tensors, the node's token). With
    grads enabled ``anchor`` must come from ``anchor_of``."""
    out = StageShift.apply(mesh.get_group(axis), tuple(recv_specs), anchor,
                           *send)
    return list(out[:-1]), out[-1]


def anchor_of(tensors, device) -> torch.Tensor:
    """The anchor of ``stage_shift``: a 0-d zero on the path to every
    tensor of ``tensors`` that requires grad (a plain zero when none
    does, or grads are off)."""
    live = [t for t in tensors if t.requires_grad]
    like = torch.zeros((), device=device)
    if not (live and torch.is_grad_enabled()):
        return like
    return _Anchor.apply(like, *live)


def broadcast_from_last(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The last rank of ``axis``'s ``x`` on every rank of it; the grad
    reaches the last rank's ``x`` once."""
    if axis_size(mesh, axis) == 1:
        return x
    return BroadcastFromLast.apply(x, mesh.get_group(axis))


def tie(x: torch.Tensor, *tied) -> torch.Tensor:
    """``x``, with the tensors ``tied`` joined to it at a zero grad (their
    backward collectives run on this rank too)."""
    tied = [t for t in tied if t.requires_grad]
    return Tie.apply(x, *tied) if tied and torch.is_grad_enabled() else x


def barrier(mesh) -> None:
    """Every rank of ``mesh`` has reached this call when it returns (an
    all-reduce over each axis in turn)."""
    if mesh is not None:
        all_reduce_(torch.zeros(1, device=mesh_device(mesh)), mesh,
                    mesh.mesh_dim_names)


# ------------------------------------------------------------ host plans
# How long a rank may wait on a mesh's plan group. A follower waits there
# while its driver has nothing to send, which may be for ever; a peer that
# dies ends the wait at once, as its sockets close.
PLAN_TIMEOUT = datetime.timedelta(days=365)


def is_mesh_root(mesh) -> bool:
    """Whether this process is ``mesh``'s first rank, the one at every
    coordinate 0 (True off a mesh)."""
    return mesh is None or _root(mesh) == dist.get_rank()


def _root(mesh) -> int:
    return int(mesh.mesh.flatten()[0])


def make_plan_group(mesh) -> None:
    """Give ``mesh`` its plan group: one gloo group over all its ranks,
    on the host, whose waits ``PLAN_TIMEOUT`` bounds instead of the
    world's collective timeout (None on a mesh of one rank). Every rank
    of the world calls it as it builds the mesh, since groups are made
    collectively."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten())
    mesh.plan_group = None if len(ranks) == 1 else dist.new_group(
        ranks, timeout=PLAN_TIMEOUT, backend="gloo")


def _plan_group(mesh):
    """``mesh``'s plan group, or None off a mesh or on one of size 1."""
    if mesh is None or mesh.mesh.numel() == 1:
        return None
    group = getattr(mesh, "plan_group", None)
    if group is None:
        raise ValueError("this mesh has no plan group: build it with "
                         "parallel.mesh.build_mesh or build_hybrid_mesh")
    return group


def broadcast_plan(obj, mesh):
    """The mesh's first rank's picklable ``obj`` on every rank of
    ``mesh`` (the others pass anything, None by custom); ``obj`` as it is
    off a mesh or on one of size 1. One broadcast on the mesh's plan
    group, on the host: a rank may wait in it as long as the first rank
    has nothing to send."""
    group = _plan_group(mesh)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_root(mesh), group=group)
    return box[0]


def any_failed(flag: int, mesh) -> int:
    """The largest ``flag`` over the ranks of ``mesh`` (0: none failed),
    ``flag`` itself off a mesh or on one of size 1: a max all-reduce of
    one int on the mesh's plan group. Every rank calls it, so a failure
    on one rank becomes a failure of the whole mesh. The plan group's own
    sequence of calls pairs them, whatever the mesh's other groups were
    left waiting in."""
    group = _plan_group(mesh)
    if group is None:
        return int(flag)
    x = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return int(x.item())
