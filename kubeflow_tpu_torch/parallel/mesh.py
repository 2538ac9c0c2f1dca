"""Device-mesh construction, axis conventions and the process world.

Port of ``kubeflow_tpu/parallel/mesh.py``. The axes are the reference's:

- ``dp``   pure data parallelism (gradients all-reduced)
- ``fsdp`` data parallelism with parameter/optimizer sharding (ZeRO-3:
           params all-gathered per layer, grads reduce-scattered)
- ``tp``   tensor parallelism (Megatron column/row sharded matmuls)
- ``sp``   sequence parallelism (ring or Ulysses attention)
- ``pp``   pipeline parallelism (layer stages, microbatched)
- ``ep``   expert parallelism (MoE experts spread over devices)

The JAX package is single-controller: one process drives every device
and GSPMD inserts the collectives. The port is SPMD: one process per
card (a rank of a ``torch.distributed`` world), each holding its local
shards, with the collectives placed by hand (parallel/comm.py). A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the six named
axes in the reference's order, size-1 axes included, so a spec names
the same axes on every layout.

``world`` starts and ends this process's membership of the world: NCCL
for CUDA, gloo only when the caller asks for the CPU (``join_world`` and
``leave_world``, which runtime/bootstrap.py shares). ``spawn`` starts
a world of n local processes and collects what each returns.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from . import comm

AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. An axis set to 1 is still present in the mesh,
    so specs are the same on every layout."""
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @staticmethod
    def auto(n_devices: int, *, tp: int = 1, sp: int = 1, pp: int = 1,
             ep: int = 1, fsdp: int | None = None) -> "MeshConfig":
        """Fill the data axes with the devices left after the model axes
        are chosen; fsdp defaults to all of them (dp = 1)."""
        model = tp * sp * pp * ep
        if n_devices % model:
            raise ValueError(f"model axes tp*sp*pp*ep={model} do not divide "
                             f"device count {n_devices}")
        remaining = n_devices // model
        if fsdp is None:
            fsdp = remaining
        if remaining % fsdp:
            raise ValueError(f"fsdp={fsdp} does not divide remaining "
                             f"{remaining} devices")
        return MeshConfig(dp=remaining // fsdp, fsdp=fsdp, pp=pp, sp=sp,
                          tp=tp, ep=ep)


def mesh_config(mesh: DeviceMesh | None) -> MeshConfig:
    """The axis sizes of ``mesh`` (all 1 for no mesh)."""
    if mesh is None:
        return MeshConfig()
    return MeshConfig(**dict(zip(mesh.mesh_dim_names, mesh.shape)))


# ----------------------------------------------------------------- world
# the collective timeout of the world this process is in (``join_world``)
_world_timeout: datetime.timedelta | None = None


def join_world(dev: torch.device, *, rank: int, world_size: int,
               timeout: float, store=None,
               init_method: str | None = None) -> None:
    """Make this process rank ``rank`` of a ``world_size`` world on
    ``dev``: NCCL for a card (made this process's current device), gloo
    for the CPU. The rendezvous is ``store`` (a ``dist.Store``) or
    ``init_method``. ``timeout`` bounds the rendezvous and every
    collective, and the meshes built in the world give their groups the
    same timeout."""
    global _world_timeout
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo", rank=rank,
              world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    _world_timeout = kw["timeout"]


def leave_world() -> None:
    """End this process's world (``join_world``'s)."""
    global _world_timeout
    _world_timeout = None
    dist.destroy_process_group()


@contextlib.contextmanager
def world(device="cuda", *, rank: int, world_size: int,
          store_path: str | None = None, init_method: str | None = None,
          timeout: float = 300.0):
    """This process as rank ``rank`` of a ``world_size`` world, for the
    body of the ``with``; yields the rank's device and ends the world on
    exit.

    ``device="cuda"`` takes NCCL on card ``rank % device_count`` and
    raises where CUDA is absent (it never falls back to gloo or the CPU);
    ``device="cpu"`` takes gloo. The rendezvous is a ``FileStore`` at
    ``store_path`` (a file no earlier world used) or ``init_method``
    (``env://``, ``tcp://host:port``, ``file://...``). ``timeout`` bounds
    the rendezvous and every collective (``join_world``)."""
    dev = resolve_device(device)
    if (store_path is None) == (init_method is None):
        raise ValueError("pass exactly one of store_path and init_method")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    store = None if store_path is None else dist.FileStore(store_path,
                                                           world_size)
    join_world(dev, rank=rank, world_size=world_size, timeout=timeout,
               store=store, init_method=init_method)
    try:
        yield dev
    finally:
        leave_world()


# ------------------------------------------------------------------ mesh
def _ranks(ranks, size: int) -> list[int]:
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    ranks = list(ranks)
    if len(ranks) != size:
        raise ValueError(f"mesh of size {size} != {len(ranks)} ranks")
    return ranks


def _device_mesh(device, arr: torch.Tensor) -> DeviceMesh:
    mesh = DeviceMesh(torch.device(device).type, arr, mesh_dim_names=AXES)
    if mesh.device_type == "cuda" and arr.shape[AXES.index("pp")] > 1:
        # NCCL needs every rank of a group in its first batch_isend_irecv
        # when that is the group's first collective, and a pipeline's
        # first tick joins two stages: one all-reduce over pp comes first
        dist.all_reduce(torch.zeros(1, device="cuda"),
                        group=mesh.get_group("pp"))
    if _world_timeout is not None and mesh.get_coordinate() is not None:
        # an axis over fewer ranks than the world gets a group of its
        # own, made with torch's default timeout (30 min under gloo, 10
        # under NCCL) rather than the world's
        for a in AXES:
            group = mesh.get_group(a)
            if group is not dist.group.WORLD and group.size() > 1:
                group.set_timeout(_world_timeout)
    comm.make_plan_group(mesh)
    return mesh


def build_mesh(config: MeshConfig, device="cuda", ranks=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``config``'s shape over ``ranks`` (default: the
    whole world, in rank order), axes in the reference's order: the data
    axes outermost, ``tp`` innermost, so the per-layer tp collectives
    join neighbouring ranks. Every rank of the world calls it, also a
    rank outside ``ranks`` (process groups are made collectively)."""
    ranks = _ranks(ranks, config.size)
    shape = tuple(getattr(config, a) for a in AXES)
    return _device_mesh(device, torch.tensor(ranks).reshape(shape))


def group_by_slice(devices) -> list[list]:
    """Group devices by their slice (``slice_index``); devices without
    one, such as plain ranks, land in one group. Groups by slice index,
    the caller's order kept inside a group."""
    groups: dict[int, list] = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
    return [groups[k] for k in sorted(groups)]


def build_hybrid_mesh(n_slices: int, per_slice: MeshConfig, device="cuda",
                      ranks=None) -> tuple[DeviceMesh, MeshConfig]:
    """Multi-slice mesh: ``dp`` spans the slices, every other axis stays
    inside one. Ranks without a slice index are chunked into
    ``n_slices`` contiguous slices. Returns (mesh, full config): the full
    config is ``per_slice`` with ``dp`` multiplied by ``n_slices``."""
    ranks = _ranks(ranks, n_slices * per_slice.size)
    groups = group_by_slice(ranks)
    if len(groups) == 1 and n_slices > 1:
        flat = groups[0]
        groups = [flat[i * per_slice.size:(i + 1) * per_slice.size]
                  for i in range(n_slices)]
    if len(groups) != n_slices:
        raise ValueError(f"ranks span {len(groups)} slices, expected "
                         f"{n_slices}")
    per_shape = tuple(getattr(per_slice, a) for a in AXES)
    arr = torch.cat([torch.tensor(g).reshape(per_shape) for g in groups],
                    dim=0)
    full = MeshConfig(dp=n_slices * per_slice.dp, fsdp=per_slice.fsdp,
                      pp=per_slice.pp, sp=per_slice.sp, tp=per_slice.tp,
                      ep=per_slice.ep)
    return _device_mesh(device, arr), full


# ---------------------------------------------------------------- spawn
def _rank_entry(fn, rank, world_size, device, store_path, timeout,
                args_path, results):
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as fh:
            args = pickle.load(fh)
        with world(device, rank=rank, world_size=world_size,
                   store_path=store_path, timeout=timeout):
            out = fn(rank, world_size, *args)
        # pickled here, by value: a tensor put on the queue as it is
        # would be shared through a file descriptor of this process,
        # which is gone by the time the parent reads it
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *args, device="cuda", timeout: float = 300.0,
          collective_timeout: float | None = None,
          store_dir: str | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the spawn start method), each a rank of one world (``world``, a
    ``FileStore`` rendezvous in a fresh directory under ``store_dir``,
    default the system's temporary directory), and return
    what each returned, by rank. ``fn`` and its results must pickle.

    Fails when a rank raises (its traceback in the error) or when the
    ranks are not all done within ``timeout`` seconds (then every rank
    still running is killed): a deadlocked collective fails the caller
    instead of hanging it. ``collective_timeout`` (default ``timeout``)
    bounds each collective inside the ranks. With ``device="cuda"`` each
    rank takes its own card, and CUDA must be present."""
    if resolve_device(device).type == "cuda" and \
            world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} cards; "
                         f"{torch.cuda.device_count()} present")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="kft-world-", dir=store_dir)
    store_path = os.path.join(tmp, "store")
    # the arguments go through a file: a process's start blocks until it
    # has read what is sent down its pipe, after its imports, so large
    # arguments there would start the ranks one after the other
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as fh:
        pickle.dump(args, fh)
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        fn, r, world_size, device, store_path,
        collective_timeout or timeout, args_path, results))
        for r in range(world_size)]
    deadline = time.monotonic() + timeout
    got: dict[int, tuple] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(got))} of "
                    f"{world_size} not done after {timeout} s")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank reports before it exits: one that is gone with
                # no report was killed
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} of {world_size} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            got[rank] = (status, pickle.loads(out))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [got[r][1] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
