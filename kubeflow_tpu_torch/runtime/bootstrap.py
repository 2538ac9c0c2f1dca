"""In-container slice bootstrap: the TPU_WORKER_* env → a
``torch.distributed`` world over the slice's cards.

The port's counterpart of ``kubeflow_tpu/runtime/bootstrap.py``. The
controller injects ``TPU_WORKER_ID`` (the StatefulSet pod ordinal),
``TPU_WORKER_HOSTNAMES`` (headless-Service DNS names),
``TPU_ACCELERATOR_TYPE`` and ``TPU_TOPOLOGY`` into every worker pod
(controllers/notebook.py ``apply_gpu_spec`` writes the same names for an
H100 slice); this module reads them inside the container, forms the
world and verifies the slice. The mesh is built afterwards
(parallel/mesh.py ``build_mesh``) and gets the world's timeout.

One process per card: a worker of ``cards_per_worker`` cards (from the
node table, gpu/topology.py) runs that many processes, told apart by
``LOCAL_RANK``; rank = worker id × cards per worker + local rank. The
rendezvous is a TCP store at worker 0 (``tcp://<hostnames[0]>:<port>``).

Divergence by design: the reference forms no ``jax.distributed`` world
on a single host, since JAX is single-controller and one process drives
every chip of the host. The port is SPMD, so ``initialize_slice`` forms a
world on a single host too: one card gives a world of one, a host with 8
cards a world of 8.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device
from ..gpu.topology import GpuRequestError, SliceSpec, parse_short_name
from ..parallel.mesh import join_world

log = logging.getLogger("kubeflow_tpu_torch.runtime")

DEFAULT_COORDINATOR_PORT = 8476


@dataclass(frozen=True)
class SliceEnv:
    worker_id: int
    hostnames: tuple[str, ...]
    accelerator: str = ""   # e.g. "h100-16"
    topology: str = ""      # e.g. "2x8"
    coordinator_port: int = DEFAULT_COORDINATOR_PORT

    @property
    def num_workers(self) -> int:
        return max(len(self.hostnames), 1)

    @property
    def multi_host(self) -> bool:
        return self.num_workers > 1

    @property
    def coordinator_address(self) -> str:
        host = self.hostnames[0] if self.hostnames else "localhost"
        return f"{host}:{self.coordinator_port}"

    @classmethod
    def from_env(cls, environ=None) -> "SliceEnv":
        env = environ if environ is not None else os.environ
        raw_hosts = env.get("TPU_WORKER_HOSTNAMES", "localhost")
        hostnames = tuple(h.strip() for h in raw_hosts.split(",") if h.strip())
        try:
            port = int(env.get("KFTPU_COORDINATOR_PORT", "") or
                       DEFAULT_COORDINATOR_PORT)
        except ValueError:
            log.warning("ignoring non-numeric KFTPU_COORDINATOR_PORT")
            port = DEFAULT_COORDINATOR_PORT
        return cls(
            worker_id=int(env.get("TPU_WORKER_ID", "0") or 0),
            hostnames=hostnames,
            accelerator=env.get("TPU_ACCELERATOR_TYPE", ""),
            topology=env.get("TPU_TOPOLOGY", ""),
            coordinator_port=port,
        )


def _table_spec(env: SliceEnv) -> SliceSpec | None:
    """The node table's shape of the env's accelerator, or None when
    there is none or it does not parse."""
    if not env.accelerator:
        return None
    try:
        return parse_short_name(env.accelerator)
    except GpuRequestError:
        return None


def initialize_slice(env: SliceEnv | None = None, *, device="cuda",
                     local_rank: int | None = None,
                     cards_per_worker: int | None = None,
                     timeout: float = 300.0) -> SliceEnv:
    """Make this process its rank of the slice's world: NCCL on card
    ``cuda:<local_rank>``, or gloo when the caller passes
    ``device="cpu"`` (it never falls back to gloo: without CUDA
    ``device="cuda"`` raises). Cards per worker come from the node table
    when the accelerator parses, else ``cards_per_worker``, else 1;
    ``local_rank`` defaults to ``LOCAL_RANK``, else 0. Every worker
    process calls it; the rendezvous and every collective of the world
    fail after ``timeout`` seconds. Idempotent: a world of the slice's
    size already formed is kept, one of another size raises."""
    env = env or SliceEnv.from_env()
    dev = resolve_device(device)
    spec = _table_spec(env)
    per = spec.cards_per_worker if spec else (cards_per_worker or 1)
    world_size = env.num_workers * per
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a world of {dist.get_world_size()} ranks is already "
                f"formed; the slice needs {world_size}")
        return env
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0") or 0)
    if not 0 <= local_rank < per or not 0 <= env.worker_id < env.num_workers:
        raise ValueError(
            f"local rank {local_rank} of worker {env.worker_id}: the slice "
            f"has {env.num_workers} worker(s) of {per} card(s)")
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
    rank = env.worker_id * per + local_rank
    join_world(dev, rank=rank, world_size=world_size, timeout=timeout,
               init_method=f"tcp://{env.coordinator_address}")
    log.info("torch.distributed initialized: rank %d/%d on %s via %s",
             rank, world_size, dev, env.coordinator_address)
    return env


def expected_device_count(env: SliceEnv,
                          cards_per_worker: int | None = None) -> int:
    """Total cards the formed slice must expose. Derived from the
    accelerator shorthand when present (authoritative), else workers ×
    cards/worker."""
    spec = _table_spec(env)
    return spec.cards if spec else env.num_workers * (cards_per_worker or 1)


def verify_slice(env: SliceEnv | None = None, *, timeout_s: float = 60.0,
                 expected: int | None = None) -> dict:
    """The slice-readiness check: the world's size must match the
    expected card count, else ``TimeoutError``, as the reference raises
    (a readiness probe turns it into pod-not-ready). ``device_count`` is
    the world's size, not ``torch.cuda.device_count()``: every process of
    an 8-card pod sees the node's 8 cards. One all-reduce over the world
    then proves its collectives run (under NCCL the communicator comes up
    here).

    ``timeout_s`` is kept for the reference's signature: the world's size
    is fixed once it is formed, so this is one check, not a poll; the
    waiting happens in ``initialize_slice``, which blocks until every
    rank joins."""
    env = env or SliceEnv.from_env()
    if not dist.is_initialized():
        raise RuntimeError("no world is formed: call initialize_slice first")
    want = expected if expected is not None else expected_device_count(env)
    seen = dist.get_world_size()
    if want > 1 and seen != want:
        raise TimeoutError(
            f"slice world incomplete: world size {seen}, want {want}")
    backend = dist.get_backend()
    one = torch.ones(1, device="cuda" if backend == "nccl" else "cpu")
    dist.all_reduce(one)
    if int(one.item()) != seen:
        raise RuntimeError(f"an all-reduce of ones over the world gave "
                           f"{int(one.item())}, want {seen}")
    return {
        "worker_id": env.worker_id,
        "num_workers": env.num_workers,
        "device_count": seen,
        "local_device_count": seen // env.num_workers,
        "accelerator": env.accelerator,
        "topology": env.topology,
        "backend": backend,
    }
