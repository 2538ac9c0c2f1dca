"""Elastic training: shrink on preemption, grow back on repair, no restart.

Port of ``kubeflow_tpu/runtime/elastic.py``. Two halves, one handshake:

``ElasticTrainer`` wraps ``runtime.trainer.Trainer`` on a
``build_hybrid_mesh`` whose ``dp`` axis spans slices. ``resize(n)``
drains the card's queue, forces a durable save, rebuilds the mesh with
the new slice count and lets the new Trainer's resume restore the state
onto it (a sharded checkpoint is the full tensors, restored onto any
mesh). The step counter and the loss history continue; the cost is the
drain + save + restore blip.

The reference is single-controller: it takes the first devices it needs.
Here one process is one rank of a ``torch.distributed`` world: the
world's first ``n_slices x per_slice.size`` ranks (of ``ranks``) form
the mesh, and the ranks beyond them are *standby*: they hold no Trainer,
their ``fit`` and ``evaluate`` return without stepping, and they rejoin
on ``grow`` by restoring from the checkpoint. ``resize`` is collective
over the whole world, as process groups are made collectively: every
rank calls it with the same count.

The controller side drives WHEN to resize through the
``tpu.kubeflow.org/elastic-resize`` annotation machine (Stable →
Draining → Resharding → Stable). The agents here answer it: ack Draining
once the state is durable, resize when the controller advances to
Resharding, ack again. Over a world only rank 0 reads and patches the
Notebook: it broadcasts what it read to every rank each ``poll_once``,
all ranks act on it together, and rank 0 acks after every rank has
finished (a barrier), so the ranks never see different states and the
collective resize cannot deadlock.

``SimulatedElasticAgent`` is the chaos-tier stand-in: the same protocol,
with a virtual step counter on a deterministic loss curve.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import torch
import torch.distributed as dist

from ..parallel.mesh import MeshConfig, build_hybrid_mesh
from ..utils import k8s, names
from .trainer import Trainer, TrainerStats

log = logging.getLogger("kubeflow_tpu_torch.elastic")

# states the runtime agent writes into ELASTIC_ACK_ANNOTATION (the echo of
# the controller's carrier states, plus the dead-agent latch the controller
# stamps on abort and only a LIVE agent clears)
ACK_DRAINING = "Draining"
ACK_RESHARDING = "Resharding"
ACK_ABORTED = "Aborted"

# virtual-tick cost of one resize in the simulated agent's MFU accounting:
# a drain + forced save + cross-mesh restore is worth about this many lost
# productive steps at chaos scale (deterministic, no wall clock)
ELASTIC_BLIP_STEPS = 2


def _world_device() -> torch.device:
    """Where the world's collectives run: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world_broadcast(obj, src: int):
    """Rank ``src``'s picklable ``obj`` on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _world_barrier() -> None:
    dist.all_reduce(torch.zeros(1, device=_world_device()))


def _drain(trainer: Trainer) -> None:
    """Every queued step landed on the card, then a forced durable save
    (collective over the trainer's mesh)."""
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    trainer.save(force=True)


class ElasticTrainer:
    """A Trainer that can change its slice count mid-run.

    ``per_slice`` is the intra-slice mesh; ``n_slices`` multiplies ``dp``
    across slices. ``checkpoint_dir`` is mandatory: a resize is
    checkpoint-mediated. ``ranks`` are the world ranks the trainer may
    use (default: the whole world), the mesh taking the first of them;
    ``device`` is the mesh's kind ("cuda" takes NCCL's cards, "cpu"
    gloo's). Every rank of the world builds it with the same arguments
    and makes the same calls.

    ``resize`` rebuilds the inner Trainer; construction inits params on
    the new mesh and overwrites them from the checkpoint (the resume path
    a culled slice takes), so correctness never depends on in-memory
    state surviving the mesh swap.
    """

    def __init__(self, per_slice: MeshConfig, n_slices: int, config,
                 train_config=None, checkpoint_dir=None, *, ranks=None,
                 device="cuda", resize_events_cap: int = 1000,
                 **trainer_kwargs):
        if checkpoint_dir is None:
            raise ValueError("ElasticTrainer requires checkpoint_dir: "
                             "resize is checkpoint-mediated")
        self.per_slice = per_slice
        self.config = config
        self.train_config = train_config
        self.checkpoint_dir = checkpoint_dir
        self.device = device
        self._ranks = list(ranks) if ranks is not None else \
            list(range(dist.get_world_size()))
        self._kwargs = dict(trainer_kwargs)
        self.n_slices = n_slices
        # a standby rank's view of the stats (the Trainer's on the mesh)
        self._standby_stats = TrainerStats()
        # (old_n, new_n, step, seconds) per completed resize, bounded so a
        # long run under preemption churn keeps only the newest
        self.resize_events: deque = deque(maxlen=resize_events_cap)
        # the mesh of each slice count used so far: a mesh is made
        # collectively with process groups of its own (under NCCL each
        # with its communicator's buffers on the card), so a count seen
        # before reuses its mesh instead of adding groups on every resize
        self._meshes: dict = {}
        self._check_bounds(n_slices)
        self.trainer = self._build(n_slices)

    def _check_bounds(self, n_slices: int) -> None:
        if n_slices < 1:
            raise ValueError(f"n_slices must be >= 1, got {n_slices}")
        if n_slices * self.per_slice.size > len(self._ranks):
            raise ValueError(
                f"{n_slices} slices x {self.per_slice.size} ranks/slice "
                f"exceed the {len(self._ranks)} available ranks")

    def _build(self, n_slices: int) -> Trainer | None:
        """The Trainer on ``n_slices`` slices, or None on a standby rank
        (every rank of the world builds the mesh)."""
        used = self._ranks[: n_slices * self.per_slice.size]
        if n_slices not in self._meshes:
            self._meshes[n_slices] = build_hybrid_mesh(
                n_slices, self.per_slice, self.device, ranks=used)[0]
        mesh = self._meshes[n_slices]
        if dist.get_rank() not in used:
            return None
        return Trainer(self.config, self.train_config, mesh=mesh,
                       checkpoint_dir=self.checkpoint_dir, **self._kwargs)

    # ------------------------------------------------------------- resize
    def resize(self, n_slices: int) -> None:
        """Drain → save → rebuild the mesh → restore → keep going.
        Collective over the world."""
        if n_slices == self.n_slices:
            return
        self._check_bounds(n_slices)
        t0 = time.perf_counter()
        old = self.trainer
        if old is not None:
            _drain(old)
            old.close()
        # the mesh's first rank wrote the save and waited for it: its
        # stats reach every rank only after that, so no rank restores
        # before the files are durable
        old_stats = _world_broadcast(
            old.stats if dist.get_rank() == self._ranks[0] else None,
            self._ranks[0])
        self.trainer = self._build(n_slices)
        st = self.stats
        if self.trainer is None:
            st.step = old_stats.step
        if st.step != old_stats.step:
            raise RuntimeError(
                f"elastic restore landed on step {st.step}, expected "
                f"{old_stats.step}: checkpoint continuity broken")
        # the history and counters live on the host: carry them across
        st.losses.clear()
        st.losses.extend(old_stats.losses)
        st.evals.clear()
        st.evals.extend(old_stats.evals)
        st.tokens_seen = old_stats.tokens_seen
        st.last_loss = old_stats.last_loss
        dt = time.perf_counter() - t0
        self.resize_events.append((self.n_slices, n_slices, st.step, dt))
        log.info("elastic resize %d → %d slices at step %d (%.2fs)",
                 self.n_slices, n_slices, st.step, dt)
        self.n_slices = n_slices

    def shrink(self) -> None:
        self.resize(self.n_slices - 1)

    def grow(self) -> None:
        self.resize(self.n_slices + 1)

    # ---------------------------------------------------------- delegates
    @property
    def standby(self) -> bool:
        """Whether this rank is outside the current mesh."""
        return self.trainer is None

    @property
    def mesh(self):
        return None if self.standby else self.trainer.mesh

    @property
    def params(self):
        return None if self.standby else self.trainer.params

    @property
    def opt_state(self):
        return None if self.standby else self.trainer.opt_state

    @property
    def stats(self) -> TrainerStats:
        """The Trainer's stats; on a standby rank, those of the last
        resize."""
        return self._standby_stats if self.standby else self.trainer.stats

    def fit(self, source, **kw) -> TrainerStats:
        """The Trainer's fit; a standby rank returns its stats at once."""
        return self.stats if self.standby else self.trainer.fit(source, **kw)

    def evaluate(self, source, **kw) -> dict | None:
        """The Trainer's evaluate; None on a standby rank."""
        return None if self.standby else self.trainer.evaluate(source, **kw)

    def save(self, **kw) -> None:
        if not self.standby:
            self.trainer.save(**kw)

    def close(self) -> None:
        if not self.standby:
            self.trainer.close()

    def __enter__(self) -> "ElasticTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _ElasticAgentBase:
    """The runtime half of the elastic-resize handshake.

    Polls the Notebook's elastic-resize carrier and answers it:

    - ``Draining``    → ``_on_drain`` (stop stepping, durable save), then
                        ack ``Draining``;
    - ``Resharding``  → ``_on_reshard`` (rebuild onto the target slice
                        count), then ack ``Resharding`` (the controller
                        stamps the new current-slices count when it
                        completes the cycle);
    - absent (Stable) → ``_on_tick`` (productive work), and clear the
                        ``Aborted`` dead-agent latch if the controller left
                        one: only a live agent may clear it, which is what
                        clearing it proves.

    Acks are idempotent (state-compared before writing) so a poll racing
    a controller patch never double-writes. ``_share`` and ``_settle``
    are where an agent over a world makes every rank act on rank 0's
    reading (identity and nothing here).
    """

    def __init__(self, client, namespace: str, name: str, *,
                 poll_s: float = 0.02):
        self.client = client
        self.namespace = namespace
        self.name = name
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # hooks -------------------------------------------------------------
    def _on_drain(self) -> None:
        raise NotImplementedError

    def _on_reshard(self, target: int) -> None:
        raise NotImplementedError

    def _on_tick(self) -> None:
        raise NotImplementedError

    def _reads(self) -> bool:
        """Whether this process reads and patches the Notebook."""
        return True

    def _share(self, view: tuple | None) -> tuple:
        """The reader's (state, ack, target) on every process."""
        return view

    def _settle(self) -> None:
        """Return once every process has finished the turn's work."""

    # wire --------------------------------------------------------------
    def _patch(self, annotations: dict) -> None:
        self.client.patch("Notebook", self.namespace, self.name,
                          {"metadata": {"annotations": annotations}})

    def poll_once(self) -> None:
        """One handshake turn. Drive this from a thread (``start``) or
        synchronously between fit() chunks when the resize work must run
        on the caller's thread (a real resize is not thread-safe against
        a concurrently stepping loop)."""
        view = None
        if self._reads():
            nb = self.client.get("Notebook", self.namespace, self.name)
            view = (k8s.get_annotation(nb, names.ELASTIC_RESIZE_ANNOTATION),
                    k8s.get_annotation(nb, names.ELASTIC_ACK_ANNOTATION),
                    k8s.get_annotation(nb, names.ELASTIC_TARGET_ANNOTATION))
        state, ack, target = self._share(view)
        if state == ACK_DRAINING:
            if ack != ACK_DRAINING:
                self._on_drain()
                self._settle()
                if self._reads():
                    self._patch({names.ELASTIC_ACK_ANNOTATION: ACK_DRAINING})
        elif state == ACK_RESHARDING:
            if ack != ACK_RESHARDING and target is not None:
                self._on_reshard(int(target))
                self._settle()
                # the ack is the agent's ONLY annotation: the controller
                # stamps current-slices itself when it completes the cycle
                if self._reads():
                    self._patch({
                        names.ELASTIC_ACK_ANNOTATION: ACK_RESHARDING,
                    })
        else:
            if ack == ACK_ABORTED and self._reads():
                self._patch({names.ELASTIC_ACK_ANNOTATION: None})
            self._on_tick()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — agent must outlive races
                log.debug("elastic agent poll failed", exc_info=True)
            self._stop.wait(self.poll_s)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"elastic-agent-{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class ElasticAgent(_ElasticAgentBase):
    """Handshake agent bound to a real ``ElasticTrainer``. Drive it with
    ``poll_once`` between fit() chunks: the resize must run on the
    training thread. Every rank of the world builds one and polls
    together; only the world's rank 0 uses ``client`` (the others may
    pass None)."""

    def __init__(self, trainer: ElasticTrainer, client, namespace: str,
                 name: str, **kw):
        super().__init__(client, namespace, name, **kw)
        self.trainer = trainer

    def _world(self) -> bool:
        return dist.is_initialized() and dist.get_world_size() > 1

    def _reads(self) -> bool:
        return not self._world() or dist.get_rank() == 0

    def _share(self, view: tuple | None) -> tuple:
        return _world_broadcast(view, 0) if self._world() else view

    def _settle(self) -> None:
        if self._world():
            _world_barrier()

    def _on_drain(self) -> None:
        if not self.trainer.standby:
            _drain(self.trainer.trainer)

    def _on_reshard(self, target: int) -> None:
        self.trainer.resize(target)

    def _on_tick(self) -> None:
        pass


class SimulatedElasticAgent(_ElasticAgentBase):
    """Protocol-faithful agent with virtual training: each Stable-state
    poll is one productive step on a deterministic loss curve; each resize
    costs ``ELASTIC_BLIP_STEPS`` virtual steps of MFU. Chaos checks read
    ``steps``/``resizes``/``current``/``violations``/``mfu()``."""

    def __init__(self, client, namespace: str, name: str, *,
                 poll_s: float = 0.02, current_slices: int | None = None):
        super().__init__(client, namespace, name, poll_s=poll_s)
        self.steps = 0
        self.resizes = 0
        self.current = current_slices
        self.losses: list = []
        self.violations: list = []

    def _loss_at(self, step: int) -> float:
        # smooth monotone-decreasing curve: per-step delta < 0.02, so a
        # step-counter reset (loss jumping back toward 2.0) is detectable
        # while honest resumption is continuous by construction
        return 2.0 / (1.0 + 0.01 * step)

    def _on_drain(self) -> None:
        pass

    def _on_reshard(self, target: int) -> None:
        self.current = target
        self.resizes += 1

    def _on_tick(self) -> None:
        self.steps += 1
        loss = self._loss_at(self.steps)
        if self.losses:
            last_step, last_loss = self.losses[-1]
            if self.steps <= last_step:
                self.violations.append(
                    f"step counter reset: {last_step} → {self.steps}")
            if abs(loss - last_loss) > 0.05:
                self.violations.append(
                    f"loss discontinuity at step {self.steps}: "
                    f"{last_loss:.4f} → {loss:.4f}")
        self.losses.append((self.steps, loss))

    def mfu(self) -> float:
        """Fraction of virtual ticks spent stepping vs. resize blips,
        relative to a static mesh (which spends every tick stepping)."""
        blip = ELASTIC_BLIP_STEPS * self.resizes
        return self.steps / (self.steps + blip) if self.steps else 0.0
