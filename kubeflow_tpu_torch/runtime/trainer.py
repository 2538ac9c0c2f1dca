"""Trainer: the training loop a provisioned notebook runs on its card.

Port of ``kubeflow_tpu/runtime/trainer.py``: the train step of
models/train.py, the device prefetch of runtime/data.py, held-out
evaluation, throughput accounting, an optional ``torch.profiler``
window, and checkpoint/resume through runtime/checkpoint.py, for both
model families (a dense ``TransformerConfig`` or an ``MoEConfig``) and
for LoRA finetuning of a dense base, on one device or on a mesh
(``mesh=``: ``make_sharded_train_step``, ``make_sharded_moe_train_step``
or ``make_sharded_lora_step``, every rank of the mesh running the same
Trainer calls on its own shards; pp meshes pipeline the dense and MoE
families).

Loop design: the step returns the loss as a device tensor and the host
reads it only at log points, so PyTorch's launch queue runs ahead of the
card between them; the next batch is already on the device (prefetch).
"""

from __future__ import annotations

import itertools
import logging
import math
import pathlib
import time
from collections import deque
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models import train as train_lib
from ..models.moe import (MoEConfig, make_moe_train_step,
                          make_sharded_moe_train_step)
from ..models.transformer import (TransformerConfig, model_flops_per_token,
                                  param_specs)
from ..parallel import comm
from ..parallel.partition_rules import shard_tree
from .checkpoint import TrainCheckpointer
from .data import prefetch_to_device

log = logging.getLogger("kubeflow_tpu_torch.trainer")


@dataclass
class TrainerStats:
    step: int = 0
    last_loss: float | None = None
    tokens_seen: int = 0
    steps_per_sec: float = 0.0
    tokens_per_sec: float = 0.0
    model_tflops_per_sec: float = 0.0
    # (step, loss) / (step, eval loss) at log points, bounded (the
    # Trainer's stats_history_cap sets the maxlen)
    losses: deque = field(default_factory=lambda: deque(maxlen=1000))
    evals: deque = field(default_factory=lambda: deque(maxlen=1000))


class Trainer:
    """Train a ``TransformerConfig`` or an ``MoEConfig`` on one device
    with prefetch and throughput accounting. ``device`` defaults to the
    card and raises where CUDA is absent; pass ``device="cpu"`` to run on
    the CPU. An ``MoEConfig`` trains its params in f32 whatever
    ``bf16_params`` says, as the reference's MoE step does.

    With ``checkpoint_dir`` the Trainer resumes from the latest checkpoint
    there when it is built, and ``fit`` saves after every step under the
    ``checkpoint_interval`` policy, keeping ``max_checkpoints``.

    LoRA mode (``lora=LoRAConfig(...)`` with ``base_params``): ``params``
    are the adapters, the frozen base rides every step; checkpoints and
    resume hold the adapters and their optimizer state only, ``evaluate``
    runs the merged model and ``merged_params()`` returns it.

    With ``mesh`` (a DeviceMesh of parallel/mesh.py) the Trainer is SPMD:
    every rank of the mesh builds it with the same arguments and makes
    the same calls. Params and optimizer state are the rank's shards
    (on a pp mesh the layer axis over pp, ``pipeline_rules``), ``device``
    is the mesh's, ``fit`` and ``evaluate`` stage each rank's slice of
    every batch, the stats count the whole batch's tokens (TFLOP/s per
    device), and checkpoints hold the full tensors and resume onto any
    mesh. In LoRA mode ``base_params`` are the full base weights; each
    rank keeps its shards of them. A rank outside ``mesh`` is refused."""

    def __init__(self, config: TransformerConfig,
                 train_config: train_lib.TrainConfig | None = None, *,
                 device="cuda", seed: int = 0, profile_dir=None,
                 profile_steps: tuple = (10, 15),
                 stats_history_cap: int = 1000, checkpoint_dir=None,
                 checkpoint_interval: int = 100, max_checkpoints: int = 3,
                 lora=None, base_params=None, mesh=None):
        self.config = config
        self.tc = train_config or train_lib.TrainConfig()
        self.mesh = mesh
        is_moe = isinstance(config, MoEConfig)
        self.lora = lora
        self._base = None
        if lora is not None and is_moe:
            raise ValueError("LoRA targets the dense family; MoE adapter "
                             "routing is not implemented")
        if lora is not None and base_params is None:
            raise ValueError("lora mode requires base_params (the "
                             "pretrained weights being finetuned)")
        if mesh is not None and \
                dist.get_rank() not in mesh.mesh.flatten().tolist():
            raise ValueError(
                f"rank {dist.get_rank()} is not in the mesh "
                f"{mesh.mesh.flatten().tolist()}: build the Trainer on the "
                f"mesh's ranks only (the others build the mesh and wait)")
        self.device = comm.mesh_device(mesh) if mesh is not None else \
            resolve_device(device)
        # on a mesh: the layout the step shards by, and checkpoints with it
        self._rules = self._specs = None
        if mesh is not None:
            self._rules = train_lib.mesh_rules(mesh)
        if lora is not None:
            from ..models.lora import (lora_specs, make_lora_step,
                                       make_sharded_lora_step)
            self._base = train_lib.tree_map(
                lambda p: p.detach().to(self.device), base_params)
            if mesh is None:
                self.init_fn, lora_step = make_lora_step(
                    config, lora, self.tc, self.device)
            else:
                self._base = shard_tree(
                    self._base, param_specs(config, self._rules), mesh)
                self._specs = lora_specs(config, lora, self._rules)
                self.init_fn, lora_step = make_sharded_lora_step(
                    mesh, config, lora, self.tc, self._rules)
            self.step_fn = lambda p, o, t, tg: lora_step(self._base, p, o,
                                                         t, tg)
        elif mesh is not None:
            self._specs = param_specs(config, self._rules)
            make = make_sharded_moe_train_step if is_moe else \
                train_lib.make_sharded_train_step
            self.init_fn, self.step_fn = make(mesh, config, self.tc,
                                              self._rules)
        elif is_moe:
            self.init_fn, self.step_fn = make_moe_train_step(
                config, self.tc, self.device)
        else:
            self.init_fn, self.step_fn = train_lib.make_train_step(
                config, self.tc, self.device)
        # the ranks of the data axes: each stages 1/data_shards of a batch
        self._data_shards = comm.axis_size(mesh, train_lib.data_axes())
        self.stats = TrainerStats(
            losses=deque(maxlen=stats_history_cap),
            evals=deque(maxlen=stats_history_cap))
        self.profile_dir = pathlib.Path(profile_dir) if profile_dir else None
        self.profile_steps = profile_steps
        self._profiler = None
        self._eval_loss = None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params, self.opt_state = self.init_fn(generator)
        self.checkpointer = None
        if checkpoint_dir is not None:
            self.checkpointer = TrainCheckpointer(
                checkpoint_dir, max_to_keep=max_checkpoints,
                save_interval_steps=checkpoint_interval, mesh=mesh,
                param_specs=self._specs)
            self._maybe_resume()

    def _maybe_resume(self) -> None:
        """Restore the latest checkpoint into the freshly built state."""
        restored = self.checkpointer.restore(self.params, self.opt_state)
        if restored is None:
            return
        step, self.params, self.opt_state = restored
        self.stats.step = step
        log.info("resumed from checkpoint at step %d", step)

    # --------------------------------------------------------------- loop
    def fit(self, source, *, steps: int, log_every: int = 50,
            prefetch_buffer: int = 2) -> TrainerStats:
        """Train for ``steps`` steps over ``source`` (an iterable of
        (tokens, targets) numpy batches). Returns the updated stats; call
        again to continue (the step count persists)."""
        flops_tok = model_flops_per_token(self.config)
        start_step = self.stats.step
        target = start_step + steps
        t0 = time.perf_counter()
        tokens_t0 = self.stats.tokens_seen
        loss = None
        # bound the draw count BEFORE prefetch: a stateful source reused
        # across fit() calls must not lose the batches staged ahead
        bounded = itertools.islice(iter(source), steps)
        with prefetch_to_device(bounded, self.device,
                                buffer_size=prefetch_buffer,
                                mesh=self.mesh) as batches:
            for tokens, targets in batches:
                if self.stats.step >= target:
                    break
                self._profile_tick()
                self.params, self.opt_state, loss = self.step_fn(
                    self.params, self.opt_state, tokens, targets)
                self.stats.step += 1
                self.stats.tokens_seen += tokens.numel() * self._data_shards
                if self.checkpointer is not None:
                    self.checkpointer.save(self.stats.step, self.params,
                                           self.opt_state)
                if self.stats.step % log_every == 0 or \
                        self.stats.step == target:
                    # the only host sync point in the loop
                    self.stats.last_loss = float(loss)
                    self.stats.losses.append(
                        (self.stats.step, self.stats.last_loss))
                    dt = time.perf_counter() - t0
                    dtok = self.stats.tokens_seen - tokens_t0
                    if dt > 0:
                        self.stats.tokens_per_sec = dtok / dt
                        self.stats.steps_per_sec = \
                            (self.stats.step - start_step) / dt
                        # 3x forward FLOPs for forward + backward, per
                        # device
                        self.stats.model_tflops_per_sec = \
                            3 * flops_tok * dtok / dt / 1e12 / (
                                self.mesh.size() if self.mesh else 1)
                    log.info("step %d loss %.4f %.0f tok/s",
                             self.stats.step, self.stats.last_loss,
                             self.stats.tokens_per_sec)
        if loss is not None and self.stats.last_loss is None:
            self.stats.last_loss = float(loss)
        return self.stats

    # --------------------------------------------------------------- eval
    def evaluate(self, source, *, max_batches: int | None = None,
                 prefetch_buffer: int = 2) -> dict:
        """Held-out evaluation: token-weighted mean cross entropy and
        perplexity over ``source`` (``max_batches`` bounds a generator).
        Changes no parameter or optimizer state; the result is also
        appended to ``stats.evals`` as (step, loss). The loss is
        ``build_eval_loss``, the train step's own dispatch without the
        MoE router aux (pipelined on a pp mesh); in LoRA mode it runs on
        the merged params."""
        if self._eval_loss is None:
            self._eval_loss = train_lib.build_eval_loss(
                self.config, self.tc, mesh=self.mesh, rules=self._rules)
        params = self.params if self.lora is None else self.merged_params()
        bounded = iter(source) if max_batches is None else \
            itertools.islice(iter(source), max_batches)
        # device-side sums; the one readback is after the last batch
        total = count = 0
        n_batches = 0
        with torch.no_grad(), prefetch_to_device(
                bounded, self.device, buffer_size=prefetch_buffer,
                mesh=self.mesh) as batches:
            for tokens, targets in batches:
                # on a mesh the loss is this rank's share of the global
                # mean over every rank's valid tokens: summed over the
                # data axes it is the batch's mean, as step_fn's loss
                axes = train_lib.data_axes()
                n = comm.all_reduce_((targets >= 0).sum(), self.mesh, axes)
                loss = comm.all_reduce_(
                    self._eval_loss(params, tokens, targets), self.mesh, axes)
                total = total + loss * n
                count = count + n
                n_batches += 1
        n_tokens = int(count)
        if n_tokens == 0:
            raise ValueError("evaluate() saw no valid tokens")
        mean_loss = float(total) / n_tokens
        result = {"loss": mean_loss, "perplexity": math.exp(mean_loss),
                  "batches": n_batches, "tokens": n_tokens,
                  "step": self.stats.step}
        self.stats.evals.append((self.stats.step, mean_loss))
        log.info("eval @ step %d: loss %.4f ppl %.2f (%d tokens)",
                 self.stats.step, mean_loss, result["perplexity"], n_tokens)
        return result

    # ------------------------------------------------------------ profile
    def _profile_tick(self) -> None:
        """Open/close the torch.profiler window when the step counter
        crosses [start, stop); the trace goes to ``profile_dir``."""
        if self.profile_dir is None:
            return
        start, stop = self.profile_steps
        if self._profiler is None and self.stats.step == start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
        elif self._profiler is not None and self.stats.step >= stop:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        start, stop = self.profile_steps
        path = self.profile_dir / f"trace_steps_{start}_{stop}.json"
        prof.export_chrome_trace(str(path))
        log.info("profile trace written to %s", path)

    def merged_params(self) -> dict:
        """LoRA mode: the base with the trained adapters merged in — a
        plain servable model for generate, speculation and the
        engines."""
        if self.lora is None:
            raise ValueError("merged_params() is for lora mode; in full "
                             "training self.params already IS the model")
        from ..models.lora import merge_lora
        with torch.no_grad():
            return merge_lora(self._base, self.params, self.lora)

    def save(self, *, force: bool = True) -> None:
        """Durably persist the current step (idempotent: a step the
        interval policy already wrote is not written again)."""
        if self.checkpointer is None:
            return
        self.checkpointer.wait()
        if self.stats.step not in self.checkpointer.all_steps():
            self.checkpointer.save(self.stats.step, self.params,
                                   self.opt_state, force=force)
        self.checkpointer.wait()

    def close(self) -> None:
        if self._profiler is not None:
            self._stop_profile()
        if self.checkpointer is not None:
            self.checkpointer.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
