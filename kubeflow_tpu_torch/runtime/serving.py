"""Batched generation service: the serving half of the notebook workload.

Port of ``kubeflow_tpu/runtime/serving.py`` ``GenerateRequest`` and
``BatchedGenerator`` (the shape-bucketed engine). A background scheduler
thread coalesces concurrent same-shape requests — same (prompt_len,
max_new_tokens) — into one batch, pads the batch to a power of two
(capped at ``max_batch``) with dummy rows, and runs it to completion
through ``models/decode.py`` ``generate``, with per-row temperature,
top-k and top-p. ``ContinuousBatchedGenerator`` and speculative decoding
come with later slices of the port (ROADMAP queue A).

The engine thread issues all the CUDA work, so the kernels launch on that
thread's current stream. Matmul weights are cast to the compute dtype
once at load instead of on every call: ``wcast`` of the cast weight gives
the same values, without re-reading the f32 masters every step.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.decode import generate
from ..models.quant import BLOCK_AXES, is_quantized, quantize_params


@dataclass
class GenerateRequest:
    prompt: np.ndarray                # (prompt_len,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0                    # 0 disables the k-cut
    top_p: float = 1.0                # 1.0 disables the nucleus cut
    future: Future = field(default_factory=Future)
    # streaming: called with each generated token id (int), on the engine
    # thread, BEFORE the future resolves — must be cheap and non-blocking
    on_token: object | None = None

    @property
    def shape_key(self) -> tuple:
        return (len(self.prompt), self.max_new_tokens)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_matmul_weights(params: dict, dtype: torch.dtype) -> dict:
    """The embedding, LM head and block matmul weights in ``dtype``;
    quantized nodes and the norm vectors (read in f32) stay as they are."""
    def cast(w):
        return w if is_quantized(w) else w.to(dtype)
    out = dict(params)
    out["embed"] = params["embed"].to(dtype)
    out["lm_head"] = cast(params["lm_head"])
    out["blocks"] = {name: cast(w) if name in BLOCK_AXES else w
                     for name, w in params["blocks"].items()}
    return out


class BatchedGenerator:
    """Coalesce concurrent generate requests into shape-matched batches.

    ``submit`` returns a Future resolving to the (max_new_tokens,) int32
    generated ids; ``generate_sync`` blocks for the result. A batch runs
    to completion, so a streaming request (``on_token``) receives its ids
    when its batch finishes, just before the future resolves.
    """

    supports_streaming = True

    def __init__(self, params, config, *, max_batch: int = 8,
                 max_wait_s: float = 0.01, seed: int = 0,
                 quantize: bool = False, draft_params=None,
                 draft_config=None, device="cuda"):
        if draft_params is not None or draft_config is not None:
            raise NotImplementedError(
                "speculative decoding (a draft model) is not ported yet "
                "(ROADMAP queue A item 3, speculative decoding)")
        self.device = resolve_device(device)
        params = _tree_map(lambda t: t.to(self.device), params)
        if quantize:
            params = quantize_params(params)
        self.params = cast_matmul_weights(params, config.compute_dtype)
        self.config = config
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._queue: queue.Queue = queue.Queue()
        # shape-mismatched requests parked in arrival order: the next cycle
        # starts from this deque's head, so minority shapes cannot starve
        self._pending: collections.deque = collections.deque()
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._closed = False
        self._lifecycle = threading.Lock()  # submit/close atomicity
        self.batch_sizes: collections.deque = collections.deque(maxlen=1024)
        self.batches_total = 0
        self.requests_total = 0
        self._thread = threading.Thread(target=self._scheduler, daemon=True,
                                        name="kubeflow-tpu-torch-serving")
        self._thread.start()

    # ----------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, on_token=None) -> Future:
        req = GenerateRequest(np.asarray(prompt, np.int32), max_new_tokens,
                              temperature, top_k, top_p, on_token=on_token)
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("generator is closed")
            self._queue.put(req)
        return req.future

    def generate_sync(self, prompt, max_new_tokens: int,
                      temperature: float = 0.0, *, top_k: int = 0,
                      top_p: float = 1.0, timeout: float = 120.0):
        return self.submit(prompt, max_new_tokens, temperature, top_k,
                           top_p).result(timeout=timeout)

    def close(self) -> None:
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel AFTER the last possible submit
        self._thread.join(timeout=10)

    def __enter__(self) -> "BatchedGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ scheduler
    def _take_batch(self) -> list[GenerateRequest] | None:
        """Oldest request first (parked pending before the live queue), then
        gather shape-matched peers until max_batch or a monotonic
        ``max_wait_s`` deadline. Mismatches park in arrival order. Returns
        None on the close sentinel."""
        if self._pending:
            first = self._pending.popleft()
        else:
            first = self._queue.get()
            if first is None:
                return None
        batch = [first]
        for req in list(self._pending):
            if len(batch) >= self.max_batch:
                break
            if req.shape_key == first.shape_key:
                self._pending.remove(req)
                batch.append(req)
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)  # re-arm the sentinel for next cycle
                break
            if req.shape_key == first.shape_key:
                batch.append(req)
            else:
                self._pending.append(req)
        return batch

    def _scheduler(self) -> None:
        while True:  # pump: scheduler; sentinel batch=None breaks via return
            batch = self._take_batch()
            if batch is None:
                # drain: fail any stragglers so callers don't hang
                stragglers = list(self._pending)
                self._pending.clear()
                while True:  # bounded: drains queue until Empty
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if req is not None:
                        stragglers.append(req)
                for req in stragglers:
                    req.future.set_exception(RuntimeError("generator closed"))
                return
            try:
                self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 — deliver per-request
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)

    @staticmethod
    def _bucket_size(n: int) -> int:
        """Smallest power of two >= n."""
        size = 1
        while size < n:
            size *= 2
        return size

    def _run_batch(self, batch: list[GenerateRequest]) -> None:
        self.batch_sizes.append(len(batch))
        self.batches_total += 1
        self.requests_total += len(batch)
        rows = [r.prompt for r in batch]
        temps = [r.temperature for r in batch]
        top_ks = [r.top_k for r in batch]
        top_ps = [r.top_p for r in batch]
        # never exceed the operator's cap: max_batch bounds device memory
        pad = min(self._bucket_size(len(batch)), self.max_batch) - len(batch)
        if pad:
            rows.extend([rows[0]] * pad)       # dummy rows, outputs discarded
            temps.extend([0.0] * pad)
            top_ks.extend([0] * pad)
            top_ps.extend([1.0] * pad)
        prompts = torch.as_tensor(np.stack(rows), dtype=torch.long,
                                  device=self.device)
        out = generate(self.params, prompts, self.config,
                       batch[0].max_new_tokens, temperature=temps,
                       generator=self._rng, top_k=top_ks, top_p=top_ps)
        out = out.cpu().numpy()
        for i, req in enumerate(batch):
            if req.on_token is not None:
                for tok in out[i]:
                    req.on_token(int(tok))
            req.future.set_result(out[i])
