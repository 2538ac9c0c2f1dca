"""Batched generation service: the serving half of the notebook workload.

Port of ``kubeflow_tpu/runtime/serving.py``. Two engines, one
submit/Future API:

- ``BatchedGenerator`` — shape-bucketed: a background scheduler thread
  coalesces concurrent same-shape requests — same (prompt_len,
  max_new_tokens) — into one batch, pads it to a power of two (capped at
  ``max_batch``) with dummy rows, and runs it to completion through
  ``models/decode.py`` ``generate``, with per-row temperature, top-k and
  top-p; it does not stream (the server answers a streamed request 400);
- ``ContinuousBatchedGenerator`` — requests join and leave a RUNNING
  batch at token boundaries, with chunked prefill admission, an exact
  prefix cache, cooperative cancellation and per-token streaming.

Both speculate with a draft model (models/speculative.py): the same
greedy ids, the same sampled distributions, with the target's weights
read once per accepted block instead of once per token. The verify
window is ``decode_window``'s einsum while a plain decode step on the
card takes the flash-decode kernel, and the two may round a greedy
near-tie apart; so where ``uses_flash_decode`` holds (always on CUDA)
``spec_exact_only=True``, the default, keeps the exact path: the bucketed
engine runs ``generate`` instead, the continuous engine refuses the
draft.

Each engine's thread issues all of its CUDA work, so the kernels launch on
that thread's current stream; HTTP threads only enqueue. Matmul weights
are cast to the compute dtype once at load instead of on every call:
``wcast`` of the cast weight gives the same values, without re-reading the
f32 masters every step.

Over a mesh (params from ``runtime.sharded_decode.shard_decode_params``)
the engines are SPMD: every rank of the mesh builds the engine with the
same params, seed and options, and only the mesh's first rank, the
*driver*, takes requests (``submit`` raises on the others). The reference
is single-controller and needs none of this. Each engine iteration the
driver makes every decision that depends on its host (which queued
requests to admit into which slot, cancellations, whether anything
waits, draining; for the bucketed engine the batch it took) and
broadcasts it as one plan (``comm.broadcast_plan``); the other ranks
apply the same plan to their own state, so every rank runs the same
chunks, prefix-cache hits, ticks and sampling draws on the same logits
(gathered over tp). Followers deliver nothing: their engine thread ends
when a plan says drain. Plans travel on the mesh's plan group
(``comm.make_plan_group``), a gloo group on the host whose waits the
world's collective timeout does not end: the followers wait in the
broadcast while the driver idles. One engine at a time serves on a mesh.

A failure on one rank of a mesh reaches every rank through
``comm.any_failed``, on the same group. A failure before the iteration's
first collective (the plan's cancellations and admissions) or after its
device work (the tokens' delivery) fails every in-flight request on
every rank; each rank rebuilds its state and the engine serves on. A
failure inside the device work (the bucketed engine's whole batch) may
leave the mesh's collectives out of step, so it closes the engine on
every rank; the peers learn of it when the collective they wait in
ends at the world's timeout (under NCCL the watchdog may end their
process instead). On a mesh of one rank nothing is broadcast or agreed.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.decode import (check_lengths, decode_step, decode_window,
                             generate, init_kv_cache, sample_token,
                             uses_flash_decode)
from ..models.quant import BLOCK_AXES, is_quantized, quantize_params
from ..models.speculative import (_categorical, _scaled_probs, emit_block,
                                  propose_and_verify, speculative_generate)
from ..parallel import comm


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
    # cooperative cancellation (client disconnect): the continuous engine
    # frees the slot at the next token boundary and fails the future with
    # CancelledError — set via the engine's cancel(), not directly
    cancelled: threading.Event = field(default_factory=threading.Event)

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


def _engine_device(params, device) -> torch.device:
    """The engine's device: ``device``, or for params sharded over a mesh
    the mesh's (``device`` must name the same kind)."""
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"params sharded over a {mesh.device_type} mesh "
                         f"cannot serve on device {device!r}")
    return comm.mesh_device(mesh)


def _serving_params(params: dict, config, device: torch.device,
                    quantize: bool) -> dict:
    """``params`` on ``device``, int8 weight-only when ``quantize``, with
    the matmul weights in the compute dtype. Sharded params stay on their
    mesh's device, quantize with global scales (every rank calls this)
    and keep their placement."""
    if getattr(params, "mesh", None) is not None:
        if quantize:
            params = quantize_params(params)
        return params.with_tree(cast_matmul_weights(params,
                                                    config.compute_dtype))
    params = _tree_map(lambda t: t.to(device), params)
    if quantize:
        params = quantize_params(params)
    return cast_matmul_weights(params, config.compute_dtype)


def _serving_draft(draft_params, draft_config, mesh, device):
    """The draft's serving params and config, or None; a draft sharded
    over a mesh must be on the target's."""
    if draft_params is None:
        return None
    dmesh = getattr(draft_params, "mesh", None)
    if dmesh is not None and dmesh is not mesh:
        raise ValueError("a sharded draft must be sharded over the "
                         "target's mesh")
    return (_serving_params(draft_params, draft_config, device, False),
            draft_config)


# what a rank reports of its part of an iteration: no failure, a failure
# where every rank is in step (outside the collectives), or one inside them
_OK, _IN_STEP, _INSIDE = 0, 1, 2


def _agree(failure: BaseException | None, mesh,
           inside: bool = False) -> tuple[BaseException | None, bool]:
    """The iteration's failure as every rank of ``mesh`` sees it (this
    rank's exception, one naming a peer when only a peer failed, or None),
    and whether a rank failed inside the iteration's collectives
    (``inside``: this one did), leaving the mesh's groups out of step. A
    failed agreement counts as such a failure."""
    code = _OK if failure is None else _INSIDE if inside else _IN_STEP
    try:
        worst = comm.any_failed(code, mesh)
    except Exception as exc:  # noqa: BLE001 — the mesh itself failed
        return failure or exc, True
    if worst != _OK and failure is None:
        failure = RuntimeError("the engine failed on another rank of its "
                               "mesh")
    return failure, worst == _INSIDE


def _spmd(mesh) -> bool:
    """Whether params on ``mesh`` serve over more than one rank."""
    return mesh is not None and mesh.size() > 1


def _claim(mesh) -> None:
    """Reserve ``mesh``'s plan group for one engine: the plans of two
    would interleave on it."""
    if _spmd(mesh):
        if getattr(mesh, "serving", False):
            raise ValueError("another engine serves on this mesh; close it "
                             "first, or shard onto a mesh of its own")
        mesh.serving = True


def _release(mesh) -> None:
    if _spmd(mesh):
        mesh.serving = False


def _refuse_follower(mesh) -> None:
    if not comm.is_mesh_root(mesh):
        raise RuntimeError("requests go to the mesh's first rank (the "
                           "driver); this rank follows its plans")


def _check_draft(draft_params, draft_config, spec_k: int) -> None:
    if (draft_params is None) != (draft_config is None):
        raise ValueError("draft_params and draft_config must be "
                         "provided together")
    if draft_params is not None and spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")


class BatchedGenerator:
    """Coalesce concurrent generate requests into shape-matched batches.

    ``submit`` returns a Future resolving to the (max_new_tokens,) int32
    generated ids; ``generate_sync`` blocks for the result.

    With ``draft_params``/``draft_config`` set, a batch speculates when
    no row warps (top-k/top-p), ``spec_exact_only`` does not hold it to
    the exact path, and prompt + max_new + ``spec_k`` fits both models;
    otherwise it runs ``generate``. ``spec_batches``/``spec_accepted``/
    ``spec_drafted`` count the real rows' acceptance dynamics,
    ``spec_blocks`` the verify blocks run.

    Over a mesh (sharded params) every rank builds it; the driver
    broadcasts each batch it takes, and every rank runs it. A batch is
    device work throughout, so on a mesh its failure closes the engine on
    every rank; the driver fails the batches ``generate`` refuses for
    their length before it broadcasts them.
    """

    def __init__(self, params, config, *, max_batch: int = 8,
                 max_wait_s: float = 0.01, seed: int = 0,
                 quantize: bool = False, draft_params=None,
                 draft_config=None, spec_k: int = 4,
                 spec_exact_only: bool = True, device="cuda"):
        _check_draft(draft_params, draft_config, spec_k)
        self.device = _engine_device(params, device)
        self._mesh = getattr(params, "mesh", None)
        self._spmd = _spmd(self._mesh)
        self.params = _serving_params(params, config, self.device, quantize)
        self.config = config
        self.draft = _serving_draft(draft_params, draft_config, self._mesh,
                                    self.device)
        self.spec_k = spec_k
        self.spec_exact_only = spec_exact_only
        self.spec_batches = 0
        self.spec_accepted = 0
        self.spec_drafted = 0
        self.spec_blocks = 0
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
        _claim(self._mesh)
        self._thread = threading.Thread(target=self._scheduler, daemon=True,
                                        name="kubeflow-tpu-torch-serving")
        self._thread.start()

    # ----------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> Future:
        _refuse_follower(self._mesh)
        req = GenerateRequest(np.asarray(prompt, np.int32), max_new_tokens,
                              temperature, top_k, top_p)
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
        """Fail what is queued and stop. On a follower: wait for the
        driver's close to end the engine thread."""
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

    def _next_batch(self) -> list[GenerateRequest] | None:
        """The driver's next batch (None on close), and over a mesh the
        same batch on every rank: the driver broadcasts its rows; the
        followers, which wait in the broadcast meanwhile, run them as
        requests of their own."""
        if not self._spmd:
            return self._take_batch()
        if comm.is_mesh_root(self._mesh):
            batch = self._take_runnable()
            plan = None if batch is None else [
                (r.prompt, r.max_new_tokens, r.temperature, r.top_k, r.top_p)
                for r in batch]
            try:
                comm.broadcast_plan(plan, self._mesh)
            except Exception as exc:  # noqa: BLE001 — fail the batch too
                for req in batch or ():
                    _fail(req, exc)
                raise
            return batch
        plan = comm.broadcast_plan(None, self._mesh)
        return None if plan is None else [GenerateRequest(*row)
                                          for row in plan]

    def _take_runnable(self) -> list[GenerateRequest] | None:
        """``_take_batch``, failing here each batch that ``generate``
        refuses for its length (a batch's rows share their lengths)."""
        while True:  # bounded: each turn takes requests off the queue
            batch = self._take_batch()
            if batch is None:
                return None
            try:
                check_lengths(len(batch[0].prompt), batch[0].max_new_tokens,
                              self.config)
                return batch
            except ValueError as exc:
                for req in batch:
                    _fail(req, exc)

    # the engine thread never differentiates: params a Trainer hands over
    # are leaves that require grad, and under grad mode every op of a
    # tick would record a graph (the KV cache's in-place writes chaining
    # it from tick to tick)
    @torch.no_grad()
    def _scheduler(self) -> None:
        while True:  # pump: scheduler; sentinel batch=None breaks via return
            try:
                batch = self._next_batch()
            except Exception as exc:  # noqa: BLE001 — the mesh failed:
                self._drain(exc)      # nothing more can run
                return
            if batch is None:
                self._drain(RuntimeError("generator closed"))
                return
            failure, out, broken = None, None, False
            try:
                out = self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 — deliver per-request
                failure = exc
            if self._spmd:
                failure, broken = _agree(failure, self._mesh, inside=True)
            for i, req in enumerate(batch):
                if failure is not None:
                    _fail(req, failure)
                elif not req.future.done():
                    req.future.set_result(out[i])
            if broken:
                self._drain(failure)
                return

    def _drain(self, exc: BaseException) -> None:
        """Refuse further submits and fail every straggler with ``exc``
        so callers don't hang."""
        with self._lifecycle:
            self._closed = True
        _release(self._mesh)
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
            _fail(req, exc)

    @staticmethod
    def _bucket_size(n: int) -> int:
        """Smallest power of two >= n."""
        size = 1
        while size < n:
            size *= 2
        return size

    def _run_batch(self, batch: list[GenerateRequest]) -> np.ndarray:
        """Run one batch; its rows' ids, in batch order, on the host."""
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
        max_new = batch[0].max_new_tokens
        use_spec = (
            self.draft is not None
            and all(k <= 0 for k in top_ks)        # no k/p warps
            and all(p >= 1.0 for p in top_ps)
            and not (self.spec_exact_only
                     and uses_flash_decode(self.config, self.device))
            and prompts.shape[1] + max_new + self.spec_k
            <= min(self.config.max_seq_len, self.draft[1].max_seq_len))
        if use_spec:
            out, stats = speculative_generate(
                self.params, self.draft[0], prompts, self.config,
                self.draft[1], max_new, k=self.spec_k, temperature=temps,
                generator=self._rng)
            self.spec_batches += 1
            self.spec_blocks += stats.blocks
            # per-row stats: the real rows, not the power-of-two dummies
            n_real = len(batch)
            self.spec_accepted += int(stats.accepted[:n_real].sum())
            self.spec_drafted += int(stats.drafted[:n_real].sum())
        else:
            out = generate(self.params, prompts, self.config, max_new,
                           temperature=temps, generator=self._rng,
                           top_k=top_ks, top_p=top_ps)
        return out.cpu().numpy()


# ===================================================== continuous batching
@dataclass
class _Slot:
    """Host-side bookkeeping for one engine row."""
    req: GenerateRequest | None = None
    target: int = 0           # tokens to emit for the current request
    prefilling: bool = False  # admission in progress; row not armed yet
    first_unsent: bool = False  # speculative: first token not streamed


@dataclass
class _Admission:
    """Chunked-prefill progress for one slot: the prompt is consumed
    ``prefill_chunk`` tokens per engine iteration into a private
    single-row cache, spliced into the engine state when complete."""
    req: GenerateRequest
    padded: np.ndarray        # (1, n_chunks * chunk) pad-extended prompt
    real_len: int
    row_cache: dict
    consumed: int = 0
    last_logits: torch.Tensor | None = None  # (1, V) at the last real token
    # speculative mode: the draft's own row cache and cursor (prefix-cache
    # hits may advance the two models by different amounts)
    d_row_cache: dict | None = None
    d_consumed: int = 0


@dataclass
class _Plan:
    """One continuous-engine iteration's host decisions: made by the
    driver, applied by every rank of its mesh."""
    # (slot, request) admissions to begin; over the wire (slot, prompt,
    # max_new_tokens, temperature, top_k, top_p)
    admit: list = field(default_factory=list)
    # slots whose admitting or running request was cancelled
    cancel: list = field(default_factory=list)
    waiting: bool = False  # requests wait in the queue: one step a sync
    drain: bool = False    # close(): admit nothing more, finish, stop


def _fail(req: GenerateRequest, exc: BaseException) -> None:
    if not req.future.done():
        req.future.set_exception(exc)


class ContinuousBatchedGenerator:
    """Continuous-batching serving engine: requests join and leave a
    RUNNING batch at token boundaries instead of waiting for a bucket to
    drain (``BatchedGenerator`` runs each batch to completion).

    - A fixed pool of ``n_slots`` rows shares ONE preallocated KV cache and
      one set of per-row state tensors (logits, pos, active, done, out,
      n_out, temperature, top-k, top-p, token target), all on the device
      and updated in place; per-row positions drive the cache writes and
      masks (``decode_step`` with a vector ``pos``), so rows at different
      depths share a step, and the step's flash-decode kernel reads pos on
      the device. Free slots run the step as dummy rows: static shapes.
    - Admission is CHUNKED: the prompt streams through a private
      single-row cache ``prefill_chunk`` tokens per engine iteration
      (``decode_window``), interleaved with decode ticks, then is spliced
      into its slot in place. In-flight decodes stall at most one chunk's
      forward per tick instead of the whole prompt's.
    - Full prompt chunks are PREFIX-CACHED: each fully-real chunk's K/V
      rows are stored (a copy, not a view of the row cache) under the hash
      of the ENTIRE prefix through that chunk, and a new admission copies
      in every leading chunk whose prefix hash hits — LRU-bounded by
      ``prefix_cache_chunks`` entries (0 disables it), exact by
      construction. The final (possibly partial) chunk always computes
      fresh so the splice has real last-token logits.
    - A tick reads ONE packed (n_steps, 4, slots) int32 buffer back to the
      host — [n_out, done, token, emitted] per step — and nothing else;
      the ids of finished rows come back in one more read when a row
      finishes. ``steps_per_sync > 1`` runs that many decode steps per
      readback, dropping to 1 while anything is admitting or queued.
    - Failures: a failed chunk or splice fails that request and leaves its
      slot unarmed (a slot is re-spliced before it serves again); a failed
      tick fails every in-flight request and rebuilds a fresh state.
    - Sampling draws from one ``torch.Generator`` on the engine's device,
      seeded by ``seed``; a tick with no sampling row (the host knows each
      armed row's temperature) samples greedily without it.
    - With a draft model every tick is one speculative block for all rows
      (``propose_and_verify``: k+1 draft ``decode_step``s, one target
      ``decode_window``), each row emitting 1..k+1 tokens; admission
      chunks the prompt through both models (the prefix cache keyed per
      model), the splice draws the row's first token from the prompt's
      last logits, and the tick reads ONE packed (slots, k+6) buffer
      back — [n_out, done, emit_len, n_acc, first, emit_0..emit_k] a
      row, ``first`` streamed with a row's first tick.
    - Over a mesh (sharded params) every rank builds the engine and the
      driver broadcasts each iteration's ``_Plan``. Every rank applies it,
      then agrees on failure before the iteration's first collective: an
      admission that fails on a mesh fails every in-flight request, as a
      failed delivery does (the ranks' states must not part), and a
      failure inside the device work closes the engine on every rank.

    ``submit`` returns a Future resolving to the (max_new_tokens,) int32
    ids (``pad_id`` after an early ``eos_id``); ``on_token`` streams each
    id at the token boundary it was generated on, before the future
    resolves. ``cancel`` frees the slot at the next boundary.
    """

    supports_streaming = True

    def __init__(self, params, config, *, n_slots: int = 8,
                 max_new_cap: int | None = None, seed: int = 0,
                 quantize: bool = False, kv_quant: bool = False,
                 eos_id: int | None = None, pad_id: int = 0,
                 prefill_chunk: int = 256, prefix_cache_chunks: int = 64,
                 steps_per_sync: int = 1, draft_params=None,
                 draft_config=None, spec_k: int = 4,
                 spec_exact_only: bool = True, device="cuda"):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if prefix_cache_chunks < 0:
            raise ValueError(f"prefix_cache_chunks must be >= 0, "
                             f"got {prefix_cache_chunks}")
        if steps_per_sync < 1:
            raise ValueError(f"steps_per_sync must be >= 1, "
                             f"got {steps_per_sync}")
        if steps_per_sync > 1 and draft_params is not None:
            # the speculative tick is already a multi-token block a sync
            raise ValueError("steps_per_sync > 1 is not supported "
                             "together with a draft model")
        _check_draft(draft_params, draft_config, spec_k)
        self.device = _engine_device(params, device)
        self._mesh = getattr(params, "mesh", None)
        self._spmd = _spmd(self._mesh)
        if draft_params is not None and spec_exact_only and \
                uses_flash_decode(config, self.device):
            raise ValueError(
                "speculative verification runs the einsum window "
                "while this config's plain decode would use the "
                "flash kernel; last-bit kernel divergence can flip "
                "a greedy near-tie — pass spec_exact_only=False to "
                "accept that, or use the non-speculative engine")
        self.params = _serving_params(params, config, self.device, quantize)
        self.config = config
        self.draft = _serving_draft(draft_params, draft_config, self._mesh,
                                    self.device)
        self.spec_k = spec_k
        self.n_slots = n_slots
        self.cap = max_new_cap or config.max_seq_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.kv_quant = kv_quant
        self.prefill_chunk = prefill_chunk
        self.steps_per_sync = steps_per_sync
        # full-prefix hash → that chunk's (L, 1, C, ...) K/V rows on the
        # device; OrderedDict insertion order is the LRU order
        self.prefix_cache_chunks = prefix_cache_chunks
        self._prefix_cache: collections.OrderedDict = \
            collections.OrderedDict()
        self._queue: queue.Queue = queue.Queue()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._admitting: dict[int, _Admission] = {}
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._rows = torch.arange(n_slots, device=self.device)
        self._closed = False
        self._lifecycle = threading.Lock()  # submit/close atomicity
        # requests_total counts SUBMISSIONS (like BatchedGenerator's)
        self.requests_total = 0
        self.admitted_total = 0
        self.admitted_while_running = 0
        self.steps_total = 0
        self.prefill_chunks_total = 0
        self.prefix_cache_hits_total = 0   # chunks SKIPPED via the cache
        self.cancelled_total = 0
        self.spec_ticks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._state = self._fresh_state()
        self._dstate = self._fresh_draft_state()
        _claim(self._mesh)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kubeflow-tpu-torch-cbatch")
        self._thread.start()

    def _fresh_state(self) -> dict:
        """A zeroed engine state: built at construction and again after a
        failed tick (which may have left it half-updated)."""
        n, dev, c = self.n_slots, self.device, self.config

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        # a speculative block writes k+1 cells from a row's cursor, masked
        # past its budget: the overhang keeps every cell index in range
        overhang = 0 if self.draft is None else self.spec_k + 1
        return {
            "cache": init_kv_cache(c, n, kv_quant=self.kv_quant, device=dev,
                                   mesh=self._mesh),
            "logits": zeros(n, c.vocab_size, dtype=torch.float32),
            "pos": zeros(n, dtype=torch.int32),
            "active": zeros(n, dtype=torch.bool),
            "done": zeros(n, dtype=torch.bool),
            "out": zeros(n, self.cap + overhang, dtype=torch.int32),
            "n_out": zeros(n, dtype=torch.int32),
            "temp": zeros(n, dtype=torch.float32),
            "top_k": zeros(n, dtype=torch.int32),
            "top_p": torch.ones(n, dtype=torch.float32, device=dev),
            "target": zeros(n, dtype=torch.int32),
            # speculative mode: the newest emitted token not yet consumed
            # and its position
            "last": zeros(n, dtype=torch.int32),
            "lpos": zeros(n, dtype=torch.int32),
        }

    def _fresh_draft_state(self) -> dict | None:
        """The draft model's full-precision KV cache for every slot."""
        if self.draft is None:
            return None
        return {"cache": init_kv_cache(self.draft[1], self.n_slots,
                                       device=self.device,
                                       mesh=self._draft_mesh())}

    def _draft_mesh(self):
        return getattr(self.draft[0], "mesh", None)

    # ----------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, *,
               on_token=None) -> Future:
        _refuse_follower(self._mesh)
        if max_new_tokens > self.cap:
            raise ValueError(f"max_new_tokens {max_new_tokens} exceeds "
                             f"engine cap {self.cap}")
        req = GenerateRequest(np.asarray(prompt, np.int32), max_new_tokens,
                              temperature, top_k, top_p, on_token=on_token)
        if len(req.prompt) == 0:
            raise ValueError("prompt must be non-empty")
        if len(req.prompt) + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if self.draft is not None:
            if top_k > 0 or top_p < 1.0:
                raise ValueError("the speculative engine has no "
                                 "top-k/top-p warps (both distributions "
                                 "would need the warp before the ratio "
                                 "test); use the plain engine")
            # the verify window may overhang the frontier by up to k
            # rejected rows before they are overwritten
            limit = min(self.config.max_seq_len, self.draft[1].max_seq_len)
            if len(req.prompt) + max_new_tokens + self.spec_k > limit:
                raise ValueError(
                    f"prompt + max_new_tokens + spec_k exceeds "
                    f"max_seq_len {limit}")
        req.future._kubeflow_tpu_request = req   # cancel() handle
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("generator is closed")
            self.requests_total += 1
            self._queue.put(req)
        return req.future

    def cancel(self, future: Future) -> bool:
        """Request cooperative cancellation of a submitted generation (a
        disconnected streaming client, an abandoned request): the engine
        frees the slot at the next token boundary — queued or admitting
        requests never run — and the future fails with CancelledError.
        Returns False for futures this engine did not issue or that have
        already resolved."""
        req = getattr(future, "_kubeflow_tpu_request", None)
        if req is None or future.done():
            return False
        req.cancelled.set()
        return True

    def generate_sync(self, prompt, max_new_tokens: int,
                      temperature: float = 0.0, *, top_k: int = 0,
                      top_p: float = 1.0, timeout: float = 120.0):
        return self.submit(prompt, max_new_tokens, temperature, top_k,
                           top_p).result(timeout=timeout)

    def close(self) -> None:
        """Finish what is running or admitting, fail what is queued. On a
        follower: wait for the driver's close to end the engine thread."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel AFTER the last possible submit
        self._thread.join(timeout=30)

    def __enter__(self) -> "ContinuousBatchedGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- device work
    def _chunk(self, adm: _Admission, start: int,
               draft: bool = False) -> torch.Tensor:
        """Consume one prompt chunk into the admission's private
        (L, 1, S, ...) row cache (the draft's with ``draft``); the (1, V)
        logits at its last REAL token (padding beyond it writes K/V the
        decode frontier overwrites before anything reads them)."""
        C = self.prefill_chunk
        tokens = torch.from_numpy(adm.padded[:, start:start + C]).to(
            self.device)
        params, config, cache = (
            (self.draft[0], self.draft[1], adm.d_row_cache) if draft
            else (self.params, self.config, adm.row_cache))
        logits, _ = decode_window(params, cache, tokens, start, config)
        return logits[:, min(adm.real_len - 1 - start, C - 1)].clone()

    def _splice(self, adm: _Admission, slot: int) -> None:
        """Install a completed admission into ``slot`` in place: its row of
        the engine cache, then the row's fields, armed last — a splice
        that fails part-way leaves the row unarmed."""
        st, req = self._state, adm.req
        for name, buf in adm.row_cache.items():
            st["cache"][name][:, slot].copy_(buf[:, 0])
        st["logits"][slot].copy_(adm.last_logits[0])
        st["pos"][slot] = adm.real_len
        st["done"][slot] = False
        st["n_out"][slot] = 0
        st["out"][slot] = 0
        st["temp"][slot] = req.temperature
        st["top_k"][slot] = req.top_k
        st["top_p"][slot] = req.top_p
        st["target"][slot] = req.max_new_tokens
        st["active"][slot] = True

    def _tick(self, n_steps: int, sampling: bool) -> torch.Tensor:
        """``n_steps`` engine steps on the device; returns the packed
        (n_steps, 4, slots) int32 flags [n_out, done, token, emitted]
        without reading anything back. Per step a row EMITS iff it is
        armed, not EOS-done and under its token budget; a row that stops
        emitting keeps its carried logits and frozen pos (its cache write
        lands at that pos, or is dropped at max_seq_len, and is never
        read: the slot is re-spliced before it serves again)."""
        st = self._state
        generator = self._rng if sampling else None
        last_col = st["out"].shape[1] - 1
        flags = []
        for _ in range(n_steps):
            emit = st["active"] & ~st["done"] & (st["n_out"] < st["target"])
            token = sample_token(st["logits"], generator, st["temp"],
                                 st["top_k"], st["top_p"])
            token = torch.where(emit, token, self.pad_id)
            col = st["n_out"].clamp(max=last_col).long()
            st["out"][self._rows, col] = torch.where(
                emit, token, st["out"][self._rows, col])
            st["n_out"] += emit
            if self.eos_id is not None:
                st["done"] |= emit & (token == self.eos_id)
            logits, _ = decode_step(self.params, st["cache"], token,
                                    st["pos"], self.config)
            st["logits"].copy_(torch.where(emit[:, None], logits,
                                           st["logits"]))
            st["pos"] += emit
            flags.append(torch.stack([st["n_out"], st["done"].int(), token,
                                      emit.int()]))
        return torch.stack(flags)

    def _spec_splice(self, adm: _Admission, slot: int) -> None:
        """Speculative-mode install, in place: both models' row caches,
        then the row's fields with its first token (drawn from the
        prompt's last logits: the tick consumes ``last``, it carries no
        logits), armed last."""
        st, req = self._state, adm.req
        for cache, rows in ((self._dstate["cache"], adm.d_row_cache),
                            (st["cache"], adm.row_cache)):
            for name, buf in rows.items():
                cache[name][:, slot].copy_(buf[:, 0])
        logits = adm.last_logits[0]
        first = torch.argmax(logits).to(torch.int32)
        if req.temperature > 0:
            first = _categorical(_scaled_probs(
                logits, torch.full((), req.temperature,
                                   device=self.device)), self._rng)
        st["done"][slot] = (first == self.eos_id) if self.eos_id is not None \
            else False
        st["n_out"][slot] = 1
        st["out"][slot] = 0
        st["out"][slot, 0] = first
        st["temp"][slot] = req.temperature
        st["target"][slot] = req.max_new_tokens
        st["last"][slot] = first
        st["lpos"][slot] = adm.real_len
        st["active"][slot] = True

    def _spec_tick(self, sampling: bool) -> torch.Tensor:
        """One speculative block for every row on the device; returns the
        packed (slots, k+6) int32 flags [n_out, done, emit_len, n_acc,
        first, emit_0..emit_k] without reading anything back (``first``
        is the row's splice-drawn first token, streamed with the row's
        first tick). A row emits the accepted drafts and the closing
        token, clamped to its budget and cut after its first EOS; a row
        that does not emit keeps its ``last``/``lpos`` (the block's cache
        writes past its frontier are overwritten or never read)."""
        st = self._state
        alive = st["active"] & ~st["done"] & (st["n_out"] < st["target"])
        _, _, drafts, n_acc, tail = propose_and_verify(
            self.params, self.draft[0], st["cache"], self._dstate["cache"],
            st["last"], st["lpos"], st["temp"],
            self._rng if sampling else None, self.config, self.draft[1],
            self.spec_k)
        emit, emit_len = emit_block(st["out"], st["n_out"], st["last"],
                                    st["done"], drafts, n_acc, tail, alive,
                                    st["target"], self.eos_id)
        st["lpos"] += emit_len
        return torch.cat([st["n_out"][:, None], st["done"].int()[:, None],
                          emit_len[:, None],
                          torch.where(alive, n_acc, 0)[:, None],
                          st["out"][:, :1], emit], dim=1)

    # -------------------------------------------------------------- engine
    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.req is None]

    def _armed(self) -> list[_Slot]:
        return [s for s in self._slots
                if s.req is not None and not s.prefilling]

    @staticmethod
    def _prefix_key(prompt: np.ndarray, upto: int,
                    draft: bool = False) -> tuple:
        # keyed per model: a draft's chunk rows live in the same LRU (its
        # K/V differ from the target's)
        return draft, upto, hashlib.sha1(prompt[:upto].tobytes()).digest()

    def _cacheable_chunks(self, real_len: int) -> int:
        """How many leading chunks of a prompt are prefix-cacheable:
        fully real AND not the final chunk (the final chunk always
        computes fresh so the splice has genuine last-token logits)."""
        C = self.prefill_chunk
        n_chunks = max(1, -(-real_len // C))
        return min(real_len // C, n_chunks - 1)

    def _begin_admission(self, req: GenerateRequest, slot: int) -> None:
        """Stage a chunked admission: private row cache + pad-extended
        prompt; leading chunks whose full-prefix hash is cached are copied
        in; _advance_admissions consumes the rest a chunk at a time."""
        C = self.prefill_chunk
        real_len = len(req.prompt)
        n_chunks = max(1, -(-real_len // C))
        padded = np.full((1, n_chunks * C), self.pad_id, np.int32)
        padded[0, :real_len] = req.prompt
        adm = _Admission(req=req, padded=padded, real_len=real_len,
                         row_cache=init_kv_cache(self.config, 1,
                                                 kv_quant=self.kv_quant,
                                                 device=self.device,
                                                 mesh=self._mesh))
        adm.consumed = self._take_prefix_hits(req, adm.row_cache, False)
        if self.draft is not None:
            adm.d_row_cache = init_kv_cache(self.draft[1], 1,
                                            device=self.device,
                                            mesh=self._draft_mesh())
            adm.d_consumed = self._take_prefix_hits(req, adm.d_row_cache,
                                                    True)
        self._admitting[slot] = adm
        self._slots[slot] = _Slot(req=req, target=req.max_new_tokens,
                                  prefilling=True)

    def _take_prefix_hits(self, req: GenerateRequest, row_cache: dict,
                          draft: bool) -> int:
        """Copy every leading chunk whose full-prefix hash the target (the
        draft with ``draft``) has cached into ``row_cache``; returns the
        tokens they cover."""
        C = self.prefill_chunk
        consumed = 0
        if self.prefix_cache_chunks:
            for c in range(self._cacheable_chunks(len(req.prompt))):
                key = self._prefix_key(req.prompt, (c + 1) * C, draft)
                rows = self._prefix_cache.get(key)
                if rows is None:
                    break
                self._prefix_cache.move_to_end(key)  # LRU refresh
                for name, buf in row_cache.items():
                    buf[:, :, c * C:(c + 1) * C].copy_(rows[name])
                consumed += C
                self.prefix_cache_hits_total += 1
        return consumed

    def _store_prefix(self, adm: _Admission, start: int,
                      draft: bool = False) -> None:
        """Cache rows [start, start + C) of the admission's target row
        cache (the draft's with ``draft``; a copy: a view would keep the
        whole row cache alive)."""
        C = self.prefill_chunk
        key = self._prefix_key(adm.req.prompt, start + C, draft)
        row_cache = adm.d_row_cache if draft else adm.row_cache
        self._prefix_cache[key] = {
            name: buf[:, :, start:start + C].clone()
            for name, buf in row_cache.items()}
        self._prefix_cache.move_to_end(key)
        while len(self._prefix_cache) > self.prefix_cache_chunks:
            self._prefix_cache.popitem(last=False)

    def _advance_admissions(self) -> None:
        """One prompt chunk per admitting slot, then (when a prompt
        completes) the splice that arms its row. Interleaved with decode
        ticks by the loop."""
        C = self.prefill_chunk
        for slot, adm in list(self._admitting.items()):
            req = adm.req
            width = adm.padded.shape[1]
            spec = adm.d_row_cache is not None
            try:
                if adm.consumed < width:
                    adm.last_logits = self._consume(adm, adm.consumed,
                                                    False)
                    adm.consumed += C
                if spec and adm.d_consumed < width:
                    self._consume(adm, adm.d_consumed, True)
                    adm.d_consumed += C
                if adm.consumed < width or (spec and adm.d_consumed < width):
                    continue
                if spec:
                    self._spec_splice(adm, slot)
                else:
                    self._splice(adm, slot)
            except Exception as exc:  # noqa: BLE001 — fail THIS request;
                # other admissions and the running batch continue (a
                # failed splice leaves the row unarmed); on a mesh the
                # whole iteration fails, on every rank
                if self._spmd:
                    raise
                del self._admitting[slot]
                self._slots[slot] = _Slot()
                _fail(req, exc)
                continue
            del self._admitting[slot]
            self._slots[slot].prefilling = False
            # the first token is an emitted token: the next tick's flags
            # carry it to the stream
            self._slots[slot].first_unsent = spec
            self.admitted_total += 1
            if len(self._armed()) > 1:
                self.admitted_while_running += 1

    def _consume(self, adm: _Admission, start: int,
                 draft: bool) -> torch.Tensor:
        """One chunk of the admission through the target (the draft with
        ``draft``), stored in the prefix cache when cacheable; the chunk's
        last-real-token logits."""
        C = self.prefill_chunk
        logits = self._chunk(adm, start, draft)
        self.prefill_chunks_total += 1
        if self.prefix_cache_chunks and \
                start // C < self._cacheable_chunks(adm.real_len):
            try:
                self._store_prefix(adm, start, draft)
            except RuntimeError:
                # caching is an optimization: failing to allocate an
                # entry must not fail a request whose prefill succeeded
                # (on a mesh it must: the ranks' caches would part)
                if self._spmd:
                    raise
        return logits

    def _fail_all_and_rearm(self, exc: BaseException,
                            extra=()) -> None:
        """A tick failed part-way through its in-place updates: fail every
        in-flight request (and those of ``extra``) and rebuild the state
        from zero (the engine keeps serving)."""
        # rebuild first, fail after: a caller woken by its future reads
        # the engine's state, which must already be the fresh one (and
        # the requests fail even if the rebuild raises)
        failed = list(extra) + [s.req for s in self._slots
                                if s.req is not None]
        try:
            for i in range(len(self._slots)):
                self._slots[i] = _Slot()
            self._admitting.clear()
            self._state = self._fresh_state()
            self._dstate = self._fresh_draft_state()
        finally:
            for req in failed:
                _fail(req, exc)

    def _emit_tokens(self, ids: np.ndarray, emitted: np.ndarray) -> None:
        """Deliver one step's ids (already on the host in the packed
        flags) to streaming requests. A raising callback loses its own
        stream, never the engine. ``emitted`` is the step's per-row emit
        mask: a row frozen mid-sync (EOS, budget) samples only pad
        filler afterwards, which must not reach the stream."""
        for i, slot in enumerate(self._slots):
            if emitted[i] and slot.req is not None \
                    and not slot.prefilling \
                    and slot.req.on_token is not None:
                try:
                    slot.req.on_token(int(ids[i]))
                except Exception:  # noqa: BLE001 — the consumer's bug
                    slot.req.on_token = None

    def _collect_finished(self, n_out: np.ndarray,
                          done: np.ndarray) -> None:
        finished = [i for i, slot in enumerate(self._slots)
                    if slot.req is not None and not slot.prefilling
                    and (n_out[i] >= slot.target or done[i])]
        if not finished:
            return
        out = self._state["out"].cpu().numpy()
        for i in finished:
            slot = self._slots[i]
            ids = out[i, :slot.target].copy()
            ids[int(n_out[i]):] = self.pad_id   # EOS'd early: pad
            # free the slot before resolving: the caller the future wakes
            # may read the engine's state at once
            self._slots[i] = _Slot()
            self._state["active"][i] = False
            if not slot.req.future.done():
                slot.req.future.set_result(ids)

    # ---------------------------------------------------------------- plans
    def _make_plan(self, draining: bool, block: bool) -> _Plan:
        """The driver's decisions for one iteration: the cancelled slots,
        then as many queued arrivals as there are free slots (waiting for
        one with ``block``: when fully idle, nothing decoding or
        admitting)."""
        plan = _Plan(drain=draining)
        plan.cancel = [i for i, s in enumerate(self._slots)
                       if s.req is not None and s.req.cancelled.is_set()]
        free = self._free_slots()
        while not plan.drain and free:
            try:
                req = self._queue.get(block=block)
            except queue.Empty:
                break
            block = False
            if req is None:
                # close(): finish what is running and admitting (those
                # requests were accepted), admit nothing new
                plan.drain = True
                break
            if req.cancelled.is_set():  # cancelled while queued
                self.cancelled_total += 1
                _fail(req, CancelledError())
                continue
            plan.admit.append((free.pop(0), req))
        plan.waiting = not self._queue.empty()
        return plan

    def _exchange(self, plan: _Plan | None) -> _Plan:
        """The driver's plan on every rank of the mesh (as it is off a
        mesh): the admissions travel as their request fields, and each
        follower admits requests of its own that nobody reads."""
        if not self._spmd:
            return plan
        if plan is not None:
            comm.broadcast_plan(dataclasses.replace(plan, admit=[
                (slot, r.prompt, r.max_new_tokens, r.temperature, r.top_k,
                 r.top_p) for slot, r in plan.admit]), self._mesh)
            return plan
        wire = comm.broadcast_plan(None, self._mesh)
        return dataclasses.replace(wire, admit=[
            (slot, GenerateRequest(*fields)) for slot, *fields in wire.admit])

    def _apply(self, plan: _Plan) -> None:
        """Free the cancelled slots, then begin the plan's admissions."""
        for slot in plan.cancel:
            req = self._slots[slot].req
            self._admitting.pop(slot, None)
            self._slots[slot] = _Slot()
            self._state["active"][slot] = False
            # count before resolving: the woken caller may read the count
            self.cancelled_total += 1
            _fail(req, CancelledError())
        for slot, req in plan.admit:
            try:
                self._begin_admission(req, slot)
            except Exception as exc:  # noqa: BLE001 — this request (on a
                if self._spmd:               # mesh: every rank's)
                    raise
                _fail(req, exc)

    @torch.no_grad()  # as _scheduler's: the engine never differentiates
    def _loop(self) -> None:
        driver = comm.is_mesh_root(self._mesh)
        draining = False
        while True:  # pump: decode loop; exits when draining and slots idle
            # the driver blocks for work only when fully idle (nothing
            # decoding or admitting); its followers wait in the exchange
            block = not draining and not self._armed() and not self._admitting
            plan = self._make_plan(draining, block) if driver else None
            try:
                plan = self._exchange(plan)
            except Exception as exc:  # noqa: BLE001 — the mesh failed:
                # nothing more can run; the plan's arrivals fail too
                self._fail_all_and_rearm(exc, [] if plan is None else
                                         [r for _, r in plan.admit])
                self._shutdown(exc)
                return
            draining = draining or plan.drain
            failure, broken = self._iterate(plan)
            if failure is not None:
                self._fail_all_and_rearm(failure,
                                         [r for _, r in plan.admit])
                if broken:
                    self._shutdown(failure)
                    return
            if draining and not self._armed() and not self._admitting:
                self._shutdown()
                return

    def _iterate(self, plan: _Plan) -> tuple[BaseException | None, bool]:
        """Apply ``plan``, then run the iteration's device work and deliver
        what it made. Returns the failure as every rank sees it, and
        whether it came inside the device work on some rank."""
        failure, broken = None, False
        try:
            self._apply(plan)  # host work: no collective
        except Exception as exc:  # noqa: BLE001 — fail the batch
            failure = exc
        if self._spmd:
            # agreed before any rank enters the iteration's first collective
            failure, broken = _agree(failure, self._mesh)
        if failure is not None:
            return failure, broken
        inside = True
        try:
            host, steps = self._device_work(plan)
            inside = False
            if host is not None:
                self._deliver(host, steps)
        except Exception as exc:  # noqa: BLE001 — fail the batch
            failure = exc
        if self._spmd:
            return _agree(failure, self._mesh, inside)
        return failure, False

    def _device_work(self, plan: _Plan) -> tuple[np.ndarray | None, int]:
        """Every collective of the iteration: the admissions' next chunks
        and, when any row is armed, the tick, read back. Returns the host
        flags (None when nothing is armed) and the tick's steps."""
        self._advance_admissions()
        armed = self._armed()
        if not armed:
            return None, 0
        sampling = any(s.req.temperature > 0 for s in armed)
        if self.draft is not None:
            # the tick's one readback
            return self._spec_tick(sampling).cpu().numpy(), 1
        # multi-step sync amortizes the readback over `steps` tokens, but
        # drops to one step while anything admits or waits, so it never
        # costs admission latency
        steps = self.steps_per_sync
        if self._admitting or plan.waiting:
            steps = 1
        return self._tick(steps, sampling).cpu().numpy(), steps

    def _deliver(self, host: np.ndarray, steps: int) -> None:
        """A tick's tokens to their streams, then its finished requests to
        their futures (every token is delivered before the request's
        future resolves)."""
        self.steps_total += steps
        if self.draft is not None:
            self.spec_ticks += 1
            moved = host[:, 2] > 0
            self.spec_drafted += int(moved.sum()) * self.spec_k
            self.spec_accepted += int(host[moved, 3].sum())
            self._emit_spec_tokens(host)
            self._collect_finished(host[:, 0], host[:, 1] != 0)
            return
        for s in range(host.shape[0]):
            self._emit_tokens(host[s, 2], host[s, 3] != 0)
        self._collect_finished(host[-1, 0], host[-1, 1] != 0)

    def _emit_spec_tokens(self, host: np.ndarray) -> None:
        """A speculative tick's streaming: each row emitted 0..k+1 tokens,
        delivered in order after the row's first token on its first tick
        (the packed flags carry them inline)."""
        for i, slot in enumerate(self._slots):
            if slot.req is None or slot.prefilling \
                    or slot.req.on_token is None:
                continue
            burst = host[i, 5:5 + int(host[i, 2])]
            if slot.first_unsent:
                slot.first_unsent = False
                burst = np.concatenate([host[i, 4:5], burst])
            for tok in burst:
                try:
                    slot.req.on_token(int(tok))
                except Exception:  # noqa: BLE001 — the consumer's bug
                    slot.req.on_token = None
                    break

    def _shutdown(self, exc: BaseException | None = None) -> None:
        """Refuse further submits and fail what is left with ``exc``
        (default: the generator is closed)."""
        with self._lifecycle:
            self._closed = True
        _release(self._mesh)
        stragglers = [s.req for s in self._slots if s.req is not None]
        while True:  # bounded: drains queue until Empty
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                stragglers.append(req)
        for req in stragglers:
            _fail(req, exc or RuntimeError("generator closed"))
