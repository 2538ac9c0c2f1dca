"""Host-side input pipeline: batch sources + device prefetch.

Port of ``kubeflow_tpu/runtime/data.py``. The batch sources are numpy
only and are the JAX package's, copied (the port imports nothing of it):
for the same seed and file they give the same batches bit for bit.
``prefetch_to_device`` stages the next batches onto the device from a
background thread, so the host-to-device copy of batch N+1 overlaps the
step on batch N; with a mesh each rank stages only its slice of each
batch (``shard_batch``; on a pp mesh laid out for the pipeline's
microbatches).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..parallel import comm
from ..parallel.sharding import PartitionRules, batch_sharding, shard_tensor


def synthetic_lm_batches(batch_size: int, seq_len: int, vocab_size: int,
                         *, n_batches: int | None = None,
                         seed: int = 0) -> Iterator[tuple]:
    """Deterministic synthetic (tokens, targets) stream for benchmarks and
    tests — targets are tokens shifted left (next-token prediction)."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        tokens = rng.integers(0, vocab_size, (batch_size, seq_len),
                              dtype=np.int32)
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = -1  # padding target for the shifted-off position
        yield tokens, targets
        i += 1


def write_token_file(path, tokens: np.ndarray) -> None:
    """Write a flat int32 token stream in the loader's on-disk format (raw
    little-endian int32, no header)."""
    np.asarray(tokens, dtype="<i4").ravel().tofile(path)


def token_file_batches(path, batch_size: int, seq_len: int, *,
                       n_epochs: int | None = 1, seed: int | None = 0,
                       doc_sep: int | None = None) -> Iterator[tuple]:
    """Packed-sequence batches from a raw int32 token file via
    ``np.memmap``: each batch slices seq_len+1 windows (the +1 provides
    the shifted target) straight off the mapping.

    - windows are non-overlapping and epoch-shuffled when ``seed`` is set
      (None = sequential order);
    - ``doc_sep``: positions holding this token id get target -1 (no
      prediction across document boundaries);
    - ``n_epochs=None`` streams forever.
    """
    data = np.memmap(path, dtype="<i4", mode="r")
    window = seq_len + 1
    n_windows = (len(data) - 1) // seq_len
    if n_windows < batch_size:
        raise ValueError(
            f"{path}: {len(data)} tokens give {n_windows} {window}-token "
            f"windows < batch_size {batch_size} — the loader would yield "
            f"nothing (or spin forever with n_epochs=None)")
    rng = np.random.default_rng(seed) if seed is not None else None
    epoch = 0
    while n_epochs is None or epoch < n_epochs:
        order = np.arange(n_windows)
        if rng is not None:
            rng.shuffle(order)
        for start in range(0, n_windows - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            rows = np.stack([data[i * seq_len:i * seq_len + window]
                             for i in idx]).astype(np.int32)
            tokens, targets = rows[:, :-1], rows[:, 1:].copy()
            if doc_sep is not None:
                targets[targets == doc_sep] = -1
            yield tokens, targets
        epoch += 1


def tokenize_corpus(text_path, tokenizer, out_path, *,
                    doc_sep: int | None = None,
                    encoding: str = "utf-8") -> int:
    """Tokenize a text file into the raw int32 token-file format
    ``token_file_batches`` reads. Documents are blank-line-separated
    paragraphs; with ``doc_sep`` set, that id is written between
    documents. Streamed paragraph by paragraph; returns the token count.
    ``tokenizer``: anything with ``encode(text, add_special_tokens=False)
    -> ids``."""
    n = 0
    with open(text_path, encoding=encoding) as fh, \
            open(out_path, "wb") as out:
        for is_blank, lines in itertools.groupby(
                fh, key=lambda ln: not ln.strip()):
            if is_blank:
                continue
            text = " ".join(ln.strip() for ln in lines)
            ids = tokenizer.encode(text, add_special_tokens=False)
            if not ids:
                continue
            arr = np.asarray(ids, dtype="<i4")
            if doc_sep is not None:
                if doc_sep in arr:
                    # the loader would mask real mid-document targets
                    raise ValueError(
                        f"tokenizer emitted doc_sep id {doc_sep} inside "
                        f"a document; pick an id outside its vocab")
                if n:
                    out.write(np.asarray([doc_sep], dtype="<i4").tobytes())
                    n += 1
            out.write(arr.tobytes())
            n += len(arr)
    return n


def shard_batch(x, mesh, rules: PartitionRules | None = None,
                n_microbatches: int | None = None):
    """This rank's slice of a (batch, seq) array, or of an (accum, batch,
    seq) one: rows over the batch axes (dp, fsdp), the sequence block over
    sp. A numpy array gives a numpy array, a tensor a tensor.

    On a mesh with pp > 1 the rows are laid out for the pipeline's
    ``n_microbatches`` (default 2·pp, the sharded steps' default):
    microbatch m is the global rows [m·mb, (m+1)·mb), as in the
    reference, so a rank takes its share of each microbatch in turn, and
    its local microbatch m is its share of the global one (MoE routing
    groups, which are global, depend on it). Elsewhere a rank's rows are
    one contiguous block."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    pp = comm.axis_size(mesh, "pp")
    if pp > 1:
        m = n_microbatches or 2 * pp
        lead = t.shape[:-2]
        B = t.shape[-2]
        if B % m:
            raise ValueError(f"batch {B} not divisible by {m} microbatches")
        micro = t.reshape(*lead, m, B // m, t.shape[-1])
        spec = (None,) * (len(lead) + 1) + \
            (rules or PartitionRules()).spec("batch", "seq")
        local = shard_tensor(micro, spec, mesh)
        local = local.reshape(*lead, -1, local.shape[-1])
    else:
        local = batch_sharding(mesh, accum=x.ndim == 3, rules=rules).shard(t)
    return local if isinstance(x, torch.Tensor) else local.numpy()


class _Stop:
    pass


_STOP = _Stop()


def _stage(batch, device: torch.device, stream) -> tuple:
    """(the batch as tensors on ``device``, the event its copies recorded
    or None on the CPU)."""
    if device.type != "cuda":
        return tuple(torch.from_numpy(np.array(x)) for x in batch), None
    # Stream hazard: the copies run on a side stream so that they overlap
    # the step on the compute stream. The consumer makes its stream wait
    # on the event recorded after the copies (wait_event), and marks each
    # tensor as used by its stream (record_stream), so the allocator does
    # not hand the side stream's memory out again while the step still
    # reads it.
    with torch.cuda.stream(stream):
        out = tuple(torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                    .to(device, non_blocking=True) for x in batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def prefetch_to_device(source: Iterable, device="cuda",
                       buffer_size: int = 2, mesh=None) -> Iterator:
    """Iterate ``source`` (tuples of numpy arrays) with each batch staged
    onto ``device`` ahead of consumption, as a tuple of tensors; with a
    ``mesh``, this rank's slice of each array (``shard_batch``).

    A background thread keeps ``buffer_size`` batches in flight. Errors
    in the source propagate to the consumer; the thread exits when the
    source ends, the consumer stops iterating or closes, or an error
    occurs."""
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    buf: queue.Queue = queue.Queue(maxsize=buffer_size)
    done = threading.Event()

    def put(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not done.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for batch in source:
                if mesh is not None:
                    batch = tuple(shard_batch(x, mesh) for x in batch)
                if not put(_stage(batch, dev, stream)):
                    return
        except BaseException as exc:  # noqa: BLE001 — hand to the consumer
            put(exc)
            return
        put(_STOP)

    thread = threading.Thread(target=producer, daemon=True,
                              name="kubeflow-tpu-torch-prefetch")
    thread.start()

    class _PrefetchIterator:
        def __iter__(self):
            return self

        def __next__(self):
            item = buf.get()
            if isinstance(item, _Stop):
                done.set()
                raise StopIteration
            if isinstance(item, BaseException):
                done.set()
                raise item
            batch, event = item
            if event is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(event)
                for t in batch:
                    t.record_stream(compute)
            return batch

        def close(self) -> None:
            done.set()
            # unblock a producer waiting on a full queue
            while True:  # bounded: drains the buffer until Empty
                try:
                    buf.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)

        def __enter__(self):
            return self

        def __exit__(self, *exc) -> None:
            self.close()

    return _PrefetchIterator()
