"""The flagship train step's host wall time, and what the host does in it.

    python3 -m kubeflow_tpu_torch.tools.train_step_time

Holds the flagship configuration (``FLAGSHIP``) and the MoE family at
its width (``FLAGSHIP_MOE``) that chip_smoke.py and the tools share, and
the measurement of its train step that chip_smoke.py's phase 7 takes too
(``timed_fit``, ``host_us_per_call``).

Alone, it trains the flagship (random weights from seed 0) through
``Trainer`` at b8 x s1024 with bf16 params and f32 masters: 2 warm-up
steps, then three timed runs of 10 steps, each a host clock around
``fit`` from one ``torch.cuda.synchronize()`` to the next, beside the CPU
time the process took in it, the caching allocator's calls to the device
and Python's garbage collections. Then the host's cost of one call of each
attention wrapper at the step's shape and of the decode wrapper at the
served shape, with one elementwise op for scale. Nothing runs before the
step, as the serving phases do in chip_smoke.py. Two checkouts compare by
running this file with each one's package first on the path, in turns
(the file uses only what both have):

    PYTHONPATH=<checkout> python3 <this file>

Prints the card's name and power limit, one line per run, then one JSON
record. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import resource
import statistics
import subprocess
import sys
import threading
import time

import torch

from kubeflow_tpu_torch.models import train as train_lib
from kubeflow_tpu_torch.models.moe import MoEConfig
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
from kubeflow_tpu_torch.runtime.trainer import Trainer

# the JAX package's flagship (``__graft_entry__._flagship_config``)
FLAGSHIP = TransformerConfig(vocab_size=32_000, d_model=1024, n_layers=12,
                             n_heads=8, n_kv_heads=4, d_ff=4096,
                             max_seq_len=1024)
# the MoE family at the flagship's width with MoEConfig's own defaults
# (8 experts, top-2, capacity factor 1.25, route groups of 2048): ~1.31B
# params, ~405M active a token
FLAGSHIP_MOE = MoEConfig(**dataclasses.asdict(FLAGSHIP))
BATCH, SEQ = 8, 1024
_ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries",
              "num_sync_all_streams")


def _host_counters() -> list:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    mem = torch.cuda.memory_stats()
    return [ru.ru_utime + ru.ru_stime,
            *(mem.get(key) for key in _ALLOCATOR)]


def timed_fit(trainer, source, steps: int) -> dict:
    """``steps`` steps of ``trainer.fit`` from a synchronised start to a
    synchronised end: host wall per step; CPU time (user + system, every
    thread) the process took per step; the caching allocator's cudaMalloc
    and cudaFree calls, failed cudaMallocs and synchronise-and-free passes
    (None where this torch does not count them); Python's cyclic garbage
    collections
    by generation and the ms a step they took, beside the objects the
    collector tracked and the threads alive at the start."""
    gc_runs, gc_s, started = [0, 0, 0], [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - started[0]
            gc_runs[info["generation"]] += 1

    tracked, threads = len(gc.get_objects()), threading.active_count()
    torch.cuda.synchronize()
    before = _host_counters()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.monotonic()
        trainer.fit(source, steps=steps, log_every=10 ** 9)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        gc.callbacks.remove(on_gc)
    d = [None if a is None or b is None else a - b
         for a, b in zip(_host_counters(), before)]
    return {"ms_per_step": wall / steps * 1e3,
            "cpu_ms_per_step": d[0] / steps * 1e3,
            **dict(zip(_ALLOCATOR, d[1:])),
            "gc_collections_by_generation": gc_runs,
            "gc_ms_per_step": gc_s[0] / steps * 1e3,
            "gc_tracked_objects": tracked, "threads": threads}


def host_us_per_call(n: int = 50) -> dict:
    """Host microseconds per call of each attention wrapper of the train
    step at its shape (b8 s1024 h8 d128 bf16 causal: the forward with lse,
    dK/dV and dQ on prepared inputs), of the decode wrapper at the served
    shape (B8 S1024 G4 rep2 D128, pos 159), and of one elementwise op:
    ``n`` calls back to back behind a busy-wait kernel, so the card never
    holds the host back. The launches count as any call's."""
    from kubeflow_tpu_torch.ops import attention as attn
    from kubeflow_tpu_torch.ops.decode_attention import \
        flash_decode_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, do = (randn(BATCH, SEQ, 8, 128) for _ in range(4))
    o, lse = attn.flash_attention_cuda(q, k, v, True, return_lse=True)
    prepared = attn.prepare_bwd_inputs(q, k, v, o, lse, do)
    qd, kc, vc = randn(8, 4, 2, 128), randn(8, 1024, 4, 128), \
        randn(8, 1024, 4, 128)
    pos = torch.full((8,), 159, dtype=torch.int32, device="cuda")
    x = torch.zeros(1024, device="cuda")
    calls = {
        "flash_attention": lambda: attn.flash_attention_cuda(
            q, k, v, True, return_lse=True),
        "flash_attention_bwd_dkv": lambda: attn.flash_attention_bwd_dkv_cuda(
            *prepared),
        "flash_attention_bwd_dq": lambda: attn.flash_attention_bwd_dq_cuda(
            *prepared),
        "flash_decode": lambda: flash_decode_attention_cuda(qd, kc, vc, pos),
        "add_": lambda: x.add_(1),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)   # ~0.1 s: longer than the n calls
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_time: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    c = FLAGSHIP
    trainer = Trainer(c, train_lib.TrainConfig(bf16_params=True),
                      device="cuda", seed=0)
    src = synthetic_lm_batches(BATCH, SEQ, c.vocab_size, seed=0)
    trainer.fit(src, steps=2, log_every=2)
    runs = []
    for _ in range(3):
        runs.append(timed_fit(trainer, src, 10))
        print(f"run: {json.dumps(runs[-1])}", flush=True)
    host = host_us_per_call()
    print(json.dumps({"card": card,
                      "package": sys.modules["kubeflow_tpu_torch"].__file__,
                      "shape": "flagship b8 s1024 bf16 params",
                      "median_ms_per_step": statistics.median(
                          r["ms_per_step"] for r in runs),
                      "runs": runs, "host_us_per_call": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
