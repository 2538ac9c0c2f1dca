"""Keys per split of the flash-decode kernel: the built CHUNK against the
other candidate (64 and 32).

    python3 -m kubeflow_tpu_torch.tools.decode_chunk_ab

``csrc/flash_decode.cu`` cuts the cache into chunks of ``CHUNK`` keys,
one block each, and merges the chunks' partials in a second launch. This
script builds a copy of that source with the other candidate's CHUNK into
``build/kernels/`` and times both libraries through the wrapper
(``flash_decode_attention_cuda``, counted as any call) on the same inputs,
in turns
(built, other, other, built): the served decode step (B8 S1024 G4 rep2
D128, every row at pos 159) and a full cache (every row at pos 1023), with
a bf16 and an int8 cache. A time is the mean of 20 launches timed with
CUDA events, queued behind a busy-wait kernel so the card and not the
host's launch path is timed, with the L2 cache flushed before each.

Prints the card's name and power limit, one line per turn, and a JSON
record last. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from unittest import mock

import torch

from ..models.decode import _quantize_kv
from ..ops import _build
from ..ops import decode_attention as dec

CANDIDATES = (64, 32)
_LINE = re.compile(r"constexpr int CHUNK = (\d+);")


def _build_chunk(chunk: int) -> ctypes.CDLL:
    """``csrc/flash_decode.cu`` with ``CHUNK = chunk``, built and loaded."""
    src = (_build.CSRC / "flash_decode.cu").read_text()
    path = _build.BUILD_DIR / f"flash_decode_chunk{chunk}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(_LINE.sub(f"constexpr int CHUNK = {chunk};", src, 1))
    lib_path = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in dec._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # ~0.1 s: every launch queued behind it
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_chunk_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    built = dec._lib()
    chunk = built.kft_flash_decode_chunk()
    other = next(c for c in CANDIDATES if c != chunk)
    libs = {chunk: built, other: _build_chunk(other)}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    B, S, G, rep, D = 8, 1024, 4, 2, 128
    q = torch.randn((B, G, rep, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, G, D), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    (qk, ks), (qv, vs) = _quantize_kv(k), _quantize_kv(v)
    record: dict = {"card": card, "shape": f"B{B} S{S} G{G} rep{rep} D{D}",
                    "built_chunk": chunk, "cases": {}}
    for pos_at in (159, S - 1):
        pos = torch.full((B,), pos_at, dtype=torch.int32, device="cuda")
        for cache, args in (("bf16", (k, v, None, None)),
                            ("int8", (qk, qv, ks, vs))):
            kk, vv, sk, sv = args
            want = dec.flash_decode_attention_plain(q, kk, vv, pos,
                                                    k_scale=sk, v_scale=sv)
            turns: dict = {c: [] for c in libs}
            for c in (chunk, other, other, chunk):
                def fn():
                    return dec.flash_decode_attention_cuda(
                        q, kk, vv, pos, k_scale=sk, v_scale=sv)
                # the wrapper as it is, launching this turn's library
                with mock.patch.object(dec, "_lib", lambda lib=libs[c]: lib):
                    err = (fn().float() - want.float()).abs().max().item()
                    ms = _ms(fn, flush)
                turns[c].append(ms)
                print(f"pos {pos_at} {cache} cache, CHUNK {c}: {ms:.4f} ms "
                      f"(max|kernel-plain| {err:.3e})", flush=True)
            record["cases"][f"pos{pos_at}_{cache}"] = {
                str(c): t for c, t in turns.items()}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
