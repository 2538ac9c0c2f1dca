#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``kubeflow_tpu_torch/csrc``,
holds each one against its plain PyTorch version on the card, then serves
the flagship LM (d_model 1024, 12 layers, 8 heads of 128, 4 KV heads,
d_ff 4096, vocab 32000, max_seq_len 1024; random weights from a seed)
over HTTP through the port's ``ServingServer`` and ``BatchedGenerator``,
and shows through the kernels' launch counters that the serving path ran
them. Then it times each kernel beside its bound, its plain version and
one PyTorch library call computing the same function.

Phases (any failure exits non-zero before the result line):
  1. flash-attention forward, kernel vs plain (bf16 flagship shapes,
     ragged length, f32);
  2. flash-decode, kernel vs plain (bf16 and int8 cache);
  3. the serving path at full flagship width, counted launches, and an
     f32 check of kernel-path tokens against the plain-attention path;
  4. where the time goes: one generate() under torch.profiler, device
     busy time by kernel class against host wall time;
  5. times of each kernel, its plain version and a library call.

The first lines name the card and its power limit; the line before the
last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is unavailable or the package is not beside this file. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16, published
              "float32": 67e12}    # f32 outside the tensor cores
BF16_TOL = 2e-2    # |kernel - plain|: ~4 bf16 ulps at |o| ~ 1; the two
                   # round p to bf16 against different running maxima
F32_TOL = 2e-5     # the JAX package's own kernel pin (tests/test_ops.py)
LSE_TOL = 1e-4     # f32 row log-sum-exp, summation order only


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing
class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before every
    launch (a cold cache, as a decode step finds each layer's KV)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phase 1
def phase_flash_attention(torch):
    from kubeflow_tpu_torch.ops.attention import (flash_attention_cuda,
                                                  flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (b, s, h, d, dtype, causal)
        (8, 512, 8, 128, torch.bfloat16, True),     # flagship prefill
        (8, 128, 8, 128, torch.bfloat16, True),     # the served prompts
        (2, 77, 8, 128, torch.bfloat16, True),      # ragged edge
        (2, 77, 8, 128, torch.bfloat16, False),
        (2, 128, 4, 64, torch.float32, True),
        (2, 100, 4, 32, torch.float32, False),
        (1, 200, 2, 128, torch.float32, True),
    ]
    flagship_err = 0.0
    for b, s, h, d, dt, causal in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                               dtype=dt) for _ in range(3))
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, causal,
                                             return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        print(f"phase1 flash_attention b={b} s={s} h={h} d={d} "
              f"{str(dt)[6:]} causal={causal}: max|kernel-plain|={err:.3e}"
              f" (tol {tol:g}) lse err={lse_err:.3e} (tol {LSE_TOL:g})",
              flush=True)
        require(err <= tol and lse_err <= LSE_TOL and
                bool(torch.isfinite(out).all()),
                f"flash_attention disagrees with its plain version at "
                f"{(b, s, h, d, dt, causal)}")
        if (b, s) == (8, 512):
            flagship_err = err
    return flagship_err


# --------------------------------------------------------------- phase 2
def decode_inputs(torch, B=8, S=1024, G=4, rep=2, D=128,
                  dtype=None, seed=2):
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, G, rep, D), generator=g, device="cuda", dtype=dtype)
    k = torch.randn((B, S, G, D), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((B, S, G, D), generator=g, device="cuda", dtype=dtype)
    return q, k, v


def phase_flash_decode(torch):
    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.decode_attention import (
        flash_decode_attention_cuda, flash_decode_attention_plain)
    S = 1024
    positions = {"zero": [0] * 8, "mid-block": [300] * 8,
                 "last": [S - 1] * 8,
                 "mixed": [0, 1, 127, 128, 500, 777, S - 2, S - 1]}
    errs = {"flash_decode": 0.0, "flash_decode_int8": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = decode_inputs(torch, dtype=dt)
        qk, ks = _quantize_kv(k)
        qv, vs = _quantize_kv(v)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        for label, pos in positions.items():
            pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for name, kw, kk, vv in (
                    ("flash_decode", {}, k, v),
                    ("flash_decode_int8", {"k_scale": ks, "v_scale": vs},
                     qk, qv)):
                out = flash_decode_attention_cuda(q, kk, vv, pos, **kw)
                torch.cuda.synchronize()
                ref = flash_decode_attention_plain(q, kk, vv, pos, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                print(f"phase2 {name} {str(dt)[6:]} pos={label}: "
                      f"max|kernel-plain|={err:.3e} (tol {tol:g})",
                      flush=True)
                require(err <= tol and bool(torch.isfinite(out).all()),
                        f"{name} disagrees with its plain version "
                        f"({dt}, pos {label})")
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], err)
    for rep in (1, 4, 8):  # the GQA widths other configs use, small f32
        q, k, v = decode_inputs(torch, B=2, S=256, G=2, rep=rep, D=64,
                                dtype=torch.float32, seed=3)
        pos = torch.tensor([50, 255], dtype=torch.int32, device="cuda")
        err = (flash_decode_attention_cuda(q, k, v, pos) -
               flash_decode_attention_plain(q, k, v, pos)).abs().max().item()
        print(f"phase2 flash_decode f32 rep={rep} d=64: "
              f"max|kernel-plain|={err:.3e} (tol {F32_TOL:g})", flush=True)
        require(err <= F32_TOL, f"flash_decode rep={rep} disagrees")
    return errs


# --------------------------------------------------------------- phase 3
def _post(url: str, payload: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        require(resp.status == 200, f"/v1/generate answered {resp.status}")
        return json.loads(resp.read())


def _post_stream(url: str, payload: dict) -> list[dict]:
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps({**payload, "stream": True})
        .encode(), headers={"Content-Type": "application/json"},
        method="POST")
    events = []
    with urllib.request.urlopen(req, timeout=300) as resp:
        require(resp.headers.get("Content-Type") == "text/event-stream",
                "stream response is not text/event-stream")
        for line in resp.read().decode().splitlines():
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return events


def _concurrent(url: str, payloads: list[dict]) -> tuple[list[dict], float]:
    results: list = [None] * len(payloads)
    errors: list = []

    def worker(i):
        try:
            results[i] = _post(url, payloads[i])
        except Exception as e:  # noqa: BLE001 — re-raised below as a failure
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(payloads))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    require(not errors and all(r is not None for r in results),
            f"concurrent requests failed: {errors}")
    return results, wall


def _check_ids(out: dict, n: int, vocab: int, what: str) -> list[int]:
    ids = out["ids"]
    require(isinstance(ids, list) and len(ids) == n and
            all(isinstance(t, int) and 0 <= t < vocab for t in ids),
            f"{what}: bad ids {ids!r}")
    require(out["usage"]["completion_tokens"] == n,
            f"{what}: usage {out['usage']}")
    return ids


def phase_serving(torch, flagship):
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.server import ServingServer
    from kubeflow_tpu_torch.runtime.serving import BatchedGenerator

    c = flagship
    L, V = c.n_layers, c.vocab_size
    params = init_params(torch.Generator(device="cuda").manual_seed(0), c,
                         device="cuda")
    gen = BatchedGenerator(params, c, max_batch=8, max_wait_s=0.5,
                           device="cuda")
    server = ServingServer(gen, c, port=0).start()
    rng = torch.Generator().manual_seed(7)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    expected = {"flash_attention": 0, "flash_decode": 0,
                "flash_decode_int8": 0}

    def account(batches, max_new):
        expected["flash_attention"] += batches * L
        expected["flash_decode"] += batches * (max_new - 1) * L

    stats = {}
    try:
        ops.reset_launch_counts()
        # warm-up: the first batch initialises cuBLAS and the allocator
        n0 = gen.batches_total
        _check_ids(_post(server.url, {"prompt": prompt(8),
                                      "max_new_tokens": 2}), 2, V, "warmup")
        account(gen.batches_total - n0, 2)

        # 8 concurrent greedy requests: 128-token prompts, 64 new tokens
        n0 = gen.batches_total
        group_a = [{"prompt": prompt(128), "max_new_tokens": 64}
                   for _ in range(8)]
        outs, wall = _concurrent(server.url, group_a)
        for i, out in enumerate(outs):
            _check_ids(out, 64, V, f"greedy request {i}")
        batches_a = gen.batches_total - n0
        account(batches_a, 64)
        stats["serve_8x128p_64n_wall_s"] = wall
        stats["serve_8x128p_64n_batches"] = batches_a
        stats["serve_8x128p_64n_tokens_per_s"] = 8 * 64 / wall
        print(f"phase3 8 concurrent greedy requests (prompt 128, 64 new): "
              f"{batches_a} batch(es), {wall:.3f} s, "
              f"{8 * 64 / wall:.1f} generated tokens/s", flush=True)

        # 2 requests at a ragged 77-token prompt, one greedy, one sampled
        n0 = gen.batches_total
        outs, _ = _concurrent(server.url, [
            {"prompt": prompt(77), "max_new_tokens": 16},
            {"prompt": prompt(77), "max_new_tokens": 16,
             "temperature": 0.8, "top_k": 50, "top_p": 0.9}])
        for i, out in enumerate(outs):
            _check_ids(out, 16, V, f"77-token request {i}")
        account(gen.batches_total - n0, 16)

        # one streamed request, then the same prompt again, plain: a
        # repeated greedy prompt at the same batch shape gives the same ids
        p = prompt(128)
        n0 = gen.batches_total
        events = _post_stream(server.url, {"prompt": p,
                                           "max_new_tokens": 32})
        done = events[-1]
        require(done.get("done") is True and done["n_tokens"] == 32,
                f"stream did not finish: {events[-1]}")
        streamed = [e["token"] for e in events[:-1]]
        require(streamed == done["ids"],
                "streamed tokens differ from the done event's ids")
        _check_ids(done, 32, V, "streamed request")
        again = _check_ids(_post(server.url, {"prompt": p,
                                              "max_new_tokens": 32}),
                           32, V, "repeated request")
        require(again == done["ids"],
                "a repeated greedy prompt gave different ids")
        account(gen.batches_total - n0, 32)

        for path in ("/healthz", "/v1/models", "/metrics"):
            with urllib.request.urlopen(server.url + path, timeout=30) as r:
                require(r.status == 200, f"{path} answered {r.status}")

        # the int8 KV cache drives the int8 decode kernel
        kv_prompt = torch.randint(0, V, (2, 64), generator=rng).cuda()
        toks = generate(gen.params, kv_prompt, c, 8, kv_quant=True)
        torch.cuda.synchronize()
        require(toks.shape == (2, 8) and bool(((toks >= 0) &
                                                (toks < V)).all()),
                "generate(kv_quant=True) returned bad tokens")
        expected["flash_attention"] += L
        expected["flash_decode_int8"] += 7 * L
        counts = ops.launch_counts()
    finally:
        server.stop()
    print(f"phase3 launches {counts} expected {expected}", flush=True)
    for name, want in expected.items():
        require(counts[name] == want and want > 0,
                f"{name}: {counts[name]} launches on the main path, "
                f"expected {want}")
    return params, counts, stats


def phase_reference_tokens(torch, flagship, params):
    """f32, full width: greedy tokens through the kernels equal those
    through the plain attention paths (launches here are not counted)."""
    from kubeflow_tpu_torch.models.decode import generate, prefill
    c32 = flagship.replace(dtype="float32")
    plain = c32.replace(attention="xla", decode_attention="xla")
    prompt = torch.randint(0, c32.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(9)).cuda()
    l_k, _ = prefill(params, prompt, c32)
    l_p, _ = prefill(params, prompt, plain)
    t_k = generate(params, prompt, c32, 12)
    t_p = generate(params, prompt, plain, 12)
    err = (l_k - l_p).abs().max().item()
    same = bool((t_k == t_p).all())
    print(f"phase3 f32 reference: prefill logits max|kernel-plain|="
          f"{err:.3e} (tol 1e-3), greedy tokens identical: {same}",
          flush=True)
    require(err <= 1e-3 and same,
            "the kernel path disagrees with the plain attention path")


# --------------------------------------------------------------- phase 4
def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention (ours)"
    if "flash_decode_kernel" in low:
        return "flash_decode (ours)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                              "matmul")):
        return "matmul (cuBLAS)"
    if any(t in low for t in ("sort", "scan", "topk", "argmax", "reduce")):
        return "sort/reduce"
    return "elementwise/other"


def phase_where_time_goes(torch, flagship, params):
    """One generate() at the served shape under torch.profiler: device
    busy time by kernel class against host wall time. Launches here are
    not counted."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.runtime.serving import cast_matmul_weights
    p = cast_matmul_weights(params, flagship.compute_dtype)
    prompt = torch.randint(0, flagship.vocab_size, (8, 128),
                           generator=torch.Generator().manual_seed(11)
                           ).cuda()
    generate(p, prompt, flagship, 4)              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        generate(p, prompt, flagship, 16)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_class: dict[str, float] = {}
    launches = 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        cls = _kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        launches += evt.count
    busy = sum(by_class.values())
    out = {"shape": "generate B=8 prompt=128 new=16 bf16", "wall_ms": wall_ms,
           "device_busy_ms": busy if busy else None,
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "device_kernels": launches,
           "busy_ms_by_class": by_class}
    if not busy:
        print("phase4 device time not measured: the profiler saw no CUDA "
              "kernels", flush=True)
    else:
        print(f"phase4 {out['shape']}: wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms (idle {100 * (1 - busy / wall_ms):.1f}%), "
              f"{launches} kernels", flush=True)
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"phase4   {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}% of "
                  f"busy)", flush=True)
    return out


# --------------------------------------------------------------- phase 5
def _time_flash(torch, timer, b, s, h, d, seed=4):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.attention import (flash_attention_cuda,
                                                  flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    err = (flash_attention_cuda(q, k, v, True).float() -
           flash_attention_plain(q, k, v, True).float()).abs().max().item()
    nbytes = 4 * b * s * h * d * 2
    flops = 4 * b * h * d * (s * (s + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    return {
        "max_abs_err": err,
        "ms": timer.ms(lambda: flash_attention_cuda(q, k, v, True)),
        "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v, True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "shape": f"b={b} s={s} h={h} d={d} bf16 causal"}


def _time_decode(torch, timer, pos_list, quant, B=8, S=1024, G=4, rep=2,
                 D=128):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.decode_attention import (
        flash_decode_attention_cuda, flash_decode_attention_plain)
    q, k, v = decode_inputs(torch, B, S, G, rep, D)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    kw = {}
    qh = q.reshape(B, G * rep, 1, D)
    kl, vl = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    if quant:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (_quantize_kv(k),
                                                  _quantize_kv(v))
    live = sum(min(p, S - 1) + 1 for p in pos_list)
    nbytes = (2 * B * G * rep * D * 2 + B * 4             # q, o, pos
              + 2 * live * G * D * (1 if quant else 2)    # live K and V
              + (2 * live * G * 4 if quant else 0))       # their scales
    b_ms, b_by = bound(nbytes, 4 * G * rep * D * live, "bfloat16")
    err = (flash_decode_attention_cuda(q, k, v, pos, **kw).float() -
           flash_decode_attention_plain(q, k, v, pos, **kw).float()
           ).abs().max().item()
    return {
        "max_abs_err": err,
        "ms": timer.ms(lambda: flash_decode_attention_cuda(q, k, v, pos,
                                                           **kw)),
        "plain_ms": timer.ms(lambda: flash_decode_attention_plain(
            q, k, v, pos, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None if quant else timer.ms(
            lambda: F.scaled_dot_product_attention(
                qh, kl, vl, attn_mask=mask, enable_gqa=True)),
        "shape": f"B={B} S={S} G={G} rep={rep} D={D} pos={pos_list} "
                 f"{'int8' if quant else 'bf16'} cache"}


def _print_row(name, r):
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"phase5 {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms, library {lib}, max|kernel-plain| "
          f"{r['max_abs_err']:.3e}", flush=True)


def phase_times(torch, errs, counts):
    """Each kernel at the main path's shapes (the served 128-token
    prefill; a decode step in the middle of the served 64 tokens) — the
    ``kernels`` record — and at the phase-1/2 shapes (printed)."""
    timer = Timer(torch)
    S = 1024
    main = {
        "flash_attention": _time_flash(torch, timer, 8, 128, 8, 128),
        "flash_decode": _time_decode(torch, timer, [159] * 8, False),
        "flash_decode_int8": _time_decode(torch, timer, [159] * 8, True),
    }
    wide = {
        "flash_attention": _time_flash(torch, timer, 8, 512, 8, 128),
        "flash_decode": _time_decode(
            torch, timer, [0, 1, 127, 128, 500, 777, S - 2, S - 1], False),
        "flash_decode_int8": _time_decode(
            torch, timer, [0, 1, 127, 128, 500, 777, S - 2, S - 1], True),
    }
    sources = {
        "flash_attention": ("kubeflow_tpu_torch/csrc/flash_attention.cu",
                            "kubeflow_tpu/ops/attention.py:47"),
        "flash_decode": ("kubeflow_tpu_torch/csrc/flash_decode.cu",
                         "kubeflow_tpu/ops/decode_attention.py:40"),
        "flash_decode_int8": ("kubeflow_tpu_torch/csrc/flash_decode.cu",
                              "kubeflow_tpu/ops/decode_attention.py:40"),
    }
    rows = []
    for name, r in main.items():
        _print_row(name, r)
        _print_row(name, wide[name])
        require(r["max_abs_err"] <= BF16_TOL,
                f"{name} disagrees with its plain version at the main "
                f"path's shape")
        rows.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": counts[name],
                     **r, "max_abs_err": max(r["max_abs_err"], errs[name])})
    return rows, wide


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    names = _build.build_all()
    print(f"built {names} in {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}")

    errs = {"flash_attention": phase_flash_attention(torch)}
    errs.update(phase_flash_decode(torch))
    flagship = TransformerConfig(vocab_size=32_000, d_model=1024,
                                 n_layers=12, n_heads=8, n_kv_heads=4,
                                 d_ff=4096, max_seq_len=1024)
    params, counts, stats = phase_serving(torch, flagship)
    phase_reference_tokens(torch, flagship, params)
    stats["profile"] = phase_where_time_goes(torch, flagship, params)
    del params
    rows, wide = phase_times(torch, errs, counts)
    print(json.dumps({"serving": stats, "kernels_at_phase12_shapes": wide}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
