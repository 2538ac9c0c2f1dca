"""Per-layer ``w[i]`` against one ``unbind`` of the stacked weights.

    python3 -m kubeflow_tpu_torch.tools.stacked_weights_ab

The model keeps its layer weights stacked on a leading (L, ...) axis. The
forward takes them apart once with ``unbind(0)`` (``unstack_layers``);
indexing ``w[i]`` per layer instead gives each layer a ``select`` whose
backward materialises a zero (L, ...) grad. This script times one
flagship train step (b8 x s1024, bf16 params with f32 masters, flash
attention on the card) both ways, in turns (index, unbind, unbind,
index), and reports each turn's ms per step and peak device memory. Both
arms run the same forward, written here with only the layer split
differing, and the whole-logits cross entropy of ``loss_fn``.

Prints the card's name and power limit, one line per turn, and a JSON
record last. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from ..models import train as train_lib
from ..models import transformer as tfm
from ..runtime.data import synthetic_lm_batches
from .train_step_time import FLAGSHIP


def _indexed(blocks: dict) -> list[dict]:
    return [{name: w[i] for name, w in blocks.items()}
            for i in range(next(iter(blocks.values())).shape[0])]


def _loss(split, config):
    """loss_fn's cross entropy over a forward whose layers come from
    ``split(params["blocks"])``."""
    def loss(params, tokens, targets):
        c = config
        x = params["embed"].to(c.compute_dtype)[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        cos, sin = tfm.rope_frequencies(c, positions[None].expand(
            tokens.shape))
        for layer in split(params["blocks"]):
            x = tfm.attention_block(x, layer, c, cos, sin)
            x = tfm.mlp_block(x, layer, c)
        logits = tfm.lm_head_logits(tfm.rms_norm(x, params["final_norm"]),
                                    params["lm_head"])
        valid = targets >= 0
        safe = torch.where(valid, targets, 0).long()
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, safe[..., None])[..., 0]
        return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
    return loss


def _turn(step, state, batch, n: int = 3) -> tuple[float, float]:
    """(ms per step over ``n`` synchronised steps after one warm-up,
    peak GB allocated during them)."""
    params, opt = state
    params, opt, _ = step(params, opt, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(n):
        params, opt, _ = step(params, opt, *batch)
    torch.cuda.synchronize()
    return ((time.monotonic() - t0) / n * 1e3,
            torch.cuda.max_memory_allocated() / 1e9)


def main() -> int:
    if not torch.cuda.is_available():
        print("stacked_weights_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    c = FLAGSHIP
    tc = train_lib.TrainConfig(bf16_params=True)
    init_fn, _ = train_lib.make_train_step(c, tc, "cuda")
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    batch = tuple(torch.from_numpy(x).cuda() for x in next(iter(
        synthetic_lm_batches(8, 1024, c.vocab_size, seed=3))))
    optimizer = train_lib.make_optimizer(tc)
    splits = {"index": _indexed, "unbind": tfm.unstack_layers}
    turns: dict = {"index": [], "unbind": []}
    for name in ("index", "unbind", "unbind", "index"):
        step = functools.partial(train_lib.train_step,
                                 loss=_loss(splits[name], c),
                                 optimizer=optimizer)
        ms, peak = _turn(step, state, batch)
        turns[name].append({"ms_per_step": ms, "peak_gb": peak})
        print(f"{name}: {ms:.2f} ms/step, peak {peak:.3f} GB", flush=True)
    print(json.dumps({"card": card, "shape": "flagship b8 s1024 bf16 params",
                      "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
