"""One sharded train step per mesh layout, and tp-sharded serving, on n
ranks: the port's counterpart of ``__graft_entry__.dryrun_multichip``.

    python3 -m kubeflow_tpu_torch.tools.dryrun_multidevice N [--device cpu]

Spawns N ranks (one per card with ``--device cuda``, the default, over
NCCL; gloo processes with ``--device cpu``) and runs the reference's
layouts, on a tiny flagship (d_model 128, 4 layers, 4 heads of 32, 2 kv
heads, vocab 512, f32) and a tiny MoE (d_model 128, 2 layers, 4 heads
of 32, 2 kv heads, d_ff 128, 4 experts, top-2, routing groups of 32
tokens, one sequence). The reference's tiny configs have heads of 16,
which the card's flash kernels do not take: they take d_head 32, 64 and
128.

1. dp × fsdp × tp × sp: FSDP, tensor parallelism and ring-attention
   sequence parallelism in one train step (each axis 2 where N allows);
2. pp × tp (N a multiple of 4): the GPipe schedule, fsdp taking the rest;
3. the MoE over ep: ep2 × tp2 (N a multiple of 4), ep4 × tp2 (one expert
   a rank) and pp2 × ep2 × tp2 (N a multiple of 8);
4. a 2-slice hybrid mesh, dp spanning the slices, fsdp + tp inside each
   (N a multiple of 8);
5. pp2 × sp2 × tp2, ring attention inside the stages, + fsdp2 at N = 16
   (N a multiple of 8);
6. tp serving (N a multiple of 4): greedy ``generate`` on tp-sharded
   weights and KV token-identical to unsharded, and
   ``speculative_generate`` on the same sharded params with themselves
   as the draft accepting every proposal.

A layout that N does not divide is skipped, as in the reference, with a
line that says so. Each train step must give a finite loss below 1e4;
its batch is max(4, 2 × the data ranks) rows, and on a pp mesh a
multiple of the 2·pp microbatches times the data ranks (the reference
needs no such multiple: GSPMD lays a microbatch out over any number of
rows). Prints one line per layout; any failed check fails the run.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..models.decode import generate
from ..models.moe import MoEConfig
from ..models.speculative import speculative_generate
from ..models.train import make_sharded_train_step
from ..models.transformer import TransformerConfig, init_params
from ..parallel import comm
from ..parallel.mesh import (MeshConfig, build_hybrid_mesh, build_mesh,
                             mesh_config, spawn)
from ..runtime.data import shard_batch
from ..runtime.sharded_decode import shard_decode_params

TINY = TransformerConfig(vocab_size=512, d_model=128, n_layers=4, n_heads=4,
                         n_kv_heads=2, d_ff=256, max_seq_len=128,
                         dtype="float32")
# per-sequence routing groups (32 = the dryrun's seq): microbatch-
# invariant, so the pp layout routes as the flat ones
TINY_MOE = MoEConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq_len=128,
                     dtype="float32", n_experts=4, experts_per_token=2,
                     route_group_size=32)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _train_step(mesh, label: str, config=TINY) -> str:
    """One full train step on ``mesh``; the loss must be finite."""
    dev = comm.mesh_device(mesh)
    cfg = mesh_config(mesh)
    init_fn, step_fn = make_sharded_train_step(mesh, config)
    params, opt_state = init_fn(_generator(dev, 0))
    data = cfg.dp * cfg.fsdp
    batch = max(4, 2 * data) if cfg.pp == 1 else 2 * cfg.pp * data
    tokens = np.random.default_rng(1).integers(
        0, config.vocab_size, (batch, 32), dtype=np.int64)
    targets = np.roll(tokens, -1, axis=1)
    local = [torch.from_numpy(shard_batch(x, mesh)).to(dev)
             for x in (tokens, targets)]
    _, _, loss = step_fn(params, opt_state, *local)
    loss = float(loss)
    if not (math.isfinite(loss) and loss < 1e4):
        raise AssertionError(f"{label}: bad loss {loss}")
    return f"[dryrun] {label}: mesh={cfg.axis_sizes()} loss={loss:.4f}"


def _serving(n: int, device) -> str:
    """tp-sharded greedy generate equal to unsharded; speculative decode
    on the same sharded params with themselves as the draft."""
    mesh = build_mesh(MeshConfig.auto(n, tp=2, fsdp=1), device)
    dev = comm.mesh_device(mesh)
    params = init_params(_generator(dev, 0), TINY, dev)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, TINY.vocab_size, (2, 8), dtype=np.int64)).to(dev)
    want = generate(params, prompt, TINY, 12)
    sharded = shard_decode_params(params, mesh, TINY)
    got = generate(sharded, prompt, TINY, 12)
    if not torch.equal(got, want):
        raise AssertionError(f"tp-serving: sharded generate diverged from "
                             f"unsharded\nunsharded: {want}\nsharded: {got}")
    spec_ids, stats = speculative_generate(sharded, sharded, prompt, TINY,
                                           TINY, max_new_tokens=12, k=3)
    if not torch.equal(spec_ids, want):
        raise AssertionError("tp-serving: sharded speculative decode "
                             "diverged")
    accepted, drafted = int(stats.accepted.sum()), int(stats.drafted.sum())
    if accepted != drafted:
        raise AssertionError(f"tp-serving: identical-weights draft must "
                             f"accept all proposals ({accepted}/{drafted})")
    return (f"[dryrun] tp-serving: mesh={mesh_config(mesh).axis_sizes()} "
            f"token-identical generate + speculative (accepted "
            f"{accepted}/{drafted})")


def _skipped(label: str, n: int, multiple: int) -> str:
    return (f"[dryrun] {label}: skipped, {n} ranks is not a multiple of "
            f"{multiple}")


def _rank(rank: int, n: int, device: str) -> list[str]:
    """Every layout N allows, on this rank; the report lines (a skipped
    layout's says why)."""
    lines = []

    def run(label: str, multiple: int, config, **axes) -> None:
        if n % multiple:
            lines.append(_skipped(label, n, multiple))
            return
        lines.append(_train_step(
            build_mesh(MeshConfig.auto(n, **axes), device), label, config))

    # layout 1: dp/fsdp/tp/sp
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 else 1
    fsdp = 2 if n % (tp * sp * 2) == 0 else 1
    run("fsdp+tp+sp(ring)", 1, TINY, tp=tp, sp=sp, fsdp=fsdp)
    # layout 2: dp/pp/tp pipeline
    run("pp(gpipe)+tp", 4, TINY, tp=2, pp=2)
    # layout 3: dp/ep/tp expert parallelism, then with pp
    run("ep(moe)+tp", 4, TINY_MOE, tp=2, ep=2)
    run("ep4(moe)+tp", 8, TINY_MOE, tp=2, ep=4)
    run("pp+ep(moe)+tp", 8, TINY_MOE, tp=2, ep=2, pp=2)
    # layout 5: every model axis together, fsdp on what remains
    fsdp = 2 if n % 16 == 0 else 1
    run("pp+sp(ring)+tp" + ("+fsdp" if fsdp > 1 else ""), 8, TINY, tp=2,
        sp=2, pp=2, fsdp=fsdp)
    # layout 4: multislice hybrid
    label = "multislice(dp-over-slices)+fsdp+tp"
    if n % 8:
        lines.append(_skipped(label, n, 8))
    else:
        mesh, _ = build_hybrid_mesh(
            2, MeshConfig.auto(n // 2, tp=2, fsdp=2), device)
        lines.append(_train_step(mesh, label))
    # layout 6: tp serving
    if n % 4:
        lines.append(_skipped("tp-serving", n, 4))
    else:
        lines.append(_serving(n, device))
    return lines


def dryrun_multidevice(n_devices: int, device="cuda",
                       timeout: float = 600.0) -> list[str]:
    """Run the layouts on ``n_devices`` spawned ranks (``device="cuda"``:
    one card each, NCCL; ``"cpu"``: gloo). Prints and returns rank 0's
    report lines; raises when a rank fails or the ranks are not done
    within ``timeout`` seconds."""
    lines = spawn(_rank, n_devices, str(device), device=device,
                  timeout=timeout)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multidevice(args.n, args.device)


if __name__ == "__main__":
    main()
