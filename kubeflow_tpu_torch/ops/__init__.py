"""Hand-written CUDA kernels and their plain PyTorch versions.

``launch_counts``/``reset_launch_counts`` read and zero every kernel
wrapper's launch counter, so a run can show that its main path went
through the kernels."""

from __future__ import annotations

from . import attention, decode_attention


def launch_counts() -> dict[str, int]:
    return {**attention.LAUNCHES, **decode_attention.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (attention.LAUNCHES, decode_attention.LAUNCHES):
        for name in counts:
            counts[name] = 0
