"""PyTorch/CUDA port of the ``kubeflow_tpu`` workload layer for NVIDIA H100.

The JAX package ``kubeflow_tpu`` is the reference; this package is held
against it on the same inputs (tests/test_torch_*.py). It imports
``torch`` and never ``jax`` or anything of ``kubeflow_tpu``.

Entry points run on the card unless the caller asks for the CPU: a
``device="cuda"`` default that raises when CUDA is absent, never a silent
fall-back to the CPU. Importing the package needs neither ``nvcc`` nor a
card: the hand-written kernels under ``csrc/`` are built at first use
(ops/_build.py).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — the
    port never carries on on the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev
