"""snap_tpu_torch: the snap-tpu short-read aligner in PyTorch, with the
device kernels hand-written in CUDA for NVIDIA Hopper (sm_90a).

This package sits beside `snap_tpu` (the JAX reference) and keeps its
module layout and public names, so each function here has a
counterpart of the same name there. It imports torch and numpy only,
never jax and nothing of `snap_tpu`.

Device rule: entry points take an explicit `device`, "cuda" by default.
Asking for CUDA on a machine without it raises; nothing moves to the
CPU unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA is asked
    for (the default) but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "snap_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
