"""Device resolution: the port runs on the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; raises when CUDA is absent rather than falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "kernels' plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
