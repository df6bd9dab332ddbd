"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and is absent,
    so nothing falls back to the CPU silently."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but is not available; pass device='cpu' to "
            "run on the CPU")
    return device
