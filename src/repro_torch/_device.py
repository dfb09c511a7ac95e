"""Where the port's views live: the CUDA device unless the caller says
otherwise."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when it is None.  Raises when no CUDA
    device is present: the port never falls back to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
