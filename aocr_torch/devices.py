"""The port's device policy: every entry point runs on CUDA unless the
caller names another device."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The named device; None means "cuda".  Raises for a CUDA device when
    CUDA is absent: the CPU runs only when the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
