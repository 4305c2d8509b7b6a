"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device
