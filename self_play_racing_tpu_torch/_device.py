"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent CPU run.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by default) but
    unavailable, so a missing card is an error rather than a slow CPU run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

