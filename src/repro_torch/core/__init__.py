"""Small shared helpers: block-grid rounding and device resolution."""
from __future__ import annotations

import torch


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (block-grid alignment)."""
    return ((n + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is requested (explicitly or by default)
    and no card is present — the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
