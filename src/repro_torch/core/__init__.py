"""Small shared helpers: block-grid rounding, device resolution and the
program's profiler ranges."""
from __future__ import annotations

import contextlib

import torch

#: what :func:`span` returns while no profiler records: one shared context
#: that does nothing (``nullcontext`` keeps no state, so nesting is safe)
NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A profiler range ``name`` around a ``with`` block while a profiler
    records (``torch.profiler.record_function``: a host span and, on the
    card, its device projection), else :data:`NO_SPAN`.  The check costs
    ~0.1 us where an idle ``record_function`` costs ~8 us, so ranges may
    sit on the serving tick's path; tracing is on exactly when a profiler
    runs, and the profiler keeps the spans."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(name)
