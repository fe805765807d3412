"""The kernel wrappers' side of the dry run (``launch.dry_costs``).

A dry run drives the port's step functions on ``meta`` tensors, which
have shapes and dtypes and no data, to count what a step costs at pod
scale without a card.  While a dry-run counter is installed in
:data:`COUNTER`, a kernel wrapper takes its CUDA route for a meta tensor:
the same checks, the same output and workspace allocations at the kernel's
shapes and dtypes (meta, so nothing is allocated), and in place of the
launch one :func:`report` of the call's operations and bytes, counted as
the bound column of PERF.md §6 counts them (each operand read once, each
output written once).  ``.launches`` does not move.  Outside a counter a
meta tensor raises as every device but ``cpu`` and ``cuda`` does: the
plain versions never run on meta, so a dry run cannot count work the card
would not do.

:func:`scoped` marks a region whose ATen traffic the counter books apart
(the plain attention's core, for the flash-adjusted memory term).
"""
from __future__ import annotations

import contextvars

#: the installed ``launch.dry_costs.DryCounter``, or None
COUNTER: contextvars.ContextVar = contextvars.ContextVar("dry_counter", default=None)


def on_card(t) -> bool:
    """Whether ``t`` takes a kernel's CUDA route: it lies on a card, or it
    is a meta tensor inside a dry run."""
    kind = t.device.type
    return kind == "cuda" or (kind == "meta" and COUNTER.get() is not None)


def report(name: str, *, flops: float, nbytes: float, outputs=()):
    """Book one call of kernel ``name`` (its operations and the bytes it
    must move) with the installed counter; ``outputs``: the tensors the
    call allocated, so that their memory is counted however the call was
    reached (a registered operator's inner allocations are invisible to a
    dispatch mode)."""
    COUNTER.get().kernel(name, flops, nbytes, outputs)


def scratch(n_part: int, n_tickets: int):
    """The counter's stand-in for ``_build.scratch``: f32 partials and
    int32 tickets on meta, kept and grown for the counter's lifetime as the
    card keeps its per-stream scratch for the process's."""
    return COUNTER.get().scratch(n_part, n_tickets)


def scoped(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; inside a dry run its ATen traffic, forward
    and backward, is also booked under ``name``."""
    c = COUNTER.get()
    if c is None:
        return fn(*args, **kwargs)
    return c.scoped(name, fn, *args, **kwargs)
