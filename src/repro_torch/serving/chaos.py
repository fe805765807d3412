"""Deterministic chaos injection for the serving engine (a copy of
``repro.serving.chaos``; numpy only, no tensors).

:class:`ChaosInjector` is a catalog of *named fault points* that the
serving stack consults at well-defined seams:

``pool.alloc``
    ``PagePool.alloc`` returns ``None`` (transient exhaustion) even though a
    free page exists.  Exercises admission rollback and, with
    ``EngineConfig(preemption=...)``, the preempt/recompute path.
``runner.mixed``
    The engine's tick (mixed step or decode chunk) fails *before
    dispatch* — no device state has been mutated, so the tick is simply
    skipped and retried.  Raised as :class:`ChaosError` and absorbed by
    ``Engine.step``.
``logits.nan``
    One live slot's logits are poisoned to NaN inside the decode step
    (via the runner's ``nanmask`` buffer, a static input of the decode
    graph on the card), exercising per-request fault isolation: only that
    slot retires ``FinishReason.FAULT``.
``clock.skew``
    The engine's injected clock (``ChaosInjector.now``) jumps forward by
    ``skew_s`` seconds, exercising deadline expiry deterministically.

Faults fire from a *schedule* (explicit per-point consult indices — fully
deterministic) and/or seeded per-point Bernoulli *rates*; every firing is
recorded in :attr:`events`, so two runs with the same seed and schedule are
bit-identical: the per-point ``numpy.random.RandomState`` streams are
seeded as in ``repro.serving.chaos``, so a seed fires the same consults in
both packages.  The injector never imports the engine — it is a leaf
dependency consulted through small callables/flags.  The training
specialisation is ``runtime.ft.FailureInjector``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from collections.abc import Iterable, Mapping

import numpy as np

#: The serving fault-point catalog (see module docstring).
FAULT_POINTS = ("pool.alloc", "runner.mixed", "logits.nan", "clock.skew")


class ChaosError(RuntimeError):
    """A transient injected failure (fault point ``runner.mixed``)."""


class ChaosInjector:
    """Deterministic fault injection over named fault points.

    Parameters
    ----------
    seed:
        Seeds one independent RNG stream per fault point (rates only).
    schedule:
        ``{point: iterable of consult indices}`` — ``fire(point)`` returns
        True exactly on those consults (0-based, per point).
    rates:
        ``{point: probability}`` — each consult additionally fires with the
        given seeded probability.
    skew_s:
        Seconds added to the injected clock each time ``clock.skew`` fires.
    points:
        The legal fault-point names (a typo guard).  Defaults to
        :data:`FAULT_POINTS`; the training ``runtime.ft.FailureInjector``
        passes its own.
    """

    def __init__(self, seed: int = 0,
                 schedule: Mapping[str, Iterable[int]] | None = None,
                 rates: Mapping[str, float] | None = None,
                 skew_s: float = 60.0,
                 points: tuple[str, ...] = FAULT_POINTS):
        self.points = tuple(points)
        self.schedule = {p: frozenset(int(i) for i in ix)
                         for p, ix in (schedule or {}).items()}
        self.rates = {p: float(r) for p, r in (rates or {}).items()}
        unknown = (set(self.schedule) | set(self.rates)) - set(self.points)
        if unknown:
            raise ValueError(f"unknown fault points {sorted(unknown)}; "
                             f"known: {list(self.points)}")
        self.skew_s = float(skew_s)
        self.skew = 0.0
        self._counts: dict[str, int] = defaultdict(int)
        self._rngs = {p: np.random.RandomState((seed * 1000003 + k + 1)
                                               & 0x7FFFFFFF)
                      for k, p in enumerate(self.points)}
        #: chronological (point, consult_index) log of every firing
        self.events: list[tuple[str, int]] = []

    def fire(self, point: str) -> bool:
        """Consult fault point ``point``; True when the fault fires.  Each
        call advances the point's consult counter."""
        if point not in self.points:
            raise ValueError(f"unknown fault point {point!r}")
        idx = self._counts[point]
        self._counts[point] += 1
        hit = idx in self.schedule.get(point, ())
        r = self.rates.get(point, 0.0)
        if not hit and r > 0.0:
            hit = bool(self._rngs[point].random_sample() < r)
        if hit:
            self.events.append((point, idx))
            if point == "clock.skew":
                self.skew += self.skew_s
        return hit

    def now(self) -> float:
        """The injected clock: wall time plus accumulated skew."""
        return time.time() + self.skew

    def count(self, point: str) -> int:
        """Number of times ``point`` has *fired* (not consulted)."""
        return sum(1 for p, _ in self.events if p == point)
