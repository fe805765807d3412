"""Rate and tail arithmetic over a whole window.

Every statistic here is taken over all the requests or all the work of
the window it is given, never over medians of ticks or chunks.  A request
that failed or never finished is *missing*: it counts as an infinite
latency, so it lies in the tail of every percentile it belongs to.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class RequestRecord:
    """One request as the client saw it, in host seconds."""
    sent: float
    first: float | None     # first token's emission (None: none came)
    finish: float | None    # last token's emission (None: unfinished)
    tokens: int             # tokens generated
    ok: bool                # finished healthily with all its tokens

    @property
    def ttft(self) -> float:
        return self.first - self.sent if (self.ok and self.first is not None) else math.inf

    @property
    def tpot(self) -> float:
        """(finish - first token) / (n - 1): the mean gap between output
        tokens; a request of one token has none (nan, left out)."""
        if not self.ok or self.first is None or self.finish is None:
            return math.inf
        if self.tokens < 2:
            return math.nan
        return (self.finish - self.first) / (self.tokens - 1)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default), with ``inf`` for missing values kept
    in the ranking: a tail that reaches a missing request is infinite.
    Raises on an empty sample."""
    xs = sorted(v for v in values if not math.isnan(v))
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """``count`` over the window's ``seconds`` (all of them)."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds

