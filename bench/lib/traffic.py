"""The one traffic generator: every mix is a data file of parameters
(``bench/traffic/<mix>.json``) that this module reads.

A mix fixes the *set* of request sizes: ``pool`` user-turn lengths and
``pool`` output lengths drawn once from the mix's own ``pool_seed``.  A
run's ``--seed`` only rotates the order in which they are taken and draws
the token ids, so runs on different seeds do the same amount of work in
another order, and the spread between them is the system's and not the
generator's.  The order is a Kronecker sequence: request ``i`` takes the
user length at quantile ``frac(u + i * phi)`` and the output length at
``frac(v + i * (sqrt 2 - 1))`` of the sorted pools (``u``, ``v`` from the
seed), so any run of consecutive requests covers both distributions
evenly, which a shuffle does only on average.

Closed loop: ``clients`` callers each send their next request when the
last one finishes.  Client ``c``'s ``k``-th request is request ``i = k C
+ c``, so the requests in flight at any time are spread over the
distributions as well.  With ``shared_prefixes`` P > 0, client
``c``'s prompts all begin with shared prefix ``c % P`` of
``prefix_tokens`` ids (a system prompt), followed by the request's own
user tokens; without, a prompt is its user tokens alone.

Length distributions (``{"dist": ...}``): ``lognormal`` (``median``,
``sigma``), ``uniform`` (inclusive integers), both clipped to
``[min, max]``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GOLDEN = 0.6180339887498949  # (sqrt 5 - 1) / 2
SILVER = 0.4142135623730951  # sqrt 2 - 1


def _seed_words(seed: int) -> list[int]:
    """A seed of any size or sign as 32-bit words for numpy."""
    s = int(seed)
    words = [1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFF_FFFF)
        s >>= 32
        if not s:
            return words


def rng(*keys: int) -> np.random.Generator:
    """A numpy generator keyed by one or more whole numbers of any size."""
    words: list[int] = []
    for k in keys:
        w = _seed_words(k)
        words.extend([len(w), *w])
    return np.random.default_rng(words)


def draw_lengths(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths from a length spec, clipped to its range."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(float(spec["median"])) + float(spec["sigma"]) * gen.standard_normal(n))
        out = np.rint(x)
    elif spec["dist"] == "uniform":
        out = gen.integers(lo, hi + 1, size=n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(out, lo, hi).astype(np.int64)


@dataclass(frozen=True)
class RequestSpec:
    client: int
    prompt: list[int]
    max_new: int


class Traffic:
    """The request streams of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(mix["clients"])
        pool = int(mix["pool"])
        fixed = rng(int(mix["pool_seed"]))
        self.user_len = np.sort(draw_lengths(mix["prompt_tokens"], pool, fixed))
        self.out_len = np.sort(draw_lengths(mix["output_tokens"], pool, fixed))
        self.u0, self.v0 = rng(self.seed, 0).random(2)
        P = int(mix.get("shared_prefixes", 0))
        self.prefixes = [rng(self.seed, 1, p).integers(0, self.vocab, int(mix["prefix_tokens"]))
                         .tolist() for p in range(P)]
        self._next = [0] * self.clients

    @property
    def max_prompt(self) -> int:
        pre = int(self.mix["prefix_tokens"]) if self.prefixes else 0
        return pre + int(self.mix["prompt_tokens"]["max"])

    @property
    def max_request_rows(self) -> int:
        return self.max_prompt + int(self.mix["output_tokens"]["max"])

    def request(self, client: int, index: int) -> RequestSpec:
        """Client ``client``'s ``index``-th request (a pure function of the
        seed, the client and the index)."""
        i = index * self.clients + client
        n = len(self.user_len)
        ju = int(((self.u0 + i * GOLDEN) % 1.0) * n)
        jo = int(((self.v0 + i * SILVER) % 1.0) * n)
        user = rng(self.seed, 2, client, index).integers(0, self.vocab, int(self.user_len[ju]))
        p = client % len(self.prefixes) if self.prefixes else -1
        prompt = (self.prefixes[p] if p >= 0 else []) + user.tolist()
        return RequestSpec(client, prompt, int(self.out_len[jo]))

    def next(self, client: int) -> RequestSpec:
        """The next request of ``client`` in its closed loop."""
        k = self._next[client]
        self._next[client] = k + 1
        return self.request(client, k)


class Documents:
    """A training job's feed: documents of ``doc_tokens`` lengths (a length
    spec as above) of uniform token ids, each closed by ``separator``,
    packed end to end into ``rows`` rows of ``seq_len`` inputs and their
    next-token labels.  Every step's rows are new, and a step's tokens are a
    pure function of the seed and the step; every seed does the same work
    (``rows x seq_len`` tokens a step)."""

    def __init__(self, job: dict, seed: int, vocab: int):
        self.job, self.seed, self.vocab = job, int(seed), int(vocab)
        self.rows, self.seq = int(job["rows"]), int(job["seq_len"])
        if not 0 <= int(job["separator"]) < self.vocab:
            raise ValueError(f"separator {job['separator']} is not a token of a "
                             f"{vocab}-token vocabulary")

    def _stream(self, step: int, n: int) -> np.ndarray:
        g = rng(self.seed, 20, step)
        out, have = [], 0
        while have < n:
            k = int(draw_lengths(self.job["doc_tokens"], 1, g)[0])
            out.append(g.integers(0, self.vocab, k))
            out.append(np.array([int(self.job["separator"])]))
            have += k + 1
        return np.concatenate(out)[:n]

    def batch(self, step: int) -> dict:
        """``tokens`` and ``labels`` [rows, seq_len] int32 for ``step``."""
        t = self._stream(step, self.rows * (self.seq + 1)).reshape(self.rows, self.seq + 1)
        t = t.astype(np.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
