"""Deterministic synthetic data with prefetch (port of
``repro.data.pipeline``; numpy only, no tensors until :func:`to_device`).

Stateless by design: ``batch_at(step)`` is a pure function of (seed, step)
-- numpy's ``default_rng((seed, step))``, the reference's own stream, so
both packages draw the same batches bit for bit -- and a restart resumes the
exact token stream with no loader state to save.  The stream mixes
Zipf-distributed tokens with copied spans (induction patterns), so a small
model has something to learn.  Over a mesh every rank draws the same global
batch and keeps its own rows (:func:`local_batch`), split as the
reference's ``batch`` rule splits them.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, cfg, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.zipf = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> dict:
        """``tokens`` [B, S] and ``labels`` [B, S] int32 (the next token);
        a vision config adds ``images`` [B, vision_tokens, vision_dim], an
        audio frontend ``frames`` [B, S, frontend_dim] in place of tokens
        (one label a frame); f32."""
        rng = np.random.default_rng((self.seed, step))
        B, S, v = self.batch, self.seq + 1, self.cfg.vocab_size
        toks = rng.choice(v, size=(B, S), p=self.zipf).astype(np.int32)
        # induction heads: repeat a random span later in the sequence
        span = max(4, S // 16)
        for b in range(B):
            src = rng.integers(0, S - 2 * span)
            dst = rng.integers(src + span, S - span)
            toks[b, dst:dst + span] = toks[b, src:src + span]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.vision_tokens:
            batch["images"] = rng.standard_normal(
                (B, self.cfg.vision_tokens, self.cfg.vision_dim)).astype(np.float32)
        if self.cfg.audio_frontend:
            batch["frames"] = rng.standard_normal(
                (B, self.seq, self.cfg.frontend_dim)).astype(np.float32)
            batch.pop("tokens")
        return batch


def local_batch(batch: dict, mesh, profile=None, accum_steps: int = 1) -> dict:
    """This rank's rows of a global ``batch`` (numpy arrays or tensors with
    the batch leading): the split ``launch.sharding.resolve_pspec`` gives a
    ``batch`` dim -- pod-major over the profile's batch axes, its graded
    fallback included, so a batch it cannot split is replicated.  With
    ``accum_steps`` the rows are this rank's share of each of the
    ``accum_steps`` microbatches the step cuts the batch into, in order
    (each microbatch split as a batch of its own)."""
    from repro_torch.launch.sharding import batch_rows
    B = next(iter(batch.values())).shape[0]
    sl = batch_rows(mesh, B // accum_steps, profile)

    def take(v):
        v = v.reshape(accum_steps, B // accum_steps, *v.shape[1:])[:, sl]
        return v.reshape(-1, *v.shape[2:])

    return {k: take(v) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device`` (tensors already there are
    returned as they are)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                               device=device)
            for k, v in batch.items()}


def prefetching(source: SyntheticLM, start_step: int, device=None,
                depth: int = 2) -> Iterator[dict]:
    """Batches ``start_step, start_step + 1, ...`` made by a background
    thread ``depth`` ahead of the consumer (on ``device`` as tensors when
    one is given, else numpy)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        s = start_step
        while not stop.is_set():
            b = source.batch_at(s)
            if device is not None:
                b = to_device(b, device)
            q.put(b)
            s += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
