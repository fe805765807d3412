"""Serving configuration (port of ``repro.serving.config``): ``EngineConfig``
with the fields this port implements, and the ``CacheSpec`` it derives.

Mesh placement waits for the multi-GPU slice; the port has no kernel-mode
override (a tensor's device picks the kernel or its plain version)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import round_up
from repro_torch.core.cache import CacheLayout


@dataclass(frozen=True)
class CacheSpec:
    """Geometry of a paged KV cache: ``n_pages`` pages of ``page_size`` rows
    (page 0 is the reserved trash page), tables ``pages_per_seq`` wide."""
    layout: CacheLayout = CacheLayout.PAGED
    page_size: int = 64
    n_pages: int = 0
    max_len: int = 512

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_len // self.page_size)


@dataclass(frozen=True)
class EngineConfig:
    """Everything the engine allocates against.

    page_size:    KV rows per page (a positive multiple of 8)
    n_pages:      pool size incl. the trash page; ``None`` derives
                  ``max_batch * ceil(max_len / page_size) + 1``
    max_batch:    concurrent sequences (the decode batch dimension)
    max_len:      per-sequence row cap (``len(prompt) + max_new``)
    prefix_cache: share KV pages between requests with a common prompt
                  prefix (radix tree + copy-on-write)
    decode_chunk: decode steps per decode-only tick
    chunk_tokens: prompt tokens per mixed tick; ``None`` prefills each
                  prompt's whole suffix in one chunk (power-of-two buffer)
    eos_id:       optional stop token
    max_queue:    admission queue bound; past it ``submit`` finishes the
                  request at once as ``FinishReason.REJECTED`` with a
                  ``retry_after_s`` hint (never a silent drop)
    deadline_s:   default per-request deadline (seconds from submission,
                  queueing included); past it a request retires
                  ``FinishReason.DEADLINE``.  ``None``: no deadline;
                  ``submit(deadline_s=...)`` overrides it per request
    preemption:   page-pressure policy.  ``"off"``: admission reserves each
                  request's full page need.  ``"recompute"``: admission
                  reserves the prompt's pages only, decode rows grow
                  lazily, and on exhaustion the decoding slot with the
                  fewest tokens (ties: the latest arrival) is preempted and
                  requeued; its tokens recompute through chunked prefill.
                  ``"drop"``: the same victim retires
                  ``FinishReason.PREEMPTED`` with its partial output
    quant:        "w8a8" int8-quantizes the weights once at init
                  (``model.quantize_params``); None or "none" serves them as
                  given
    """
    page_size: int = 64
    n_pages: int | None = None
    max_batch: int = 8
    max_len: int = 512
    prefix_cache: bool = True
    decode_chunk: int = 8
    chunk_tokens: int | None = None
    eos_id: int | None = None
    max_queue: int = 1024
    deadline_s: float | None = None
    preemption: str = "off"
    quant: str | None = None

    def __post_init__(self):
        if self.quant not in (None, "none", "w8a8"):
            raise ValueError(f"quant={self.quant!r} must be None, 'none' or 'w8a8'")
        if self.page_size < 8 or self.page_size % 8:
            raise ValueError(f"page_size={self.page_size} must be a positive "
                             f"multiple of 8")
        if self.chunk_tokens is not None and self.chunk_tokens < 1:
            raise ValueError(f"chunk_tokens={self.chunk_tokens} must be >= 1 "
                             f"(or None for whole-suffix prefill)")
        if self.preemption not in ("off", "recompute", "drop"):
            raise ValueError(f"preemption={self.preemption!r} must be one of "
                             f"'off', 'recompute', 'drop'")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s={self.deadline_s} must be > 0 "
                             f"(or None for no deadline)")
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk={self.decode_chunk} must be >= 1")
        if self.max_len % self.page_size:
            object.__setattr__(self, "max_len",
                               round_up(self.max_len, self.page_size))
        if self.n_pages is None:
            object.__setattr__(self, "n_pages", self.max_batch
                               * (self.max_len // self.page_size) + 1)
        if self.n_pages < 2:
            raise ValueError("n_pages must be >= 2 (one usable page plus the "
                             "reserved trash page)")

    def cache_spec(self) -> CacheSpec:
        return CacheSpec(CacheLayout.PAGED, self.page_size, self.n_pages,
                         self.max_len)
