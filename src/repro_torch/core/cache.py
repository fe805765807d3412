"""Cache-layout vocabulary shared by the kernels, layers and serving engine.

- ``LINEAR`` — global-attention cache: rows ``[start, pos]`` are live.
- ``RING``   — sliding-window cache of size S.
- ``PAGED``  — block-table cache: logical rows ``[start, pos]`` live, mapped
  through a per-sequence page table onto a shared page pool.
- ``STATE``  — constant-size recurrent state; no row indexing.
"""
from __future__ import annotations

from enum import Enum


class CacheLayout(str, Enum):
    LINEAR = "linear"
    RING = "ring"
    PAGED = "paged"
    STATE = "state"

    def __str__(self) -> str:
        return self.value
