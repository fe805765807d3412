"""Continuous-batching serving engine over a paged KV cache (port of
``repro.serving.engine``).

The split is the JAX engine's: a host-side :class:`Scheduler` (admission,
chunk budgeting, the QUEUED -> PREFILLING(offset) -> DECODING -> RETIRED
slot state machine, page and radix accounting), a device-side
:class:`ModelRunner` (params, page pools, the decode chunk, the mixed step
and the copy-on-write page copy) and :class:`Engine`, the facade whose
:meth:`Engine.step` runs one tick:

- a *mixed* tick when a slot is prefilling: up to ``chunk_tokens`` of its
  prompt through ``model.chunk_step`` plus one decode step for every other
  slot, or
- a *decode* tick of ``decode_chunk`` decode steps otherwise.

Both tick shapes run their decode steps through one function,
:meth:`ModelRunner._decode_steps`, so a token's math does not depend on
which tick produced it.  Its decode step is a :class:`~repro_torch.models.
graph.DecodeGraph`: captured once as a CUDA graph on the card (B =
``max_batch``) and replayed once a step, the counterpart of the JAX
runner's compiled ``lax.scan``; on the CPU the same function runs eagerly.
The sample-and-update tail after it stays eager.

Kept from the JAX engine: radix prefix reuse with the copy-on-write page
copy, trash-page freezing of retired and prefilling rows (page 0, ``pos =
0``), and every :class:`FinishReason`.  The page pools are updated in
place (JAX donates them).  Each tick copies its inputs to the device once
and reads its outputs back once — one host sync per tick.

Resilience, as in the JAX engine: per-request deadlines against the
engine clock, :meth:`Engine.cancel` and :meth:`Engine.close`, the bounded
queue's ``REJECTED`` answer with a ``retry_after_s`` hint, and — behind
``EngineConfig(preemption="recompute" | "drop")`` — prompt-only page
reservation with lazy decode-row growth and preemption of the decoding
slot with the fewest tokens (ties: the latest arrival).  Fault isolation
happens inside the decode step: a live slot whose logits go non-finite
(or that the chaos harness's ``logits.nan`` point poisons through the
``nanmask`` buffer) freezes on that step and retires ``FAULT`` with the
tokens it had; the other slots go on.  ``Engine(..., chaos=
ChaosInjector(...))`` drives the fault points and the clock
(:mod:`repro_torch.serving.chaos`).

Sampling: greedy is ``argmax`` (the first maximum, as ``jnp.argmax``).
Temperature > 0 draws from a per-request ``torch.Generator`` seeded from
the request's seed; it advances only while the request is the one being
sampled, so a request's tokens depend on its seed and its own logits alone.
A preempted request keeps its generator, so its stream continues across
the preemption as the JAX engine's saved key does.  ``jax.random``'s
streams cannot be reproduced, so sampled tokens match the JAX engine's only
in distribution.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device, round_up
from repro_torch.models import model as M
from repro_torch.models.graph import DecodeGraph
from repro_torch.serving.chaos import ChaosError, ChaosInjector
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.paging import (PagePool, PrefixMatch, RadixCache,
                                        check_invariants)


def bytes_tokenizer_encode(text: str, vocab: int) -> list[int]:
    return [b % vocab for b in text.encode("utf-8")]


class FinishReason(str, Enum):
    """Why a request retired.  ``STOP``/``LENGTH`` are healthy completions;
    everything else is a degraded exit."""
    STOP = "stop"            # emitted eos_id
    LENGTH = "length"        # emitted max_new tokens
    DEADLINE = "deadline"    # per-request deadline expired
    CANCELLED = "cancelled"  # Engine.cancel / Engine.close
    PREEMPTED = "preempted"  # evicted under page pressure (preemption="drop")
    FAULT = "fault"          # non-finite logits: slot isolated from the batch
    REJECTED = "rejected"    # bounded queue refused admission at submit


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    temperature: float = 0.0
    seed: int = 0
    arrival_s: float = 0.0
    #: optional budget (seconds from arrival); past it the request retires
    #: DEADLINE wherever it is (queued or in flight)
    deadline_s: float | None = None
    # -- preemption/recompute carry-state (engine-internal) ----------------
    #: tokens generated before a preemption; on re-admission the slot
    #: prefills prompt + resume_tokens and continues where it left off
    resume_tokens: list[int] = field(default_factory=list)
    #: the request's generator (temperature > 0) as of the preemption
    resume_gen: torch.Generator | None = None
    first_token_s: float | None = None
    token_times: list[float] = field(default_factory=list)
    preemptions: int = 0

    def full_prompt(self) -> list[int]:
        """Rows to prefill: the prompt plus any tokens generated before a
        preemption."""
        return list(self.prompt) + list(self.resume_tokens)


@dataclass
class RequestResult:
    rid: int
    prompt: list[int]
    generated: list[int]
    arrival_s: float
    first_token_s: float
    finish_s: float
    #: emission time of each generated token (tick granularity)
    token_times_s: list[float] = field(default_factory=list)
    finish_reason: FinishReason = FinishReason.LENGTH
    #: backpressure hint on REJECTED results: seconds after which a retry
    #: plausibly finds queue room
    retry_after_s: float | None = None

    @property
    def ok(self) -> bool:
        """True for healthy completions (STOP / LENGTH)."""
        return self.finish_reason in (FinishReason.STOP, FinishReason.LENGTH)

    @property
    def tokens(self) -> list[int]:
        return list(self.prompt) + list(self.generated)

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def itl_s(self) -> list[float]:
        """Inter-token gaps (seconds) between consecutive emissions."""
        t = self.token_times_s
        return [b - a for a, b in zip(t, t[1:])]


@dataclass
class ServeStats:
    prefill_s: float = 0.0   # wall time of mixed ticks
    decode_s: float = 0.0    # wall time of decode-only ticks
    tokens_out: int = 0
    prefills: int = 0
    chunks: int = 0          # decode-only ticks
    mixed_steps: int = 0     # mixed ticks
    peak_active: int = 0
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0
    # resilience counters: one increment per event
    preempted: int = 0
    rejected: int = 0
    deadline_expired: int = 0
    cancelled: int = 0
    faults_isolated: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        return (self.prefix_hit_tokens / self.prefix_lookup_tokens
                if self.prefix_lookup_tokens else 0.0)


PREFILLING = "prefilling"
DECODING = "decoding"


@dataclass
class _Slot:
    req: Request
    emitted: list[int] = field(default_factory=list)
    first_token_s: float = 0.0
    phase: str = DECODING
    offset: int = 0        # prompt rows already in pages (incl. radix hit)
    seq: int = 0           # admission order
    gen: torch.Generator | None = None  # temperature > 0 only
    token_times: list[float] = field(default_factory=list)


# ---------------------------------------------------------------------------
# ModelRunner: params, page pools and the per-tick device work
# ---------------------------------------------------------------------------

class ModelRunner:
    """Owns the device state (params, paged pools, the decode graph) and
    runs the decode chunk, the mixed step and the copy-on-write page copy
    on it."""

    def __init__(self, cfg: ArchConfig, params, config: EngineConfig, device):
        self.cfg = cfg
        self.device = device
        self.params = params
        self.vocab = cfg.vocab_size
        self.eos_id = config.eos_id
        self.caches = M.init_paged_cache(cfg, config.max_batch, config.n_pages,
                                         config.page_size, device=device)
        self.graph = DecodeGraph(cfg, params, self.caches, config.max_batch,
                                 config.cache_spec().pages_per_seq, device)

    def _sample(self, lf, temps, gens):
        """lf [B, V] f32 -> [B] int32.  Rows with ``temps[i] > 0`` draw from
        ``gens[i]``; the rest take the first maximum.  A non-finite logit
        draws as 0 (its slot faults and the token is discarded; the
        generator advances as the JAX key does)."""
        nxt = torch.argmax(lf, -1).to(torch.int32)
        for i, (t, g) in enumerate(zip(temps, gens)):
            if t > 0.0:
                probs = torch.softmax(torch.nan_to_num(lf[i] / t, nan=0.0, posinf=0.0,
                                                       neginf=0.0), -1)
                nxt[i] = torch.multinomial(probs, 1, generator=g)[0].to(torch.int32)
        return nxt

    def _decode_steps(self, remaining, temps, gens, steps):
        """``steps`` decode steps from the tokens, positions, tables and
        ``nanmask`` already in the graph's buffers — the JAX runner's ``_dec_body``.  A slot is
        active while ``remaining > 0``; a live slot whose logits are not
        finite freezes on that step (no token, ``remaining`` 0) and its
        ``ok`` flag falls; a frozen slot keeps its token and row and cannot
        fault.  Returns the new state and per-step tokens and ok flags
        [B, steps]."""
        g = self.graph
        toks, oks = [], []
        for _ in range(steps):
            active = remaining > 0
            lf, finite = g.run()
            nxt = self._sample(lf, temps, gens)
            ok = finite | ~active
            live = active & finite
            nxt = torch.where(live, nxt, g.cur)
            step = live.to(torch.int32)
            remaining = torch.where(ok, remaining - step, 0)
            if self.eos_id is not None:
                remaining = torch.where(live & (nxt == self.eos_id), 0, remaining)
            g.pos.add_(step)
            g.cur.copy_(nxt)
            toks.append(nxt)
            oks.append(ok)
        return g.cur, g.pos, remaining, torch.stack(toks, 1), torch.stack(oks, 1)

    def decode(self, pages, cur, pos, remaining, nanmask, temps, gens, steps: int):
        """Decode-only tick.  Host arrays in, one device->host copy out:
        [B, 3 + 2*steps] int32 = cur, pos, remaining, tokens, ok flags."""
        state = torch.from_numpy(np.stack([cur, pos, remaining])).to(self.device)
        self.graph.load(state[0], state[1], pages, nanmask)
        c, p, r, toks, oks = self._decode_steps(state[2], temps, gens, steps)
        out = torch.cat([c[:, None], p[:, None], r[:, None], toks,
                         oks.to(torch.int32)], 1)
        return out.cpu().numpy()

    def mixed(self, buf, chunk_pages, past: int, n: int, chunk_temp: float,
              chunk_gen, chunk_nan: bool, dec_pages, cur, pos, remaining,
              nanmask, temps, gens):
        """Mixed tick: an ``n``-row prompt chunk (buffer ``buf`` [1, C]) at
        rows ``[past, past + n)`` plus one decode step per slot.  Returns
        (tok0, chunk_ok, [B, 5] decode state as in :meth:`decode`);
        ``chunk_nan`` poisons the chunk's logits."""
        dev = self.device
        state = torch.from_numpy(np.stack([cur, pos, remaining])).to(dev)
        tables = torch.from_numpy(np.concatenate([chunk_pages, dec_pages])).to(dev)
        buf_t = torch.from_numpy(buf).to(dev)
        logits, _ = M.chunk_step(self.cfg, self.params, self.caches, buf_t,
                                 tables[:1], past, n)
        lf = logits[:, -1, : self.vocab]
        if chunk_nan:
            lf = torch.full_like(lf, float("nan"))
        tok0 = self._sample(lf, [chunk_temp], [chunk_gen])
        self.graph.load(state[0], state[1], tables[1:], nanmask)
        c, p, r, toks, oks = self._decode_steps(state[2], temps, gens, 1)
        head = torch.stack([tok0[0], torch.isfinite(lf).all().to(torch.int32)])
        out = torch.cat([head, torch.cat([c[:, None], p[:, None], r[:, None],
                                          toks, oks.to(torch.int32)], 1).reshape(-1)])
        out = out.cpu().numpy()
        return int(out[0]), bool(out[1]), out[2:].reshape(len(cur), 5)

    def copy_page(self, src: int, dst: int):
        """Copy page ``src`` -> ``dst`` in every pool (the copy half of a
        partial-page prefix share)."""
        for stage in self.caches:
            for group in stage.values():
                for pool in group.values():
                    pool[:, dst].copy_(pool[:, src])


# ---------------------------------------------------------------------------
# Scheduler: admission, chunk budgeting, slot state machine
# ---------------------------------------------------------------------------

class Scheduler:
    """Host-side request bookkeeping: the bounded FIFO queue, per-slot numpy
    state (page tables, tokens, positions, budgets), page/radix accounting
    and the slot state machine, with the degraded exits (DEADLINE /
    CANCELLED / PREEMPTED / FAULT) layered on."""

    def __init__(self, config: EngineConfig, device, clock=time.time):
        B = config.max_batch
        self.config = config
        self.device = device
        self.clock = clock
        self.page_size = config.page_size
        self.max_batch = B
        self.npp = config.cache_spec().pages_per_seq
        self.pool = PagePool(config.n_pages)
        # preemption implies lazy page reservation: admission takes only the
        # prompt's pages and decode rows grow tick by tick
        self.lazy = config.preemption != "off"
        self.radix: RadixCache | None = (
            RadixCache(config.page_size, self.pool) if config.prefix_cache
            else None)
        self.pages = np.zeros((B, self.npp), np.int32)  # 0 == trash page
        self.owned: list[list[int]] = [[] for _ in range(B)]
        self.cur = np.zeros(B, np.int32)        # next input token per slot
        self.pos = np.zeros(B, np.int32)        # its logical cache row
        self.limit = np.zeros(B, np.int32)      # reserved rows
        self.remaining = np.zeros(B, np.int32)  # tokens still to emit
        self.queue: deque[Request] = deque()
        self.slots: list[_Slot | None] = [None] * B
        self.finished: list[RequestResult] = []
        self._seq = 0

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.page_size)

    def prefilling_slot(self) -> int | None:
        cands = [i for i, s in enumerate(self.slots)
                 if s is not None and s.phase == PREFILLING]
        return min(cands, key=lambda j: self.slots[j].seq) if cands else None

    def next_chunk(self) -> tuple[int, int] | None:
        """(slot, n): up to ``chunk_tokens`` rows of the oldest prefilling
        slot (its whole remaining suffix when chunking is off)."""
        i = self.prefilling_slot()
        if i is None:
            return None
        slot = self.slots[i]
        left = len(slot.req.full_prompt()) - slot.offset
        ct = self.config.chunk_tokens
        return i, (left if ct is None else min(ct, left))

    def _ensure_free_pages(self, fresh_needed: int) -> bool:
        """True when the pool can supply ``fresh_needed`` pages, evicting
        radix-cached pages only if eviction actually gets there."""
        if self.pool.num_free >= fresh_needed:
            return True
        if self.radix is None:
            return False
        if self.pool.num_free + self.radix.num_evictable() < fresh_needed:
            return False
        self.radix.evict(fresh_needed)
        return True

    def decode_sampling(self):
        """Per-slot (temps, gens) for a decode step: only DECODING slots
        sample, so a request's generator advances on its own draws alone."""
        temps, gens = [0.0] * self.max_batch, [None] * self.max_batch
        for i, s in enumerate(self.slots):
            if s is not None and s.phase == DECODING:
                temps[i], gens[i] = s.req.temperature, s.gen
        return temps, gens

    # -- degraded exits ---------------------------------------------------

    def queue_result(self, req: Request, now: float,
                     reason: FinishReason) -> RequestResult:
        """Result for a request that exits without (re)gaining a slot;
        tokens generated before a preemption are kept."""
        return RequestResult(
            req.rid, req.prompt, list(req.resume_tokens), req.arrival_s,
            req.first_token_s if req.first_token_s is not None else now,
            now, token_times_s=list(req.token_times), finish_reason=reason)

    def _expired(self, req: Request, now: float) -> bool:
        return req.deadline_s is not None and now - req.arrival_s > req.deadline_s

    def expire(self, now: float, stats: ServeStats):
        """Retire every request whose deadline has passed: queued ones exit
        empty-handed, in-flight slots keep their partial output."""
        for req in [r for r in self.queue if self._expired(r, now)]:
            self.queue.remove(req)
            stats.deadline_expired += 1
            self.finished.append(self.queue_result(req, now, FinishReason.DEADLINE))
        for i, slot in enumerate(self.slots):
            if slot is not None and self._expired(slot.req, now):
                stats.deadline_expired += 1
                self.retire(i, now, FinishReason.DEADLINE)

    def cancel(self, rid: int, now: float, stats: ServeStats) -> bool:
        """Cancel a request wherever it is; False if unknown/finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                stats.cancelled += 1
                self.finished.append(self.queue_result(req, now, FinishReason.CANCELLED))
                return True
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.req.rid == rid:
                stats.cancelled += 1
                self.retire(i, now, FinishReason.CANCELLED)
                return True
        return False

    def _pick_victim(self) -> int | None:
        """The lowest-priority DECODING slot: fewest tokens generated, ties
        by latest arrival (then latest admission)."""
        cands = [i for i, s in enumerate(self.slots)
                 if s is not None and s.phase == DECODING]
        if not cands:
            return None
        return min(cands, key=lambda j: (len(self.slots[j].emitted),
                                         -self.slots[j].req.arrival_s,
                                         -self.slots[j].seq))

    def _release(self, i: int):
        """Free slot ``i``'s row: pages back (radix-held ones survive at
        rc >= 1), table to the trash page, state zeroed."""
        self.slots[i] = None
        for pid in self.owned[i]:
            self.pool.decref(pid)
        self.owned[i] = []
        self.pages[i] = 0  # trash page: frozen-row writes land harmlessly
        self.pos[i] = self.cur[i] = self.remaining[i] = 0

    def preempt(self, i: int, stats: ServeStats):
        """Evict slot ``i``: free its pages and requeue it at the head for
        recompute (``"recompute"``: its tokens re-enter as prefill input),
        or retire it PREEMPTED with its partial output (``"drop"``, or
        nothing left to generate)."""
        now = self.clock()
        slot = self.slots[i]
        req = slot.req
        stats.preempted += 1
        if self.config.preemption == "drop" or len(slot.emitted) >= req.max_new:
            self.retire(i, now, FinishReason.PREEMPTED)
            return
        req.resume_tokens = list(slot.emitted)
        req.resume_gen = slot.gen
        req.first_token_s = slot.first_token_s
        req.token_times = list(slot.token_times)
        req.preemptions += 1
        self._release(i)
        self.queue.appendleft(req)  # preempted requests keep queue priority

    def ensure_rows(self, i: int, rows: int, stats: ServeStats) -> bool:
        """Lazy page growth: make slot ``i``'s table cover ``rows`` rows.
        On exhaustion: radix-evict, then preempt the lowest-priority
        decoding slot (``i`` itself when it is the lowest).  Returns False
        when ``i`` no longer holds its slot."""
        need = -(-rows // self.page_size)
        tries = 0
        while len(self.owned[i]) < need:
            pid = self.pool.alloc()
            if pid is not None:
                self.pages[i][len(self.owned[i])] = pid
                self.owned[i].append(pid)
                tries = 0
                continue
            tries += 1
            if tries <= 2 and self._ensure_free_pages(1):
                continue  # radix evicted / transient alloc fault: retry
            victim = self._pick_victim()
            if victim is None or victim == i:
                self.preempt(i, stats)  # i is lowest-priority: yield
                return False
            self.preempt(victim, stats)
            tries = 0
        return True

    def grow_for_decode(self, steps_bound: int, stats: ServeStats):
        """Grow every decoding slot's table to cover the rows of the next
        ``steps_bound`` steps, highest priority first."""
        order = sorted(
            [i for i, s in enumerate(self.slots)
             if s is not None and s.phase == DECODING],
            key=lambda j: (-len(self.slots[j].emitted),
                           self.slots[j].req.arrival_s, self.slots[j].seq))
        for i in order:
            if self.slots[i] is None:
                continue  # preempted as a victim earlier in this pass
            steps = min(int(self.remaining[i]), steps_bound)
            if steps:
                self.ensure_rows(i, int(self.pos[i]) + steps, stats)

    # -- admission --------------------------------------------------------

    def admit(self, runner: ModelRunner):
        """Move queued requests into free rows, FIFO with head-of-line
        blocking on pages.  A new slot enters PREFILLING at its radix
        offset and admission holds until its prefill completes (lookups
        never match unpublished pages).  Matched pages (and the COW donor)
        are pinned before eviction can run.  With preemption on, only the
        prompt's pages are reserved.  A preempted request re-enters here:
        prompt plus generated tokens prefill as one sequence."""
        free_rows = [i for i in range(self.max_batch) if self.slots[i] is None]
        while self.queue and free_rows:
            if self.prefilling_slot() is not None:
                break
            req = self.queue[0]
            full = req.full_prompt()
            plen = len(full)
            new_budget = req.max_new - len(req.resume_tokens)
            need = self.pages_needed(plen, 0 if self.lazy else new_budget)
            if self.radix is not None:
                ht, lt = self.radix.hit_tokens, self.radix.lookup_tokens
                m = self.radix.match(full, max_match=plen - 1)
            else:
                m = PrefixMatch()
            fresh_needed = need - len(m.full_pages)
            pinned = list(m.full_pages)
            if m.partial is not None:
                pinned.append(m.partial[0])
            for pid in pinned:
                self.pool.incref(pid)
            ok = self._ensure_free_pages(fresh_needed)
            if not ok and m.partial is not None:
                # the pinned donor may be the page eviction is short of:
                # drop the copy-on-write share rather than deadlock
                self.pool.decref(pinned.pop())
                self.radix.hit_tokens -= m.partial[1]
                m.partial = None
                m.tokens = len(m.full_pages) * self.page_size
                ok = self._ensure_free_pages(fresh_needed)
            fresh: list[int] = []
            if ok:
                for _ in range(fresh_needed):
                    pid = self.pool.alloc()
                    if pid is None:  # transient alloc fault (chaos)
                        break
                    fresh.append(pid)
                ok = len(fresh) == fresh_needed
            if not ok:
                for pid in fresh + pinned:
                    self.pool.decref(pid)
                if self.radix is not None:  # blocked: don't count the lookup
                    self.radix.hit_tokens, self.radix.lookup_tokens = ht, lt
                break
            self.queue.popleft()
            i = free_rows.pop(0)
            shared = list(m.full_pages)  # pins transfer to slot ownership
            table = np.zeros(self.npp, np.int32)
            table[: len(shared)] = shared
            table[len(shared): len(shared) + len(fresh)] = fresh
            if m.partial is not None:
                donor, _rows = m.partial
                runner.copy_page(donor, fresh[0])
                self.pool.decref(donor)  # COW copy done: release the pin
            gen = req.resume_gen
            if gen is None and req.temperature > 0.0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(req.seed & 0xFFFF_FFFF_FFFF_FFFF)
            self.pages[i] = table
            self.owned[i] = shared + fresh
            self.limit[i] = plen + new_budget
            self.slots[i] = _Slot(req, emitted=list(req.resume_tokens),
                                  first_token_s=req.first_token_s or 0.0,
                                  phase=PREFILLING, offset=m.tokens,
                                  seq=self._seq, gen=gen,
                                  token_times=list(req.token_times))
            self._seq += 1
            self.cur[i] = self.pos[i] = self.remaining[i] = 0
            break  # hold admission until this prefill completes

    def commit_prefill(self, i: int, first: int, now: float,
                       stats: ServeStats) -> bool:
        """The last chunk of slot ``i``'s prompt ran: publish its full pages
        to the radix tree, take the first token and flip to DECODING (or
        retire at once).  Returns True if retired."""
        slot = self.slots[i]
        req = slot.req
        full = req.full_prompt()
        plen = len(full)
        if self.radix is not None:
            fp = plen // self.page_size
            self.radix.insert(full[: fp * self.page_size],
                              [int(self.pages[i][j]) for j in range(fp)])
        slot.phase = DECODING
        slot.emitted = list(req.resume_tokens) + [first]
        slot.first_token_s = (req.first_token_s if req.first_token_s is not None
                              else now)
        slot.token_times = list(req.token_times) + [now]
        self.cur[i], self.pos[i] = first, plen
        self.remaining[i] = req.max_new - len(slot.emitted)
        stats.prefills += 1
        stats.tokens_out += 1
        if self.remaining[i] == 0 or first == self.config.eos_id:
            self.remaining[i] = 0
            self.retire(i, now)
            return True
        return False

    def retire(self, i: int, now: float, reason: FinishReason | None = None):
        s = self.slots[i]
        if reason is None:
            eos = self.config.eos_id
            reason = (FinishReason.STOP if eos is not None and s.emitted
                      and s.emitted[-1] == eos else FinishReason.LENGTH)
        self.finished.append(RequestResult(
            s.req.rid, s.req.prompt, s.emitted, s.req.arrival_s,
            s.first_token_s, now, token_times_s=list(s.token_times),
            finish_reason=reason))
        self._release(i)

    def check_capacity(self, steps_bound: int, stats: ServeStats):
        """Refuse to decode a slot past its reserved rows.  With preemption
        on, the engine degrades instead of raising: the slot is preempted
        (requeue or drop), which re-derives its accounting on
        re-admission."""
        for i, slot in enumerate(self.slots):
            if slot is None or slot.phase != DECODING:
                continue
            steps = min(int(self.remaining[i]), steps_bound)
            if self.pos[i] + steps <= self.limit[i]:
                continue
            if self.lazy:
                self.preempt(i, stats)
                continue
            raise RuntimeError(
                f"slot {i} (rid={slot.req.rid}): decoding {steps} steps "
                f"from pos={int(self.pos[i])} overruns its "
                f"{int(self.limit[i])} reserved rows")


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Continuous-batching engine over a fixed params dict::

        eng = Engine(cfg, params, EngineConfig(max_batch=8, max_len=1024,
                                               page_size=64, chunk_tokens=64))

    Runs on ``cuda`` unless ``device`` says otherwise; ``params`` must live
    on that device.  Without a card and without ``device="cpu"`` it raises.

    Resilience surface: per-request deadlines (``submit(deadline_s=...)``),
    :meth:`cancel`, :meth:`close` (also the context-manager exit), the
    bounded queue's REJECTED answer with a ``retry_after_s`` hint, and
    preemption behind ``EngineConfig(preemption=...)``.  Pass
    ``chaos=ChaosInjector(...)`` to drive the fault points
    deterministically (the injector also becomes the engine's clock).
    """

    def __init__(self, cfg: ArchConfig, params,
                 config: EngineConfig | None = None, device=None,
                 chaos: ChaosInjector | None = None):
        self.device = resolve_device(device)
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine on {self.device}")
        self.config = config or EngineConfig()
        if self.config.quant == "w8a8":
            params = M.quantize_params(cfg, params)  # idempotent
        self.cfg, self.params = cfg, params
        self.max_len = self.config.max_len
        self.max_batch = self.config.max_batch
        self.stats = ServeStats()
        self.chaos = chaos
        self._closed = False
        self.runner = ModelRunner(cfg, params, self.config, self.device)
        self.sched = Scheduler(self.config, self.device, clock=self._now)
        if chaos is not None:
            self.sched.pool.fault = lambda: chaos.fire("pool.alloc")
        self._next_rid = 0

    def _now(self) -> float:
        """The engine clock: the chaos injector's skewed clock when one is
        attached, wall time otherwise."""
        return self.chaos.now() if self.chaos is not None else time.time()

    @property
    def pool(self) -> PagePool:
        return self.sched.pool

    @property
    def radix(self) -> RadixCache | None:
        return self.sched.radix

    @property
    def num_active(self) -> int:
        return self.sched.num_active

    @property
    def num_queued(self) -> int:
        return len(self.sched.queue)

    @property
    def prefix_hit_rate(self) -> float:
        return self.radix.hit_rate if self.radix else 0.0

    def submit(self, prompt: list[int], max_new: int = 32,
               temperature: float = 0.0, seed: int = 0,
               deadline_s: float | None = None) -> int:
        """Queue a request; returns its rid.  Raises ``ValueError`` on
        malformed input or a request that can never fit.  Queue overflow
        does not raise: the request finishes at once as ``REJECTED`` with a
        ``retry_after_s`` hint (collected from ``step()`` / ``run()``).
        ``deadline_s`` (seconds from now; default
        ``EngineConfig.deadline_s``) bounds the request's life across
        queueing and execution."""
        if self._closed:
            raise RuntimeError("engine is closed; create a new Engine")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if not all(isinstance(t, (int, np.integer))
                   and 0 <= t < self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt tokens must be ints in "
                             f"[0, {self.cfg.vocab_size})")
        if not isinstance(max_new, (int, np.integer)) or max_new < 1:
            raise ValueError(f"max_new={max_new!r} must be an int >= 1")
        if temperature < 0.0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        if deadline_s is None:
            deadline_s = self.config.deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} must be > 0")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"request needs {len(prompt) + max_new} cache "
                             f"rows > max_len={self.max_len}")
        need = self.sched.pages_needed(len(prompt), max_new)
        if need > self.pool.n_pages - 1:
            raise ValueError(f"request needs {need} pages > pool capacity "
                             f"{self.pool.n_pages - 1}")
        now = self._now()
        rid = self._next_rid
        self._next_rid += 1
        if len(self.sched.queue) >= self.config.max_queue:
            self.stats.rejected += 1
            self.sched.finished.append(RequestResult(
                rid, [int(t) for t in prompt], [], now, now, now,
                finish_reason=FinishReason.REJECTED,
                retry_after_s=self._retry_hint()))
            return rid
        self.sched.queue.append(Request(rid, [int(t) for t in prompt],
                                        int(max_new), float(temperature),
                                        int(seed), arrival_s=now,
                                        deadline_s=deadline_s))
        return rid

    def _retry_hint(self) -> float:
        """Backpressure hint for REJECTED results: the least-remaining
        in-flight slot's tokens at the observed decode rate (50 ms a token
        before any decode has run)."""
        rem = [int(self.sched.remaining[i])
               for i, s in enumerate(self.sched.slots) if s is not None]
        per_tok = (self.stats.decode_s / self.stats.tokens_out
                   if self.stats.tokens_out and self.stats.decode_s else 0.05)
        return round(max(min(rem) if rem else 1, 1) * max(per_tok, 1e-3), 3)

    def cancel(self, rid: int) -> bool:
        """Cancel a request by rid, queued or in flight: its partial output
        comes back as a CANCELLED result from the next ``step()``, its
        pages free at once.  False when the rid is unknown or done."""
        return self.sched.cancel(rid, self._now(), self.stats)

    def close(self) -> list[RequestResult]:
        """Retire everything queued or in flight as CANCELLED, free every
        page and check that the paging state reconciles to its initial
        state (``paging.check_invariants``, free list full).  Returns the
        drained results.  Idempotent; ``submit``/``step`` refuse after."""
        if self._closed:
            return []
        sched = self.sched
        now = self._now()
        for req in list(sched.queue):
            sched.queue.remove(req)
            self.stats.cancelled += 1
            sched.finished.append(sched.queue_result(req, now, FinishReason.CANCELLED))
        for i, slot in enumerate(sched.slots):
            if slot is not None:
                self.stats.cancelled += 1
                sched.retire(i, now, FinishReason.CANCELLED)
        if sched.radix is not None:
            sched.radix.clear()
        bad = check_invariants(self.pool, sched.radix, tables=sched.owned)
        if self.pool.num_free != self.pool.n_pages - 1:
            bad.append(f"pool leaked pages: {self.pool.num_free} free != "
                       f"{self.pool.n_pages - 1} usable")
        if bad:
            raise AssertionError("close(): paging state failed to reconcile: "
                                 + "; ".join(bad))
        self._closed = True
        out, sched.finished = sched.finished, []
        return out

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _chunk_buf(self, n: int) -> int:
        """Chunk-buffer size: ``chunk_tokens`` when set, else the next
        power of two >= n (at least 8, at most max_len)."""
        if self.config.chunk_tokens is not None:
            return self.config.chunk_tokens
        C = 8
        while C < n:
            C *= 2
        return min(C, round_up(self.max_len, 8))

    def _nan_targets(self) -> tuple[np.ndarray, bool]:
        """Consult the ``logits.nan`` fault point: when it fires, poison the
        lowest-index live decoding slot (or, with none, the in-flight prompt
        chunk) for this tick."""
        nanmask = np.zeros(self.max_batch, bool)
        chunk_nan = False
        if self.chaos is not None and self.chaos.fire("logits.nan"):
            live = [j for j, s in enumerate(self.sched.slots)
                    if s is not None and s.phase == DECODING
                    and self.sched.remaining[j] > 0]
            if live:
                nanmask[live[0]] = True
            else:
                chunk_nan = True
        return nanmask, chunk_nan

    def _mixed_tick(self, i: int, n: int):
        """``n`` prompt rows of prefilling slot ``i`` plus one decode step
        for every decoding slot."""
        sched = self.sched
        if self.chaos is not None and self.chaos.fire("runner.mixed"):
            # before dispatch: no host or device state touched yet, so the
            # tick is simply skipped and retried next step
            raise ChaosError("injected mixed-step failure")
        slot = sched.slots[i]
        full = slot.req.full_prompt()
        buf = np.zeros((1, self._chunk_buf(n)), np.int32)
        buf[0, :n] = full[slot.offset: slot.offset + n]
        final = slot.offset + n == len(full)
        if sched.lazy:
            sched.grow_for_decode(1, self.stats)
        sched.check_capacity(1, self.stats)
        dec_pages = sched.pages.copy()
        dec_pages[i] = 0  # the prefilling slot's frozen decode row -> trash
        before = sched.remaining.copy()
        nanmask, chunk_nan = self._nan_targets()
        temp0, gen0 = ((slot.req.temperature, slot.gen) if final
                       else (0.0, None))
        temps, gens = sched.decode_sampling()
        t0 = time.time()
        tok0, chunk_ok, state = self.runner.mixed(
            buf, sched.pages[i: i + 1], slot.offset, n, temp0, gen0, chunk_nan,
            dec_pages, sched.cur, sched.pos, sched.remaining, nanmask, temps, gens)
        self.stats.prefill_s += time.time() - t0
        self.stats.mixed_steps += 1
        now = self._now()
        self._emit(state, 1, before, now)
        if not chunk_ok:
            # poisoned prompt chunk: isolate the prefilling request (its
            # pages were never published to the radix tree)
            self.stats.faults_isolated += 1
            sched.retire(i, now, FinishReason.FAULT)
            return
        slot.offset += n
        if final:
            sched.commit_prefill(i, tok0, now, self.stats)

    def _decode_tick(self):
        """``decode_chunk`` decode steps (no prefill work pending)."""
        sched = self.sched
        steps = self.config.decode_chunk
        if self.chaos is not None and self.chaos.fire("runner.mixed"):
            raise ChaosError("injected decode-chunk failure")
        if sched.lazy:
            sched.grow_for_decode(steps, self.stats)
        sched.check_capacity(steps, self.stats)
        if not sched.num_active:
            return  # every slot was preempted while growing
        before = sched.remaining.copy()
        nanmask, _ = self._nan_targets()
        temps, gens = sched.decode_sampling()
        t0 = time.time()
        state = self.runner.decode(sched.pages, sched.cur, sched.pos,
                                   sched.remaining, nanmask, temps, gens, steps)
        self.stats.decode_s += time.time() - t0
        self.stats.chunks += 1
        self._emit(state, steps, before, self._now())

    def _emit(self, state, steps: int, before, now: float):
        """Take the tick's device state back and credit each slot its
        tokens (``before`` — remaining at tick start — bounds its share).
        A step whose ``ok`` flag fell marks a fault: tokens from that step
        on are discarded and the slot retires FAULT with the ones before."""
        sched = self.sched
        sched.cur = state[:, 0].astype(np.int32)
        sched.pos = state[:, 1].astype(np.int32)
        sched.remaining = state[:, 2].astype(np.int32)
        toks, oks = state[:, 3: 3 + steps], state[:, 3 + steps:].astype(bool)
        eos = self.config.eos_id
        for i, slot in enumerate(sched.slots):
            if slot is None or before[i] == 0:
                continue
            take = toks[i, : before[i]]
            bad = np.nonzero(~oks[i, : before[i]])[0]
            faulted = bad.size > 0
            if faulted:
                take = take[: bad[0]]
            if eos is not None:
                stop = np.nonzero(take == eos)[0]
                if stop.size:
                    take = take[: stop[0] + 1]
            slot.emitted.extend(int(t) for t in take)
            slot.token_times.extend(now for _ in take)
            self.stats.tokens_out += len(take)
            if faulted:
                self.stats.faults_isolated += 1
                sched.retire(i, now, FinishReason.FAULT)
            elif sched.remaining[i] == 0:
                sched.retire(i, now)

    def step(self) -> list[RequestResult]:
        """One tick: expire deadlines, admit, then a mixed tick (prompt
        chunk + one decode step each) or a decode-only tick.  Returns newly
        finished requests (rejected, cancelled and expired ones too)."""
        if self._closed:
            raise RuntimeError("engine is closed; create a new Engine")
        sched = self.sched
        if self.chaos is not None:
            self.chaos.fire("clock.skew")  # may advance the injected clock
        sched.expire(self._now(), self.stats)
        sched.admit(self.runner)
        self.stats.peak_active = max(self.stats.peak_active, self.num_active)
        try:
            nc = sched.next_chunk()
            if nc is not None:
                self._mixed_tick(*nc)
            elif self.num_active:
                self._decode_tick()
        except ChaosError:
            pass  # injected transient tick failure: nothing dispatched; retry
        if self.radix is not None:
            self.stats.prefix_hit_tokens = self.radix.hit_tokens
            self.stats.prefix_lookup_tokens = self.radix.lookup_tokens
        out, sched.finished = sched.finished, []
        return out

    def run(self) -> list[RequestResult]:
        """Step until queue and slots drain; returns all results (rejected
        submissions included)."""
        results = []
        while self.sched.queue or self.num_active:
            results.extend(self.step())
        out, self.sched.finished = self.sched.finished, []
        results.extend(out)
        return results

    def generate(self, prompts: list[list[int]], max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0):
        """Submit a closed batch and run it.  Returns ``(sequences, stats)``
        with ``sequences[i]`` = prompt + generated for ``prompts[i]``; the
        stats count this call only."""
        start = ServeStats(**{k: getattr(self.stats, k) for k in
                              ServeStats.__dataclass_fields__})
        rids = [self.submit(p, max_new, temperature, seed=seed * 1000003 + i)
                for i, p in enumerate(prompts)]
        by_rid = {r.rid: r for r in self.run()}
        out = [by_rid[r].tokens for r in rids]
        stats = ServeStats(**{k: getattr(self.stats, k) for k in
                              ServeStats.__dataclass_fields__})
        for k in ("prefill_s", "decode_s", "tokens_out", "prefills", "chunks",
                  "mixed_steps"):
            setattr(stats, k, getattr(stats, k) - getattr(start, k))
        return out, stats
