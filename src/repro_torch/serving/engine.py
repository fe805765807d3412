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
- a *decode* tick of ``decode_chunk`` fused decode steps otherwise.

Kept from the JAX engine: radix prefix reuse with the copy-on-write page
copy, trash-page freezing of retired and prefilling rows (page 0, ``pos =
0``), and ``FinishReason.STOP`` / ``LENGTH``.  The page pools are updated
in place (JAX donates them).  Each tick copies its inputs to the device
once and reads its outputs back once — one host sync per tick.

Sampling: greedy is ``argmax`` (the first maximum, as ``jnp.argmax``).
Temperature > 0 draws from a per-request ``torch.Generator`` seeded from
the request's seed; it advances only while the request is the one being
sampled, so a request's tokens depend on its seed and its own logits alone.
``jax.random``'s streams cannot be reproduced, so sampled tokens match the
JAX engine's only in distribution.

Waiting for the resilience slice: deadlines, ``cancel``, preemption, chaos,
the bounded-queue ``REJECTED`` answer and in-step fault isolation.  Until
then non-finite logits on an active slot raise ``FloatingPointError``.
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
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.paging import PagePool, PrefixMatch, RadixCache


def bytes_tokenizer_encode(text: str, vocab: int) -> list[int]:
    return [b % vocab for b in text.encode("utf-8")]


class FinishReason(str, Enum):
    STOP = "stop"      # emitted eos_id
    LENGTH = "length"  # emitted max_new tokens


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    temperature: float = 0.0
    seed: int = 0
    arrival_s: float = 0.0


@dataclass
class RequestResult:
    rid: int
    prompt: list[int]
    generated: list[int]
    arrival_s: float
    first_token_s: float
    finish_s: float
    finish_reason: FinishReason = FinishReason.LENGTH

    @property
    def tokens(self) -> list[int]:
        return list(self.prompt) + list(self.generated)

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s


@dataclass
class ServeStats:
    prefill_s: float = 0.0   # wall time of mixed ticks
    decode_s: float = 0.0    # wall time of decode-only ticks
    tokens_out: int = 0
    prefills: int = 0
    chunks: int = 0          # decode-only ticks
    mixed_steps: int = 0     # mixed ticks
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0

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


# ---------------------------------------------------------------------------
# ModelRunner: params, page pools and the per-tick device work
# ---------------------------------------------------------------------------

class ModelRunner:
    """Owns the device state (params, paged pools) and runs the decode
    chunk, the mixed step and the copy-on-write page copy on it."""

    def __init__(self, cfg: ArchConfig, params, config: EngineConfig, device):
        self.cfg = cfg
        self.device = device
        self.params = params
        self.vocab = cfg.vocab_size
        self.eos_id = config.eos_id
        self.caches = M.init_paged_cache(cfg, config.max_batch, config.n_pages,
                                         config.page_size, device=device)

    def _sample(self, lf, temps, gens):
        """lf [B, V] f32 -> [B] int32.  Rows with ``temps[i] > 0`` draw from
        ``gens[i]``; the rest take the first maximum."""
        nxt = torch.argmax(lf, -1).to(torch.int32)
        for i, (t, g) in enumerate(zip(temps, gens)):
            if t > 0.0:
                probs = torch.softmax(lf[i] / t, -1)
                nxt[i] = torch.multinomial(probs, 1, generator=g)[0].to(torch.int32)
        return nxt

    def _decode_steps(self, pages, cur, pos, remaining, temps, gens, steps):
        """``steps`` fused decode steps.  A slot is active while
        ``remaining > 0``; a frozen slot keeps its token and row.  Returns
        the new state and per-step tokens and finite flags [B, steps]."""
        toks, oks = [], []
        for _ in range(steps):
            active = remaining > 0
            logits, _ = M.decode_step(self.cfg, self.params, self.caches,
                                      cur[:, None], pos, pages=pages)
            lf = logits[:, -1, : self.vocab]
            nxt = torch.where(active, self._sample(lf, temps, gens), cur)
            step = active.to(torch.int32)
            remaining = remaining - step
            if self.eos_id is not None:
                remaining = torch.where(active & (nxt == self.eos_id),
                                        torch.zeros_like(remaining), remaining)
            pos = pos + step
            cur = nxt
            toks.append(nxt)
            oks.append(torch.isfinite(lf).all(-1) | ~active)
        return cur, pos, remaining, torch.stack(toks, 1), torch.stack(oks, 1)

    def decode(self, pages, cur, pos, remaining, temps, gens, steps: int):
        """Decode-only tick.  Host arrays in, one device->host copy out:
        [B, 3 + 2*steps] int32 = cur, pos, remaining, tokens, ok flags."""
        dev = self.device
        state = torch.from_numpy(np.stack([cur, pos, remaining])).to(dev)
        pages_t = torch.from_numpy(pages).to(dev)
        c, p, r, toks, oks = self._decode_steps(
            pages_t, state[0], state[1], state[2], temps, gens, steps)
        out = torch.cat([c[:, None], p[:, None], r[:, None], toks,
                         oks.to(torch.int32)], 1)
        return out.cpu().numpy()

    def mixed(self, buf, chunk_pages, past: int, n: int, chunk_temp: float,
              chunk_gen, dec_pages, cur, pos, remaining, temps, gens):
        """Mixed tick: an ``n``-row prompt chunk (buffer ``buf`` [1, C]) at
        rows ``[past, past + n)`` plus one decode step per slot.  Returns
        (tok0, chunk_finite, [B, 5] decode state as in :meth:`decode`)."""
        dev = self.device
        state = torch.from_numpy(np.stack([cur, pos, remaining])).to(dev)
        tables = torch.from_numpy(np.concatenate([chunk_pages, dec_pages])).to(dev)
        buf_t = torch.from_numpy(buf).to(dev)
        logits, _ = M.chunk_step(self.cfg, self.params, self.caches, buf_t,
                                 tables[:1], past, n)
        lf = logits[:, -1, : self.vocab]
        tok0 = self._sample(lf, [chunk_temp], [chunk_gen])
        c, p, r, toks, oks = self._decode_steps(
            tables[1:], state[0], state[1], state[2], temps, gens, 1)
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
    """Host-side request bookkeeping: the FIFO queue, per-slot numpy state
    (page tables, tokens, positions, budgets), page/radix accounting and
    the slot state machine."""

    def __init__(self, config: EngineConfig, device):
        B = config.max_batch
        self.config = config
        self.device = device
        self.page_size = config.page_size
        self.max_batch = B
        self.npp = config.cache_spec().pages_per_seq
        self.pool = PagePool(config.n_pages)
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
        left = len(slot.req.prompt) - slot.offset
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

    def admit(self, runner: ModelRunner):
        """Move queued requests into free rows, FIFO with head-of-line
        blocking on pages.  A new slot enters PREFILLING at its radix
        offset and admission holds until its prefill completes (lookups
        never match unpublished pages).  Matched pages (and the COW donor)
        are pinned before eviction can run."""
        free_rows = [i for i in range(self.max_batch) if self.slots[i] is None]
        while self.queue and free_rows:
            if self.prefilling_slot() is not None:
                break
            req = self.queue[0]
            plen = len(req.prompt)
            need = self.pages_needed(plen, req.max_new)
            if self.radix is not None:
                ht, lt = self.radix.hit_tokens, self.radix.lookup_tokens
                m = self.radix.match(req.prompt, max_match=plen - 1)
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
            if not ok:
                for pid in pinned:
                    self.pool.decref(pid)
                if self.radix is not None:  # blocked: don't count the lookup
                    self.radix.hit_tokens, self.radix.lookup_tokens = ht, lt
                break
            fresh = [self.pool.alloc() for _ in range(fresh_needed)]
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
            gen = None
            if req.temperature > 0.0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(req.seed & 0xFFFF_FFFF_FFFF_FFFF)
            self.pages[i] = table
            self.owned[i] = shared + fresh
            self.limit[i] = plen + req.max_new
            self.slots[i] = _Slot(req, phase=PREFILLING, offset=m.tokens,
                                  seq=self._seq, gen=gen)
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
        plen = len(req.prompt)
        if self.radix is not None:
            fp = plen // self.page_size
            self.radix.insert(req.prompt[: fp * self.page_size],
                              [int(self.pages[i][j]) for j in range(fp)])
        slot.phase = DECODING
        slot.emitted = [first]
        slot.first_token_s = now
        self.cur[i], self.pos[i] = first, plen
        self.remaining[i] = req.max_new - 1
        stats.prefills += 1
        stats.tokens_out += 1
        if self.remaining[i] == 0 or first == self.config.eos_id:
            self.remaining[i] = 0
            self.retire(i, now)
            return True
        return False

    def retire(self, i: int, now: float):
        s = self.slots[i]
        eos = self.config.eos_id
        reason = (FinishReason.STOP if eos is not None and s.emitted
                  and s.emitted[-1] == eos else FinishReason.LENGTH)
        self.finished.append(RequestResult(
            s.req.rid, s.req.prompt, s.emitted, s.req.arrival_s,
            s.first_token_s, now, finish_reason=reason))
        self.slots[i] = None
        for pid in self.owned[i]:
            self.pool.decref(pid)  # radix-held pages survive at rc >= 1
        self.owned[i] = []
        self.pages[i] = 0  # trash page: frozen-row writes land harmlessly
        self.pos[i] = self.cur[i] = self.remaining[i] = 0

    def check_capacity(self, steps_bound: int):
        """Refuse to decode a slot past its reserved rows."""
        for i, slot in enumerate(self.slots):
            if slot is None or slot.phase != DECODING:
                continue
            steps = min(int(self.remaining[i]), steps_bound)
            if self.pos[i] + steps > self.limit[i]:
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
    """

    def __init__(self, cfg: ArchConfig, params,
                 config: EngineConfig | None = None, device=None):
        self.device = resolve_device(device)
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine on {self.device}")
        self.config = config or EngineConfig()
        if self.config.quant == "w8a8":
            params = M.quantize_params(cfg, params)  # idempotent
        self.cfg, self.params = cfg, params
        self.max_len = self.config.max_len
        self.stats = ServeStats()
        self.runner = ModelRunner(cfg, params, self.config, self.device)
        self.sched = Scheduler(self.config, self.device)
        self._next_rid = 0

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

    def submit(self, prompt: list[int], max_new: int = 32,
               temperature: float = 0.0, seed: int = 0) -> int:
        """Queue a request; returns its rid.  Raises ``ValueError`` on
        malformed input or a request that can never fit."""
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
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"request needs {len(prompt) + max_new} cache "
                             f"rows > max_len={self.max_len}")
        need = self.sched.pages_needed(len(prompt), max_new)
        if need > self.pool.n_pages - 1:
            raise ValueError(f"request needs {need} pages > pool capacity "
                             f"{self.pool.n_pages - 1}")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.queue.append(Request(rid, [int(t) for t in prompt],
                                        int(max_new), float(temperature),
                                        int(seed), arrival_s=time.time()))
        return rid

    def _chunk_buf(self, n: int) -> int:
        """Chunk-buffer size: ``chunk_tokens`` when set, else the next
        power of two >= n (at least 8, at most max_len)."""
        if self.config.chunk_tokens is not None:
            return self.config.chunk_tokens
        C = 8
        while C < n:
            C *= 2
        return min(C, round_up(self.max_len, 8))

    def _mixed_tick(self, i: int, n: int):
        """``n`` prompt rows of prefilling slot ``i`` plus one decode step
        for every decoding slot."""
        sched = self.sched
        slot = sched.slots[i]
        prompt = slot.req.prompt
        buf = np.zeros((1, self._chunk_buf(n)), np.int32)
        buf[0, :n] = prompt[slot.offset: slot.offset + n]
        final = slot.offset + n == len(prompt)
        sched.check_capacity(1)
        dec_pages = sched.pages.copy()
        dec_pages[i] = 0  # the prefilling slot's frozen decode row -> trash
        before = sched.remaining.copy()
        temp0, gen0 = ((slot.req.temperature, slot.gen) if final
                       else (0.0, None))
        temps, gens = sched.decode_sampling()
        t0 = time.time()
        tok0, chunk_ok, state = self.runner.mixed(
            buf, sched.pages[i: i + 1], slot.offset, n, temp0, gen0,
            dec_pages, sched.cur, sched.pos, sched.remaining, temps, gens)
        self.stats.prefill_s += time.time() - t0
        self.stats.mixed_steps += 1
        if not chunk_ok:
            raise FloatingPointError(
                f"non-finite chunk logits for rid={slot.req.rid}")
        now = time.time()
        self._emit(state, 1, before, now)
        slot.offset += n
        if final:
            sched.commit_prefill(i, tok0, now, self.stats)

    def _decode_tick(self):
        """``decode_chunk`` fused decode steps (no prefill work pending)."""
        sched = self.sched
        steps = self.config.decode_chunk
        sched.check_capacity(steps)
        before = sched.remaining.copy()
        temps, gens = sched.decode_sampling()
        t0 = time.time()
        state = self.runner.decode(sched.pages, sched.cur, sched.pos,
                                   sched.remaining, temps, gens, steps)
        self.stats.decode_s += time.time() - t0
        self.stats.chunks += 1
        self._emit(state, steps, before, time.time())

    def _emit(self, state, steps: int, before, now: float):
        """Take the tick's device state back and credit each slot its
        tokens (``before`` — remaining at tick start — bounds its share)."""
        sched = self.sched
        sched.cur = state[:, 0].astype(np.int32)
        sched.pos = state[:, 1].astype(np.int32)
        sched.remaining = state[:, 2].astype(np.int32)
        toks, oks = state[:, 3: 3 + steps], state[:, 3 + steps:]
        eos = self.config.eos_id
        for i, slot in enumerate(sched.slots):
            if slot is None or before[i] == 0:
                continue
            n_take = min(int(before[i]), steps)
            if not oks[i, :n_take].all():
                raise FloatingPointError(
                    f"non-finite logits for rid={slot.req.rid}")
            take = toks[i, :n_take]
            if eos is not None:
                stop = np.nonzero(take == eos)[0]
                if stop.size:
                    take = take[: stop[0] + 1]
            slot.emitted.extend(int(t) for t in take)
            self.stats.tokens_out += len(take)
            if sched.remaining[i] == 0:
                sched.retire(i, now)

    def step(self) -> list[RequestResult]:
        """One tick: admit, then a mixed tick (prompt chunk + one decode
        step each) or a decode-only tick.  Returns newly finished
        requests."""
        sched = self.sched
        sched.admit(self.runner)
        nc = sched.next_chunk()
        if nc is not None:
            self._mixed_tick(*nc)
        elif self.num_active:
            self._decode_tick()
        if self.radix is not None:
            self.stats.prefix_hit_tokens = self.radix.hit_tokens
            self.stats.prefix_lookup_tokens = self.radix.lookup_tokens
        out, sched.finished = sched.finished, []
        return out

    def run(self) -> list[RequestResult]:
        """Step until queue and slots drain; returns all results."""
        results = []
        while self.sched.queue or self.num_active:
            results.extend(self.step())
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
