"""Host-side KV paging: page-pool allocator + radix prefix cache (a copy of
``repro.serving.paging``; pure Python, no tensors).

These classes own *indices only* — the device-side page pools (one
``[n_pages, page_size, ...]`` array per attention layer) live in the engine;
everything here is O(tokens) Python bookkeeping per request, off the hot
path.

``PagePool`` is a free-list allocator with refcounts: a page's count is the
number of sequence page-tables holding it plus one if the radix tree holds
it; it returns to the free list exactly when the count hits zero.  Page 0 is
reserved as the engine's *trash page* (retired batch rows keep writing
somewhere harmless), so it is never allocated and never freed.

``RadixCache`` is a trie over page-sized token chunks (SGLang-style): an
edge exists per cached full page, keyed by the exact ``page_size`` tokens
whose KV it holds.  A lookup returns the longest cached prefix as (a) whole
pages to share by reference (incref, zero copies) and (b) at most one
partially-matching page to share by *copy-on-write* — the new sequence gets
a fresh page, the matched rows are device-copied, and it diverges freely
while the donor page stays immutable under the tree.  Shared full pages are
never written by any holder (decode writes only at ``pos >= prompt_len``),
so reference-sharing needs no write barrier; the COW copy is the only
data-plane cost of divergence.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class PagePool:
    """Refcounted free-list allocator over page ids ``1..n_pages-1``."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one usable page + the trash page")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() yields 1, 2, ...
        self._rc = [0] * n_pages
        self._rc[0] = 1  # trash page: pinned forever
        #: optional fault hook (chaos harness point ``pool.alloc``): a
        #: zero-arg callable; when it returns True, ``alloc`` reports
        #: exhaustion even if a free page exists.  Callers already handle
        #: ``None`` (evict / requeue / preempt), so an injected failure
        #: exercises exactly the real exhaustion paths.
        self.fault = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._rc[pid]

    def alloc(self) -> int | None:
        """One page with refcount 1, or ``None`` when the pool is exhausted
        (callers evict from the radix cache and retry, or stay queued)."""
        if self.fault is not None and self.fault():
            return None
        if not self._free:
            return None
        pid = self._free.pop()
        assert self._rc[pid] == 0, f"page {pid} on free list with refs"
        self._rc[pid] = 1
        return pid

    def incref(self, pid: int):
        assert 0 < pid < self.n_pages and self._rc[pid] > 0, pid
        self._rc[pid] += 1

    def decref(self, pid: int):
        assert 0 < pid < self.n_pages and self._rc[pid] > 0, pid
        self._rc[pid] -= 1
        if self._rc[pid] == 0:
            self._free.append(pid)


@dataclass
class PrefixMatch:
    """Longest cached prefix of a prompt.

    ``full_pages`` are shared by reference (caller increfs each);
    ``partial`` is ``(donor_page, rows)`` for a copy-on-write share of the
    donor's first ``rows`` rows, or ``None``.  ``tokens`` is the total
    matched length: ``len(full_pages) * page_size + rows``.
    """
    full_pages: list[int] = field(default_factory=list)
    partial: tuple[int, int] | None = None
    tokens: int = 0


class _Node:
    __slots__ = ("children", "page", "parent", "chunk", "tick")

    def __init__(self, page: int = -1, parent: "_Node | None" = None,
                 chunk: tuple | None = None):
        self.children: dict[tuple, _Node] = {}
        self.page = page        # -1 only at the root
        self.parent = parent
        self.chunk = chunk      # edge key in parent.children
        self.tick = 0


class RadixCache:
    """Trie of cached full KV pages, keyed by their exact token chunks."""

    def __init__(self, page_size: int, pool: PagePool):
        self.page_size = page_size
        self.pool = pool
        self.root = _Node()
        self._tick = 0
        self.hit_tokens = 0      # matched prefix tokens across lookups
        self.lookup_tokens = 0   # total prompt tokens across lookups

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def _touch(self, node: _Node):
        self._tick += 1
        while node is not self.root:
            node.tick = self._tick
            node = node.parent

    # ------------------------------------------------------------------
    # lookup / insert
    # ------------------------------------------------------------------

    def match(self, tokens: list[int], max_match: int | None = None
              ) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``max_match``
        (callers cap at ``len(tokens) - 1`` so at least one token is left to
        prefill).  Accounts hit/lookup token counts."""
        ps = self.page_size
        cap = len(tokens) if max_match is None else min(max_match, len(tokens))
        m = PrefixMatch()
        node = self.root
        i = 0
        while i + ps <= cap:
            child = node.children.get(tuple(tokens[i: i + ps]))
            if child is None:
                break
            m.full_pages.append(child.page)
            node = child
            i += ps
        # partial: the child sharing the longest strict prefix of the tail
        tail = tokens[i: min(i + ps, cap)]
        best_r, best_page = 0, -1
        if tail:
            for chunk, child in node.children.items():
                r = 0
                for a, b in zip(chunk, tail):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best_r, best_page = r, child.page
        if best_r:
            m.partial = (best_page, best_r)
        m.tokens = i + best_r
        if node is not self.root:
            self._touch(node)
        self.hit_tokens += m.tokens
        self.lookup_tokens += len(tokens)
        return m

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Register a prefilled prompt's *full* pages: ``pages[j]`` holds the
        KV of ``tokens[j*ps : (j+1)*ps]``.  New edges incref their page (the
        tree's reference); chunks already cached are left as-is (the tree
        keeps its original page — contents are identical by construction).
        Returns the number of pages newly inserted."""
        ps = self.page_size
        node, new = self.root, 0
        for j in range(len(tokens) // ps):
            chunk = tuple(tokens[j * ps: (j + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                if j >= len(pages):
                    break
                child = _Node(pages[j], node, chunk)
                node.children[chunk] = child
                self.pool.incref(pages[j])
                new += 1
            node = child
        if node is not self.root:
            self._touch(node)
        return new

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------

    def _leaves(self):
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def num_evictable(self) -> int:
        """Pages :meth:`evict` could free right now: nodes whose page only
        the tree holds (refcount 1) *and* whose whole subtree is likewise
        tree-only — eviction proceeds leaf-inward, so an inner node is
        unreachable while any descendant must stay.  Admission uses this to
        decide whether evicting can actually satisfy a request before
        giving up any cached pages."""

        def rec(node: _Node) -> tuple[int, bool]:
            total, subtree_ok = 0, True
            for child in node.children.values():
                cnt, ok = rec(child)
                total += cnt
                subtree_ok = subtree_ok and ok
            if node is self.root:
                return total, subtree_ok
            ok = subtree_ok and self.pool.refcount(node.page) == 1
            return total + (1 if ok else 0), ok

        return rec(self.root)[0]

    def evict(self, need_pages: int) -> int:
        """LRU-evict unreferenced leaves until the pool has ``need_pages``
        free (or nothing more is evictable).  A page is evictable iff only
        the tree holds it (refcount 1) and its node is a leaf — evicting a
        leaf may expose its parent for the next round.  Returns #evicted."""
        evicted = 0
        while self.pool.num_free < need_pages:
            cands = [n for n in self._leaves()
                     if self.pool.refcount(n.page) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.tick)
            del victim.parent.children[victim.chunk]
            self.pool.decref(victim.page)
            evicted += 1
        return evicted

    def clear(self):
        """Drop every tree reference (tests / engine reset)."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.decref(n.page)
        self.root.children.clear()


def check_invariants(pool: PagePool, radix: RadixCache | None = None,
                     tables=None) -> list[str]:
    """Structural invariants of the paging state; returns violations (empty
    list == healthy).  Reusable by tests and the engine.

    ``tables`` — optional iterable of per-sequence page-id collections (the
    scheduler's ``owned`` lists / page tables).  When given, refcounts are
    reconciled exactly: ``rc[p] == #tables holding p + (1 if the radix tree
    holds p)``.  Without it only one-sided bounds are checked (the pool
    cannot know its external holders).  Call at quiescent points — mid-
    admission pin/unpin windows legitimately hold transient references.
    """
    bad: list[str] = []
    n = pool.n_pages
    free = list(pool._free)
    rc = list(pool._rc)

    # trash page 0: pinned forever, never allocatable
    if rc[0] < 1:
        bad.append(f"trash page 0 has refcount {rc[0]} (must stay pinned)")
    if 0 in free:
        bad.append("trash page 0 is on the free list")

    # free list: unique, in range, and exactly the rc == 0 pages
    if len(set(free)) != len(free):
        dup = sorted(p for p in set(free) if free.count(p) > 1)
        bad.append(f"free list holds duplicate pages {dup}")
    for p in free:
        if not (0 < p < n):
            bad.append(f"free list holds out-of-range page {p}")
        elif rc[p] != 0:
            bad.append(f"page {p} is free but has refcount {rc[p]}")
    for p in range(1, n):
        if rc[p] == 0 and p not in set(free):
            bad.append(f"page {p} has refcount 0 but is not on the free list")
        if rc[p] < 0:
            bad.append(f"page {p} has negative refcount {rc[p]}")

    # conservation
    if pool.num_free + pool.num_used != n - 1:
        bad.append(f"num_free ({pool.num_free}) + num_used ({pool.num_used})"
                   f" != usable pages ({n - 1})")

    tree_pages: list[int] = []
    if radix is not None:
        ps = radix.page_size
        stack = [(radix.root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            if node is not radix.root:
                tree_pages.append(node.page)
                if not (0 < node.page < n):
                    bad.append(f"radix node holds out-of-range page"
                               f" {node.page}")
                elif rc[node.page] < 1:
                    bad.append(f"radix node holds page {node.page} with"
                               f" refcount {rc[node.page]}")
                if node.chunk is None or len(node.chunk) != ps:
                    bad.append(f"radix node for page {node.page} has chunk"
                               f" length {len(node.chunk or ())} != page_size")
                if node.parent is not parent or key != node.chunk:
                    bad.append(f"radix node for page {node.page} has"
                               f" inconsistent parent/edge links")
            for chunk, child in node.children.items():
                stack.append((child, node, chunk))
        if len(set(tree_pages)) != len(tree_pages):
            bad.append("radix tree holds the same page in two nodes")
        # evictable pages are a subset of tree-held rc == 1 pages
        ev = radix.num_evictable()
        cap = sum(1 for p in tree_pages if rc[p] == 1)
        if ev > cap:
            bad.append(f"num_evictable ({ev}) exceeds tree-only pages ({cap})")

    if tables is not None:
        held: dict[int, int] = {}
        for t in tables:
            for p in t:
                p = int(p)
                if p != 0:
                    held[p] = held.get(p, 0) + 1
        for p in set(tree_pages):
            held[p] = held.get(p, 0) + 1
        for p in range(1, n):
            want = held.get(p, 0)
            if rc[p] != want:
                bad.append(f"page {p} refcount {rc[p]} != {want} references"
                           f" (tables + radix tree)")
    return bad
