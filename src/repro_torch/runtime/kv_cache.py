"""Block-paged KV cache accounting: ref-counted copy-on-write pages with a
radix-style prefix cache (vLLM/SGLang-style, DESIGN.md §5/§11).

Device storage is a per-layer *pool* of fixed-size pages
(``[num_pages, page_size, KVH, hd]``, built by
``transformer.make_paged_cache``); this module owns the host-side
bookkeeping:

* :class:`PagePool` — a free-list allocator over physical pages extended
  with per-page *refcounts* (``fork``/``release``), a token-block hash
  index mapping chained full-page hashes to physical pages (the radix
  prefix cache: a chain of block hashes is exactly a root-to-node path in
  the radix tree of cached prompts), and LRU eviction of refcount-0
  cached pages when the free list runs dry.
* :class:`KVCacheManager` — per-sequence page tables over one shared
  pool, prefix lookup/adoption at admission, full-block registration as
  prefill completes, and the copy-on-write bookkeeping for writes into
  shared pages.

A page is in exactly one of three states — *free* (allocator), *cached*
(refcount 0 but still in the hash index, reclaimable in LRU order), or
*referenced* (refcount >= 1 slot tables point at it).  ``check()``
asserts the partition, refcount conservation against the tables, and
hash-index consistency; the scheduler property tests drive it after
every decision.

Hash keys are *chained*: ``h_i = H(h_{i-1} || tokens of block i)`` with
``h_{-1} = H(namespace)``, where the namespace encodes model, precision
recipe, KV dtype, tensor-parallel degree and page size — two engines
with different recipes can never share each other's cache entries even
if they somehow shared a pool (see :func:`block_hashes`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter, OrderedDict

import numpy as np


class OutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied even after reclaiming
    cached refcount-0 pages; the scheduler reacts by deferring admission or
    evicting a victim (recompute-preemption)."""


def block_hashes(tokens, page_size: int, namespace: str = ""
                 ) -> tuple[bytes, ...]:
    """Chained hashes over the *full* pages of a prompt (DESIGN.md §11).

    Block ``i`` covers tokens ``[i*page_size, (i+1)*page_size)``; a partial
    tail block gets no hash (only full pages are cacheable).  Each hash
    folds in the previous block's hash, so equal hashes imply equal whole
    prefixes — the chain is a path in the radix tree of cached prompts.
    ``namespace`` seeds the chain so caches keyed to different models,
    precision recipes, or mesh shapes never cross-pollinate.
    """
    h = hashlib.blake2b(namespace.encode(), digest_size=16).digest()
    out = []
    for i in range(len(tokens) // page_size):
        blk = np.asarray(tokens[i * page_size:(i + 1) * page_size],
                         np.int64).tobytes()
        h = hashlib.blake2b(h + blk, digest_size=16).digest()
        out.append(h)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Sizing of the paged KV pool (tokens are int32 ids; pools are
    [num_pages, page_size, KVH, hd] per attention layer).

    ``tp`` is the tensor-parallel degree of the serving mesh (DESIGN.md
    §9).  Pages are *head-sharded*, not id-partitioned: every shard holds
    the identical ``num_pages`` page structure addressed by the one shared
    host page table, and each page carries only KVH/tp heads' bytes — so
    the allocator/accounting below is exactly shard-replicated and
    ``per_shard_page_tokens`` is the per-shard budget the scheduler's
    invariants govern.  The prefix cache and refcounts live in this same
    host bookkeeping, so a tp=N engine makes identical hit/miss/COW
    decisions to tp=1 (DESIGN.md §11).
    """
    page_size: int = 8          # tokens per page
    num_pages: int = 64         # physical pages in the pool (per layer)
    max_batch: int = 4          # decode slots (concurrent sequences)
    max_seq_len: int = 256      # hard cap on prompt + generated tokens
    tp: int = 1                 # tensor-parallel shards holding the pool

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"tp={self.tp}: shard count must be >= 1")

    @property
    def max_pages_per_seq(self) -> int:
        """ceil(max_seq_len / page_size): page-table width per slot."""
        return -(-self.max_seq_len // self.page_size)

    @property
    def per_shard_page_tokens(self) -> int:
        """Token capacity of one shard's pool — identical on every shard
        (the page *structure* replicates; only head bytes shard)."""
        return self.num_pages * self.page_size

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` tokens (ceil division)."""
        return -(-num_tokens // self.page_size)


class PagePool:
    """Ref-counted page allocator with a block-hash prefix index.

    Page lifecycle (DESIGN.md §11)::

        free --alloc--> referenced(ref=1) --fork--> ref+1
        referenced --release--> ref-1; at 0: cached if registered else free
        cached --lookup+fork--> referenced   (prefix hit revives it)
        cached --LRU reclaim--> referenced   (alloc under pressure,
                                              hash unregistered first)

    The free list is LIFO (hot pages reused); LRU reclaim takes the
    *least recently used* cached page so long-lived shared prefixes
    survive pressure longest.

    A fourth terminal state exists for debug-mode containment
    (DESIGN.md §12): *quarantined* pages have been pulled out of
    circulation by the invariant watchdog — their contents may be
    aliased, so they are never handed out again; the pool keeps serving
    with a smaller capacity instead of killing the engine.

    ``injector`` (a :class:`repro.runtime.faults.FaultInjector`) makes
    ``alloc`` fail on the injector's deterministic ``"alloc"`` schedule —
    the failure is raised before any state changes, so an injected
    :class:`OutOfPages` is indistinguishable from real exhaustion to the
    caller and perfectly recoverable.
    """

    def __init__(self, num_pages: int, injector=None):
        self.num_pages = num_pages
        self.injector = injector
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref: dict[int, int] = {}           # page -> refcount (>= 1)
        self._hash_of_page: dict[int, bytes] = {}  # registered full pages
        self._index: dict[bytes, int] = {}         # chain hash -> page
        self._lru: OrderedDict[int, None] = OrderedDict()  # cached, ref==0
        self._quarantined: set[int] = set()  # watchdog-retired pages (§12)
        self.cached_evictions = 0   # LRU reclaims of cached pages

    # ------------------------------------------------------------ queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Refcount-0 pages still in the hash index (reclaimable)."""
        return len(self._lru)

    @property
    def num_reclaimable(self) -> int:
        """Pages an ``alloc`` can hand out: free + cached refcount-0."""
        return len(self._free) + len(self._lru)

    @property
    def num_quarantined(self) -> int:
        """Pages retired from circulation by the invariant watchdog."""
        return len(self._quarantined)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # ----------------------------------------------------------- alloc
    def alloc(self, n: int) -> list[int]:
        """Hand out ``n`` exclusively-owned pages (refcount 1): free-list
        pages first, then LRU reclaim of cached refcount-0 pages (their
        hash entries are dropped first).  Raises :class:`OutOfPages`."""
        if self.injector is not None and self.injector.fire("alloc"):
            # before any mutation: an injected failure leaves the pool
            # bit-identical, so the caller's retry path sees a clean state
            raise OutOfPages(f"injected allocation failure "
                             f"(occurrence {self.injector.calls['alloc'] - 1})")
        if n > self.num_reclaimable:
            raise OutOfPages(f"need {n} pages, {self.num_free} free + "
                             f"{self.num_cached} cached")
        pages = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p = self._reclaim_lru()
            self._ref[p] = 1
            pages.append(p)
        return pages

    def _reclaim_lru(self) -> int:
        p, _ = self._lru.popitem(last=False)   # least recently used
        del self._index[self._hash_of_page.pop(p)]
        self.cached_evictions += 1
        return p

    def fork(self, pages: list[int]) -> None:
        """Take an additional reference on each page (copy-on-write share).
        A cached refcount-0 page is revived out of the LRU list."""
        for p in pages:
            if p in self._lru:
                del self._lru[p]
                self._ref[p] = 1
            elif p in self._ref:
                self._ref[p] += 1
            else:
                raise ValueError(f"fork of unreferenced page {p}")

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page.  At refcount 0 a registered page
        parks in the prefix cache (LRU tail — most recently released);
        an unregistered page returns to the free list.  Raises ValueError
        on over-release (the double-free of the refcounted world)."""
        for p in pages:
            r = self._ref.get(p)
            if r is None:
                raise ValueError(f"double free of page {p}")
            if r > 1:
                self._ref[p] = r - 1
            else:
                del self._ref[p]
                if p in self._hash_of_page:
                    self._lru[p] = None
                else:
                    self._free.append(p)

    # backwards-compatible alias: exclusive-ownership free == release
    free = release

    # ------------------------------------------------------ prefix cache
    def register(self, page: int, chain_hash: bytes) -> bool:
        """Enter a *full, written* page into the prefix index.  First
        writer wins: a hash already mapped (a concurrent duplicate) or a
        page already registered under another hash is left alone (returns
        False)."""
        if chain_hash in self._index or page in self._hash_of_page:
            return False
        if page not in self._ref:
            raise ValueError(f"register of unreferenced page {page}")
        self._hash_of_page[page] = chain_hash
        self._index[chain_hash] = page
        return True

    def lookup(self, chain_hash: bytes) -> int | None:
        """Page holding the block chain ``chain_hash``, or None.  Touches
        the LRU order of cached pages so hot prefixes survive reclaim."""
        p = self._index.get(chain_hash)
        if p is not None and p in self._lru:
            self._lru.move_to_end(p)
        return p

    # ------------------------------------------------------- containment
    def quarantine(self, pages) -> None:
        """Watchdog containment (DESIGN.md §12): forcibly retire ``pages``
        from every lifecycle state.  A quarantined page may be aliased by
        corrupt bookkeeping, so it is never handed out again — capacity
        shrinks, the engine survives."""
        for p in set(pages):
            self._ref.pop(p, None)
            self._lru.pop(p, None)
            h = self._hash_of_page.pop(p, None)
            if h is not None:
                self._index.pop(h, None)
            if p in self._free:
                self._free.remove(p)
            self._quarantined.add(p)

    def reconcile(self, page: int, refcount: int) -> None:
        """Watchdog containment: force ``page``'s refcount to the number
        of surviving table references, quarantining it when none remain
        (its contents can no longer be trusted)."""
        if refcount <= 0:
            self.quarantine([page])
        else:
            self._lru.pop(page, None)
            self._ref[page] = refcount

    # --------------------------------------------------------- invariant
    def check(self) -> None:
        """free / cached / referenced / quarantined partition
        ``range(num_pages)``; every refcount >= 1; LRU pages are exactly
        the refcount-0 registered pages; the hash index and the per-page
        hash map are inverse."""
        free, lru, ref = set(self._free), set(self._lru), set(self._ref)
        quar = self._quarantined
        assert len(self._free) == len(free), "free-list duplicate"
        assert not (free & lru) and not (free & ref) and not (lru & ref), \
            "page in two lifecycle states"
        assert not (quar & (free | lru | ref)), "quarantined page in use"
        assert free | lru | ref | quar == set(range(self.num_pages)), \
            "page leak"
        assert all(r >= 1 for r in self._ref.values()), "zombie refcount"
        assert self._index == {h: p for p, h in self._hash_of_page.items()}, \
            "hash index drift"
        assert len(self._index) == len(self._hash_of_page), \
            "two pages under one hash"
        registered = set(self._hash_of_page)
        assert lru <= registered, "cached page without a hash"
        assert not (registered & free), "registered page on the free list"


class KVCacheManager:
    """Per-slot page tables over one shared ref-counted pool.

    A *slot* is a decode batch index (0..max_batch).  ``ensure(slot, n)``
    grows the slot's table with exclusively-owned pages until it covers
    ``n`` tokens; ``adopt_cached`` forks prefix-cache hits in as the
    table's head at admission; ``cow_range`` replaces shared pages in a
    write range with fresh exclusive copies (the host half of
    copy-on-write — the engine performs the device-side page copy);
    ``free_slot`` releases every page (registered ones park in the prefix
    cache).  Unused table entries point at physical page 0 — always a
    valid gather index; reads from them are masked by ``kv_len`` (decode)
    or the causal mask (prefill), never trusted.

    ``namespace`` seeds this manager's block-hash chains (model /
    precision / KV dtype / tp / page size — see :func:`block_hashes`).
    ``injector`` threads a deterministic fault schedule through page
    allocation and the copy-on-write fork path (DESIGN.md §12).
    """

    def __init__(self, cfg: PagedKVConfig, namespace: str = "",
                 injector=None):
        self.cfg = cfg
        self.namespace = namespace
        self.injector = injector
        self.pool = PagePool(cfg.num_pages, injector=injector)
        self._tables: dict[int, list[int]] = {}
        # dense device mirror, maintained incrementally at every table
        # mutation (dirty-slot writes, not an O(B*P) rebuild per decision)
        self._mirror = np.zeros((cfg.max_batch, cfg.max_pages_per_seq),
                                np.int32)

    # ------------------------------------------------------------ queries
    def slot_pages(self, slot: int) -> list[int]:
        return list(self._tables.get(slot, ()))

    def capacity(self, slot: int) -> int:
        """Tokens the slot can hold without another allocation."""
        return len(self._tables.get(slot, ())) * self.cfg.page_size

    def can_allocate(self, num_tokens: int) -> bool:
        """Conservative: counts free + reclaimable-cached pages."""
        return self.cfg.pages_for(num_tokens) <= self.pool.num_reclaimable

    @property
    def used_pages(self) -> int:
        return self.pool.num_pages - self.pool.num_free

    def hashes_for(self, tokens) -> tuple[bytes, ...]:
        """Block-hash chain of a prompt under this manager's namespace."""
        return block_hashes(tokens, self.cfg.page_size, self.namespace)

    # ---------------------------------------------------------- mutation
    def ensure(self, slot: int, num_tokens: int) -> None:
        """Grow slot's table to cover ``num_tokens`` (raises OutOfPages)."""
        if num_tokens > self.cfg.max_seq_len:
            raise ValueError(f"sequence of {num_tokens} tokens exceeds "
                             f"max_seq_len={self.cfg.max_seq_len}")
        table = self._tables.setdefault(slot, [])
        need = self.cfg.pages_for(num_tokens) - len(table)
        if need > 0:
            fresh = self.pool.alloc(need)
            self._mirror[slot, len(table):len(table) + need] = fresh
            table.extend(fresh)

    def free_slot(self, slot: int) -> None:
        pages = self._tables.pop(slot, [])
        if pages:
            self.pool.release(pages)
            self._mirror[slot, :] = 0

    def truncate(self, slot: int, num_tokens: int) -> list[int]:
        """Shrink slot's table to exactly cover ``num_tokens`` tokens,
        releasing the tail pages — the accounting half of speculative
        KV *rollback* (DESIGN.md §14): pages allocated to hold rejected
        draft tokens return to the pool, and because speculation only
        ever writes past the fully-prefilled prompt, the released tail is
        always exclusively owned (refcount 1) and unregistered — a
        registered page would park in the prefix cache via ``release``,
        preserving every ``check()`` invariant either way.  Device-side
        the rejected rows need no erase: they sit at positions >= the
        rolled-back ``kv_len``, which every later mask treats as unwritten
        and the next step overwrites in place.  Returns the released
        pages (for the decision trace)."""
        table = self._tables.get(slot, [])
        keep = self.cfg.pages_for(num_tokens)
        tail = table[keep:]
        if tail:
            del table[keep:]
            self.pool.release(tail)
            self._mirror[slot, keep:keep + len(tail)] = 0
        return tail

    # ------------------------------------------------------ prefix cache
    def lookup_prefix(self, hashes) -> list[int]:
        """Longest cached chain for ``hashes``: pages for blocks
        0..k while every block hits (a radix-tree descent — the chained
        hashes make block k's hit imply blocks 0..k-1 match too)."""
        pages = []
        for h in hashes:
            p = self.pool.lookup(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def adopt_cached(self, slot: int, pages: list[int]) -> None:
        """Fork prefix-cache hit pages in as the slot's table head
        (admission-time sharing; the slot must not hold pages yet)."""
        if self._tables.get(slot):
            raise ValueError(f"slot {slot} already holds pages")
        self.pool.fork(pages)
        self._tables[slot] = list(pages)
        self._mirror[slot, :len(pages)] = pages

    def register_block(self, slot: int, block_idx: int,
                       chain_hash: bytes) -> bool:
        """Enter the slot's ``block_idx``-th page — now fully written with
        prompt tokens — into the prefix index (first writer wins)."""
        return self.pool.register(self._tables[slot][block_idx], chain_hash)

    def cow_range(self, slot: int, start_tok: int, end_tok: int,
                  pairs: list[tuple[int, int]]) -> None:
        """Copy-on-write bookkeeping for a pending write to
        ``[start_tok, end_tok)``: every overlapped page with refcount > 1
        is swapped for a fresh exclusive page, appending ``(src, dst)`` to
        ``pairs`` (appended incrementally so completed swaps survive an
        OutOfPages mid-range — the caller evicts and retries; already
        exclusive pages are skipped on the retry).  The engine executes
        the device-side page copies before the write runs."""
        if end_tok <= start_tok:
            return
        table = self._tables.get(slot, [])
        ps = self.cfg.page_size
        last = min(-(-end_tok // ps), len(table))
        for bi in range(start_tok // ps, last):
            src = table[bi]
            if self.pool.refcount(src) > 1:
                if (self.injector is not None
                        and self.injector.fire("fork")):
                    # injected COW-fork failure, before any mutation: the
                    # caller's evict-retry resumes exactly here (already
                    # swapped pages are exclusive and skipped on retry)
                    raise OutOfPages("injected copy-on-write fork failure")
                dst = self.pool.alloc(1)[0]   # may raise OutOfPages
                self.pool.release([src])      # siblings keep their refs
                table[bi] = dst
                self._mirror[slot, bi] = dst
                pairs.append((src, dst))

    # -------------------------------------------------------- containment
    def offending_slots(self) -> set[int]:
        """Slots whose page tables are implicated in accounting drift:
        tables referencing pages whose pool refcount disagrees with the
        table-side count, duplicated pages within one table, or pages the
        pool does not consider referenced.  Used by the invariant
        watchdog (DESIGN.md §12) to attribute a failed ``check()`` to the
        request(s) to quarantine — innocent siblings keep serving."""
        owned = Counter(p for t in self._tables.values() for p in t)
        bad_pages = {p for p in set(owned) | set(self.pool._ref)
                     if owned.get(p, 0) != self.pool.refcount(p)}
        out = set()
        for slot, t in self._tables.items():
            if bad_pages & set(t) or len(t) != len(set(t)):
                out.add(slot)
        return out

    def quarantine_slot(self, slot: int) -> list[int]:
        """Watchdog containment: drop ``slot``'s table without trusting
        the pool bookkeeping, then reconcile each of its pages — pages
        still referenced by surviving tables get their refcount forced to
        the true count; orphaned pages are quarantined (retired from
        circulation).  Returns the quarantined page list."""
        table = self._tables.pop(slot, [])
        self._mirror[slot, :] = 0
        owned = Counter(p for t in self._tables.values() for p in t)
        gone = []
        for p in set(table):
            n = owned.get(p, 0)
            self.pool.reconcile(p, n)
            if n == 0:
                gone.append(p)
        return gone

    # ----------------------------------------------------- device mirror
    def page_table_array(self) -> np.ndarray:
        """Dense [max_batch, max_pages_per_seq] int32 mirror (unused -> 0).

        Maintained *incrementally*: every table mutation (``ensure`` /
        ``free_slot`` / ``truncate`` / ``adopt_cached`` / ``cow_range`` /
        ``quarantine_slot``) writes only the dirty cells, so fetching the
        mirror before a step dispatch is one C-level memcpy instead of
        the former O(max_batch * max_pages_per_seq) Python rebuild — one
        of the host-side costs the overlapped engine loop (DESIGN.md §15)
        removes from the decode gap.  Returns a *snapshot* copy: the
        engine hands the array to asynchronously-dispatched jitted steps,
        and on CPU backends JAX may alias numpy buffers zero-copy, so an
        in-flight step must never observe a later in-place mirror update.
        ``check()`` asserts the live mirror stays bitwise equal to a
        from-scratch rebuild.
        """
        return self._mirror.copy()

    def rebuild_page_table(self) -> np.ndarray:
        """From-scratch dense mirror (the pre-incremental construction);
        kept as the oracle the regression tests and ``check()`` compare
        the maintained ``page_table_array()`` against."""
        out = np.zeros((self.cfg.max_batch, self.cfg.max_pages_per_seq),
                       np.int32)
        for slot, pages in self._tables.items():
            out[slot, :len(pages)] = pages
        return out

    # --------------------------------------------------------- invariant
    def check(self) -> None:
        """Refcount conservation + pool partition + hash-index consistency.

        A page referenced by k slot tables must carry refcount exactly k
        (shared prefixes are the only way k > 1); within one table every
        page appears once.  Under tensor parallelism pages are
        head-sharded behind one shared table — every shard holds a
        structurally identical pool — so these assertions ARE the
        per-shard invariants: one check covers all ``cfg.tp`` shards.
        """
        owned = Counter(p for t in self._tables.values() for p in t)
        assert dict(owned) == self.pool._ref, \
            "refcount drift: table references != pool refcounts"
        for slot, t in self._tables.items():
            assert 0 <= slot < self.cfg.max_batch
            assert len(t) <= self.cfg.max_pages_per_seq
            assert len(t) == len(set(t)), "page twice in one table"
        assert np.array_equal(self._mirror, self.rebuild_page_table()), \
            "incremental page-table mirror drifted from tables"
        self.pool.check()
