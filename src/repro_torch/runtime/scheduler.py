"""Continuous-batching scheduler: iteration-level admission over paged KV,
pluggable admission/eviction policies, and radix-prefix-cache reuse.

One ``Scheduler`` instance drives one model replica.  Each engine step asks
for a :class:`Decision`:

* ``PrefillChunk(seq, start, length, cow)`` — run ``length`` prompt tokens
  of one sequence through the model, writing KV into its pages.  Prompts
  are chunked to ``prefill_chunk`` tokens (the per-step token budget), so
  long prompts never stall running decodes for more than one step.
* ``DecodeBatch(seqs, cow)`` — one token for every running sequence.

``cow`` carries host-decided copy-on-write page pairs: pages in the
decision's write range that were shared with siblings have already been
swapped for fresh exclusive pages in the page table; the engine must copy
``src -> dst`` on device *before* executing the step (DESIGN.md §11).

Policies are pluggable (:class:`SchedulerPolicy`): admission picks which
waiting request joins next, eviction picks the recompute-preemption
victim.  :class:`FCFSPolicy` preserves the original strict
first-come-first-served behavior; :class:`PriorityPolicy` admits the
highest-priority arrived request and evicts the lowest-priority youngest
sequence (SLA-style).  Both are deterministic — the decision trace is
part of the test contract.

With ``prefix_cache=True`` the admission path queries the block-hash
prefix index (``kv_cache.block_hashes`` chains computed at enqueue) and
truncates the prefill plan to the *uncached suffix*: hit pages are forked
into the new sequence's table, ``prefill_pos`` starts at the cached
length (always capped at ``len(prompt) - 1`` so at least one real token
is prefilled to produce logits), and the skipped chunks are accounted in
``SchedStats``.  Full prompt pages are registered into the index as their
prefill completes.  Recompute-preemption releases forked pages without
disturbing siblings (refcounts), and a preempted request's re-queued
prompt (prompt + generated) gets fresh block hashes so re-admission can
hit its own surviving cached pages.

Every request leaves the scheduler through exactly one *terminal
status* (DESIGN.md §12): ``OK`` (retired normally), ``TIMEOUT``
(wall-clock or step-budget deadline expired — partial tokens kept),
``CANCELLED`` (client went away), ``REJECTED`` (typed admission refusal:
oversized prompt, bounded-queue backpressure, or policy shed), or
``FAILED`` (unrecoverable execution fault: exhausted step retries,
poisoned request, persistent page starvation, or invariant-watchdog
quarantine).  Terminal records accumulate in :attr:`Scheduler.finished`
and are drained by the engine via :meth:`Scheduler.take_finished`; no
client input ever raises out of ``submit``.

Deadlines are checked only at decision boundaries (host side), so the
fixed-shape jitted steps are untouched.  With ``watchdog=True`` the
manager invariants (``KVCacheManager.check``) are asserted after every
decision; a failed check quarantines the implicated request(s) and their
pages instead of killing the loop.

The scheduler never touches device state; it owns request lifecycle and
the :class:`KVCacheManager` accounting, which is what the property tests
drive.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from .kv_cache import (KVCacheManager, OutOfPages, PagedKVConfig,
                       block_hashes)

# terminal request statuses (DESIGN.md §12)
OK = "OK"
TIMEOUT = "TIMEOUT"
CANCELLED = "CANCELLED"
REJECTED = "REJECTED"
FAILED = "FAILED"

# failure/rejection reason taxonomy (Finished.reason / Completion.reason)
REASON_EXCEEDS_CAPACITY = "prompt_exceeds_capacity"
REASON_QUEUE_FULL = "queue_full"
REASON_SHED = "shed_by_policy"
REASON_DEADLINE = "deadline"          # wall-clock deadline expired
REASON_MAX_STEPS = "max_steps"        # engine-step budget exhausted
REASON_CLIENT_CANCEL = "client_cancel"
REASON_STEP_ERROR = "step_error"      # transient step retries exhausted
REASON_POISONED = "poisoned"
REASON_OUT_OF_PAGES = "out_of_pages"  # persistent allocation starvation
REASON_INVARIANT = "invariant_violation"  # watchdog quarantine


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival: int = 0            # engine step clock at which it may be admitted
    eos_id: int | None = None
    priority: int = 0           # PriorityPolicy: higher admits/survives first
    # chained full-page hashes of ``prompt`` (kv_cache.block_hashes),
    # computed at enqueue by the engine; None disables prefix lookup
    block_hashes: tuple[bytes, ...] | None = None
    requeued: bool = False      # re-admission after recompute-preemption
    # leading tokens of ``prompt`` whose KV was already computed in an
    # earlier residency (prefilled or decoded before the eviction):
    # re-prefilling them is *recomputation*, not new prompt work
    recompute_high: int = 0
    # deadlines, checked at decision boundaries only (DESIGN.md §12):
    # the engine-step clock value after which the request times out ...
    deadline_step: int | None = None
    # ... and the absolute wall-clock instant (scheduler ``time_fn`` units)
    deadline_t: float | None = None


@dataclasses.dataclass(frozen=True)
class Finished:
    """Terminal record of one request: how it left the scheduler and the
    greedy tokens it produced before leaving (partial for non-OK exits,
    empty for requests that never reached a decode slot)."""
    rid: int
    status: str                 # OK | TIMEOUT | CANCELLED | REJECTED | FAILED
    reason: str | None
    tokens: tuple[int, ...]
    evictions: int = 0


@dataclasses.dataclass
class Sequence:
    """A request resident in a decode slot."""
    req: Request
    slot: int
    prefill_pos: int = 0        # prompt tokens whose KV is already written
    resume_pos: int = 0         # admission-time prefill_pos (prefix-cache hit)
    registered_blocks: int = 0  # full prompt pages entered in the hash index
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    evictions: int = 0

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def prompt(self) -> list[int]:
        # admission-time prompt; after a recompute-preemption the re-queued
        # Request's prompt already carries the previously generated tokens
        return self.req.prompt

    @property
    def kv_len(self) -> int:
        return len(self.req.prompt) + len(self.out_tokens)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.req.prompt)

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.req.max_new_tokens:
            return True
        return (self.req.eos_id is not None and self.out_tokens
                and self.out_tokens[-1] == self.req.eos_id)


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    seq: Sequence
    start: int
    length: int
    cow: tuple[tuple[int, int], ...] = ()   # (src, dst) page copies, pre-step


@dataclasses.dataclass(frozen=True)
class DecodeBatch:
    seqs: tuple[Sequence, ...]
    cow: tuple[tuple[int, int], ...] = ()   # (src, dst) page copies, pre-step


@dataclasses.dataclass(frozen=True)
class VerifyBatch:
    """Speculative decode step (DESIGN.md §14): for every running
    sequence, feed its last emitted token plus ``drafts[i]`` proposed
    tokens through the fixed-shape verify step; the engine accepts the
    longest agreeing prefix and reports back via ``completed_verify``
    (which appends tokens, rolls back rejected-suffix pages, and keeps
    the draft/accept accounting).  ``drafts`` aligns with ``seqs``; an
    empty draft degrades that lane to a plain decode."""
    seqs: tuple[Sequence, ...]
    drafts: tuple[tuple[int, ...], ...]
    cow: tuple[tuple[int, int], ...] = ()   # (src, dst) page copies, pre-step


Decision = PrefillChunk | DecodeBatch | VerifyBatch


# ------------------------------------------------------------------ policy
class SchedulerPolicy:
    """Admission/eviction strategy plugged into the scheduler.

    Implementations must be deterministic pure functions of their
    arguments — the decision trace is replayed by the determinism tests.
    """

    name = "base"

    def select_admission(self, waiting, clock: int) -> int | None:
        """Index into ``waiting`` of the request to admit next, or None to
        admit nothing this step (resource checks happen in the scheduler —
        this only expresses *ordering*)."""
        raise NotImplementedError

    def select_victim(self, running, protect) -> "Sequence | None":
        """The running sequence to recompute-preempt so ``protect`` can
        get pages; None when no victim exists."""
        raise NotImplementedError

    def select_shed(self, waiting, incoming: "Request") -> int | None:
        """Backpressure policy for a full admission queue (DESIGN.md §12):
        index into ``waiting`` of the queued request to shed so
        ``incoming`` can be accepted, or None to reject ``incoming``
        itself.  Default: reject the newcomer (strict FCFS fairness)."""
        return None


class FCFSPolicy(SchedulerPolicy):
    """Strict first-come-first-served: only the queue head is eligible
    (a not-yet-arrived head blocks later arrivals — original PR-2
    semantics); the eviction victim is the youngest running sequence."""

    name = "fcfs"

    def select_admission(self, waiting, clock):
        if waiting and waiting[0].arrival <= clock:
            return 0
        return None

    def select_victim(self, running, protect):
        victims = [s for s in running if s is not protect]
        return victims[-1] if victims else None   # youngest admission


class PriorityPolicy(SchedulerPolicy):
    """Priority/SLA scheduling on ``Request.priority`` (higher wins).

    Admission: the highest-priority *arrived* request, ties broken by
    queue position (FCFS within a priority class).  Eviction: the
    lowest-priority running sequence, ties broken youngest-first — a
    high-priority arrival can preempt background work but never a peer
    that got there first.
    """

    name = "priority"

    def select_admission(self, waiting, clock):
        best = None
        for i, req in enumerate(waiting):
            if req.arrival > clock:
                continue
            if best is None or req.priority > waiting[best].priority:
                best = i
        return best

    def select_victim(self, running, protect):
        victims = [s for s in running if s is not protect]
        if not victims:
            return None
        lowest = min(s.req.priority for s in victims)
        return [s for s in victims if s.req.priority == lowest][-1]

    def select_shed(self, waiting, incoming):
        """Shed the lowest-priority queued request that ranks strictly
        below the newcomer (youngest among ties); a newcomer that doesn't
        outrank anyone is rejected instead."""
        best = None
        for i, req in enumerate(waiting):
            if req.priority >= incoming.priority:
                continue
            if best is None or req.priority <= waiting[best].priority:
                best = i
        return best


POLICIES: dict[str, type[SchedulerPolicy]] = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
}


def make_policy(name: str) -> SchedulerPolicy:
    """Instantiate a registered policy by name (``fcfs`` | ``priority``)."""
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler policy {name!r}; "
                         f"registered: {sorted(POLICIES)}") from None


@dataclasses.dataclass
class SchedStats:
    admitted: int = 0
    retired: int = 0
    evicted: int = 0
    prefill_tokens: int = 0     # first-pass prompt tokens actually prefilled
    recompute_tokens: int = 0   # re-prefilled tokens after an eviction —
    #                             counted separately so prefill_tokens (and
    #                             the hit-rate denominator) stays truthful
    prefill_chunks: int = 0     # PrefillChunk decisions executed
    decode_tokens: int = 0
    decode_steps: int = 0
    occupancy_sum: float = 0.0  # sum over decode steps of running/max_batch
    # prefix cache (DESIGN.md §11)
    prefix_lookups: int = 0         # admissions that consulted the index
    prefix_hits: int = 0            # admissions with >= 1 cached page
    prefix_hit_tokens: int = 0      # prompt tokens skipped via cached pages
    prefill_chunks_skipped: int = 0  # chunk decisions avoided by hits
    cow_copies: int = 0             # copy-on-write page copies issued
    # speculative decoding (DESIGN.md §14) — accepted draft tokens count
    # as *decode_tokens* (they are generated output, not prefill work), so
    # prefix_hit_rate / goodput stay truthful
    verify_steps: int = 0           # VerifyBatch decisions executed
    draft_tokens: int = 0           # draft tokens proposed to verify steps
    accepted_tokens: int = 0        # draft tokens accepted (bonus excluded)
    # request lifecycle (DESIGN.md §12) — terminal-status counters
    cancelled: int = 0
    timeouts: int = 0
    rejected: int = 0           # typed admission refusals (incl. sheds)
    shed: int = 0               # rejections of already-queued requests
    failed: int = 0             # unrecoverable execution faults
    quarantined: int = 0        # watchdog invariant quarantines
    admission_deferrals: int = 0  # admissions deferred by alloc failure
    # first-admission queue wait per request, in engine steps (overload
    # benches derive p50/p95 from this; requeues after eviction excluded)
    queue_wait_steps: list[int] = dataclasses.field(default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    def queue_wait_pct(self, pct: float) -> float:
        """Percentile of first-admission queue wait (steps); 0 when no
        request was admitted."""
        if not self.queue_wait_steps:
            return 0.0
        xs = sorted(self.queue_wait_steps)
        i = min(len(xs) - 1, int(round(pct / 100.0 * (len(xs) - 1))))
        return float(xs[i])

    @property
    def acceptance_rate(self) -> float:
        """Accepted fraction of proposed draft tokens (0 when no drafts)."""
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Cached fraction of all prompt tokens that needed KV: hits over
        hits + actually-prefilled (first-pass and recomputed) tokens."""
        total = (self.prefix_hit_tokens + self.prefill_tokens
                 + self.recompute_tokens)
        return self.prefix_hit_tokens / max(total, 1)


class ScheduleFailed(Exception):
    """Internal: a sequence could not be given pages even after bounded
    evict-retry — the scheduler converts it into a FAILED terminal."""

    def __init__(self, seq: "Sequence", reason: str):
        super().__init__(reason)
        self.seq, self.reason = seq, reason


class Scheduler:
    def __init__(self, kv: KVCacheManager, prefill_chunk: int = 16,
                 policy: SchedulerPolicy | None = None,
                 prefix_cache: bool = False,
                 max_queue: int | None = None,
                 watchdog: bool = False,
                 evict_retry_limit: int = 3,
                 speculate: int = 0,
                 draft_source=None,
                 time_fn=time.monotonic):
        self.kv = kv
        self.cfg: PagedKVConfig = kv.cfg
        self.prefill_chunk = prefill_chunk
        self.policy = policy or FCFSPolicy()
        self.prefix_cache = prefix_cache
        # speculative decoding (§14): with speculate=K > 0, decode-shaped
        # decisions become VerifyBatch — draft_source proposes <= K tokens
        # per sequence and the engine verifies them in one batched pass
        self.speculate = speculate
        self.draft_source = draft_source
        self.max_queue = max_queue          # bounded admission queue (§12)
        self.watchdog = watchdog            # invariant check per decision
        self.evict_retry_limit = evict_retry_limit
        self.time_fn = time_fn              # injectable wall clock (tests)
        self.waiting: deque[Request] = deque()
        self.running: list[Sequence] = []   # admission order (oldest first)
        self.finished: list[Finished] = []  # terminal records, FIFO
        self.clock = 0
        self.stats = SchedStats()
        self.trace: list[str] = []          # decision log (determinism tests)
        self._last_was_prefill = False
        self._requeued_outputs: dict[int, list[int]] = {}
        self.evict_counts: dict[int, int] = {}

    # ----------------------------------------------------------- intake
    def submit(self, req: Request) -> str | None:
        """Enqueue ``req``.  Returns None on acceptance, else the typed
        rejection reason (also recorded as a REJECTED terminal in
        :attr:`finished`) — client input never raises (DESIGN.md §12)."""
        if len(req.prompt) + req.max_new_tokens > self.cfg.max_seq_len or \
                self.cfg.pages_for(len(req.prompt) + req.max_new_tokens) \
                > self.cfg.num_pages:
            # validated up front: admitting this request would spin the
            # evict-retry path forever (its page demand can never fit)
            return self._reject(req, REASON_EXCEEDS_CAPACITY)
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            shed = self.policy.select_shed(self.waiting, req)
            if shed is None:
                return self._reject(req, REASON_QUEUE_FULL)
            victim = self.waiting[shed]
            del self.waiting[shed]
            self.stats.shed += 1
            self._reject(victim, REASON_SHED)
        if self.prefix_cache and req.block_hashes is None:
            req.block_hashes = self.kv.hashes_for(req.prompt)
        self.waiting.append(req)
        return None

    def cancel(self, rid: int) -> bool:
        """Cancel a live request: a running sequence releases its pages /
        COW refcounts immediately (partial tokens kept); a queued request
        is removed.  Returns False when ``rid`` is not live (already
        terminal or unknown) — cancellation is idempotent."""
        for seq in self.running:
            if seq.rid == rid:
                self._finish_seq(seq, CANCELLED, REASON_CLIENT_CANCEL)
                self.stats.cancelled += 1
                return True
        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                self._finish_req(req, CANCELLED, REASON_CLIENT_CANCEL)
                self.stats.cancelled += 1
                return True
        return False

    def fail(self, seq: Sequence, reason: str) -> None:
        """Terminate a running sequence as FAILED (engine-observed fault:
        poisoned request, exhausted step retries)."""
        self._finish_seq(seq, FAILED, reason)
        self.stats.failed += 1

    def take_finished(self) -> list[Finished]:
        """Drain terminal records accumulated since the last call."""
        out, self.finished = self.finished, []
        return out

    # ------------------------------------------------ terminal plumbing
    def _finish_seq(self, seq: Sequence, status: str, reason: str | None,
                    free: bool = True) -> None:
        if seq in self.running:
            self.running.remove(seq)
        if free:
            self.kv.free_slot(seq.slot)
        self.finished.append(Finished(
            seq.rid, status, reason, tuple(self.full_output(seq)),
            self.evict_counts.get(seq.rid, 0)))
        if status != OK:
            self.trace.append(f"{status.lower()} r{seq.rid}({reason})")

    def _finish_req(self, req: Request, status: str,
                    reason: str | None) -> None:
        """Terminal for a request that holds no decode slot (still queued,
        or rejected at submit).  A requeued eviction victim keeps the
        tokens it generated in earlier residencies."""
        prior = self._requeued_outputs.get(req.rid, [])
        self.finished.append(Finished(
            req.rid, status, reason, tuple(prior),
            self.evict_counts.get(req.rid, 0)))
        self.trace.append(f"{status.lower()} r{req.rid}({reason})")

    def _reject(self, req: Request, reason: str) -> str:
        self.stats.rejected += 1
        self._finish_req(req, REJECTED, reason)
        return reason

    def _expire_deadlines(self) -> None:
        """Deadline enforcement at the decision boundary (§12): expired
        queued requests time out before admission; expired running
        sequences time out keeping their partial stream.  Wall clock is
        consulted only when some live request carries a wall deadline."""
        live = list(self.waiting) + [s.req for s in self.running]
        now = (self.time_fn()
               if any(r.deadline_t is not None for r in live) else None)

        def expired(req: Request) -> str | None:
            if req.deadline_step is not None and self.clock > req.deadline_step:
                return REASON_MAX_STEPS
            if req.deadline_t is not None and now >= req.deadline_t:
                return REASON_DEADLINE
            return None

        for req in [r for r in self.waiting if expired(r)]:
            self.waiting.remove(req)
            self._finish_req(req, TIMEOUT, expired(req))
            self.stats.timeouts += 1
        for seq in [s for s in self.running if expired(s.req)]:
            self._finish_seq(seq, TIMEOUT, expired(seq.req))
            self.stats.timeouts += 1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _free_slots(self) -> list[int]:
        used = {s.slot for s in self.running}
        return [i for i in range(self.cfg.max_batch) if i not in used]

    # ---------------------------------------------------------- policy
    def _admit(self) -> None:
        while self.waiting:
            idx = self.policy.select_admission(self.waiting, self.clock)
            if idx is None:
                return
            slots = self._free_slots()
            req = self.waiting[idx]
            ps = self.cfg.page_size

            cached_pages: list[int] = []
            cached_len = 0
            if self.prefix_cache and req.block_hashes:
                hits = self.kv.lookup_prefix(req.block_hashes)
                # cap: at least one real token must prefill to emit logits
                cached_len = min(len(hits) * ps, len(req.prompt) - 1)
                cached_pages = hits[:self.cfg.pages_for(cached_len)]
            first = cached_len + min(self.prefill_chunk,
                                     len(req.prompt) - cached_len)
            # conservative: counts forked pages as if freshly allocated,
            # so the fork + ensure below can never fail mid-admission
            if not slots or not self.kv.can_allocate(first):
                return
            seq = Sequence(req, slots[0], prefill_pos=cached_len,
                           resume_pos=cached_len,
                           registered_blocks=len(cached_pages))
            try:
                if cached_pages:
                    self.kv.adopt_cached(seq.slot, cached_pages)
                self.kv.ensure(seq.slot, first)
            except OutOfPages:
                # can_allocate passed, so this is an injected (transient)
                # allocation failure: undo any adoption and defer the
                # admission to a later step — the request stays queued
                self.kv.free_slot(seq.slot)
                self.stats.admission_deferrals += 1
                self.trace.append(f"defer r{req.rid}")
                return
            del self.waiting[idx]
            self.running.append(seq)
            self.stats.admitted += 1
            if not req.requeued:
                self.stats.queue_wait_steps.append(
                    max(0, self.clock - req.arrival))
            hit_note = ""
            if self.prefix_cache and req.block_hashes is not None:
                self.stats.prefix_lookups += 1
                if cached_len:
                    self.stats.prefix_hits += 1
                    self.stats.prefix_hit_tokens += cached_len
                    chunks = -(-len(req.prompt) // self.prefill_chunk)
                    left = -(-(len(req.prompt) - cached_len)
                             // self.prefill_chunk)
                    self.stats.prefill_chunks_skipped += chunks - left
                    hit_note = (f" hit={len(cached_pages)}pg/"
                                f"{cached_len}tok")
            self.trace.append(f"admit r{req.rid}@s{seq.slot}{hit_note}")

    def _preempt(self, protect: Sequence) -> bool:
        """Recompute-preempt the policy's victim (never ``protect``)."""
        victim = self.policy.select_victim(self.running, protect)
        if victim is None:
            return False
        self.running.remove(victim)
        # release, not free: pages shared with siblings just drop one ref;
        # registered full pages park in the prefix cache, so re-admission
        # of this same victim can hit its own surviving prompt pages
        self.kv.free_slot(victim.slot)
        # re-queue at the FRONT: preempted work has priority over new work
        # recompute preemption: generated-so-far tokens become prompt; the
        # re-admitted sequence re-prefills them and continues the stream
        new_prompt = victim.req.prompt + victim.out_tokens
        victim.req = dataclasses.replace(
            victim.req, prompt=new_prompt, arrival=self.clock,
            max_new_tokens=victim.req.max_new_tokens - len(victim.out_tokens),
            requeued=True,
            recompute_high=max(victim.req.recompute_high,
                               victim.prefill_pos + len(victim.out_tokens)),
            block_hashes=(self.kv.hashes_for(new_prompt)
                          if self.prefix_cache else victim.req.block_hashes))
        self._requeued_outputs.setdefault(victim.rid, []).extend(
            victim.out_tokens)
        self.evict_counts[victim.rid] = self.evict_counts.get(
            victim.rid, 0) + 1
        self.waiting.appendleft(victim.req)
        self.stats.evicted += 1
        self.trace.append(f"evict r{victim.rid}")
        return True

    def _ensure_or_evict(self, seq: Sequence, num_tokens: int,
                         write_start: int) -> list[tuple[int, int]]:
        """Grow ``seq``'s table to ``num_tokens`` and make every page in
        the write range ``[write_start, num_tokens)`` exclusively owned,
        evicting victims on page pressure.  Returns the accumulated
        copy-on-write (src, dst) pairs for the engine to copy on device.

        Evict-retry is *bounded* (DESIGN.md §12): with no victim left,
        an OutOfPages is retried ``evict_retry_limit`` times (covers
        injected transient allocation failures — up-front capacity
        validation guarantees a lone sequence's real demand always fits),
        then the request FAILS with ``out_of_pages`` instead of wedging
        or killing the loop."""
        pairs: list[tuple[int, int]] = []
        retries = 0
        while True:
            try:
                self.kv.ensure(seq.slot, num_tokens)
                self.kv.cow_range(seq.slot, write_start, num_tokens, pairs)
                return pairs
            except OutOfPages:
                if self._preempt(protect=seq):
                    continue
                retries += 1
                if retries > self.evict_retry_limit:
                    raise ScheduleFailed(seq, REASON_OUT_OF_PAGES) from None

    def _record_cow(self, pairs) -> tuple[tuple[int, int], ...]:
        if pairs:
            self.stats.cow_copies += len(pairs)
            self.trace.append(
                "cow " + ",".join(f"{s}->{d}" for s, d in pairs))
        return tuple(pairs)

    def next_decision(self) -> Decision | None:
        """One iteration of the policy; advances the clock.  Deadline
        expiry, bounded-retry FAILED conversion, and the optional
        invariant watchdog all happen here — at the decision boundary, so
        the fixed-shape jitted steps never carry lifecycle logic (§12)."""
        self.clock += 1
        self._expire_deadlines()
        try:
            decision = self._decide()
        except ScheduleFailed as f:
            # persistent page starvation: fail the one request instead of
            # crashing the engine; siblings keep serving
            self.fail(f.seq, f.reason)
            self._last_was_prefill = False
            decision = None
        if self.watchdog:
            decision = self._watchdog_check(decision)
        return decision

    def _watchdog_check(self, decision: Decision | None) -> Decision | None:
        """Debug-mode invariant watchdog (§12): run the full accounting
        check after the decision; on failure, quarantine the implicated
        requests (their pages are reconciled or retired from circulation
        via ``KVCacheManager.quarantine_slot``) and strip them from the
        decision instead of killing the engine loop.  Corruption that
        survives quarantine (unattributable) still raises."""
        try:
            self.kv.check()
            return decision
        except AssertionError:
            pass
        suspects = [s for s in self.running
                    if s.slot in self.kv.offending_slots()]
        if not suspects and decision is not None:
            # fall back: blame the decision that surfaced the violation
            suspects = ([decision.seq] if isinstance(decision, PrefillChunk)
                        else [s for s in decision.seqs if s in self.running])
        for seq in suspects:
            self.kv.quarantine_slot(seq.slot)
            self._finish_seq(seq, FAILED, REASON_INVARIANT, free=False)
            self.stats.failed += 1
            self.stats.quarantined += 1
            self.trace.append(f"quarantine r{seq.rid}")
        self.kv.check()  # unattributable corruption: nothing left to blame
        # strip quarantined sequences from the decision; their already-
        # booked COW pairs stay (the dst pages are quarantined — never
        # re-allocated — so executing the copies is harmless, while
        # surviving sequences' pairs MUST still execute)
        qrids = {s.rid for s in suspects}
        if isinstance(decision, PrefillChunk) and decision.seq.rid in qrids:
            return None
        if isinstance(decision, DecodeBatch):
            keep = tuple(s for s in decision.seqs if s.rid not in qrids)
            return DecodeBatch(keep, decision.cow) if keep else None
        if isinstance(decision, VerifyBatch):
            kept = [(s, d) for s, d in zip(decision.seqs, decision.drafts)
                    if s.rid not in qrids]
            if not kept:
                return None
            return VerifyBatch(tuple(s for s, _ in kept),
                               tuple(d for _, d in kept), decision.cow)
        return decision

    def _decide(self) -> Decision | None:
        self._admit()
        prefilling = [s for s in self.running if s.prefilling]
        decoding = [s for s in self.running if not s.prefilling and not s.done]

        want_prefill = bool(prefilling)
        if want_prefill and decoding and self._last_was_prefill:
            # fair interleave: alternate prefill/decode when both have work,
            # so joins reach the decode batch without starving running seqs
            want_prefill = False
        if want_prefill:
            seq = prefilling[0]  # oldest admitted
            start = seq.prefill_pos
            length = min(self.prefill_chunk, len(seq.prompt) - start)
            cow = self._ensure_or_evict(seq, start + length,
                                        write_start=start)
            # tokens computed in an earlier residency re-prefill as
            # *recompute* work; only first-pass tokens are prompt work
            rec = min(max(seq.req.recompute_high - start, 0), length)
            self.stats.recompute_tokens += rec
            self.stats.prefill_tokens += length - rec
            self.stats.prefill_chunks += 1
            self._last_was_prefill = True
            self.trace.append(f"prefill r{seq.rid}[{start}:{start + length}]")
            return PrefillChunk(seq, start, length, self._record_cow(cow))
        if decoding:
            speculating = self.speculate > 0 and self.draft_source is not None
            drafts: dict[int, tuple[int, ...]] = {}
            if speculating:
                for seq in decoding:
                    drafts[seq.rid] = self._propose(seq)
            per_seq: list[tuple[Sequence, list[tuple[int, int]]]] = []
            for seq in decoding:
                if seq in self.running:  # an earlier ensure may have evicted it
                    try:
                        # a verify step writes K/V for the feed token AND
                        # its n draft tokens: positions kv_len-1 .. -1+n
                        n_draft = len(drafts.get(seq.rid, ()))
                        per_seq.append((seq, self._ensure_or_evict(
                            seq, seq.kv_len + n_draft,
                            write_start=seq.kv_len - 1)))
                    except ScheduleFailed as f:
                        # fail only the starved sequence; its pages are
                        # released, and its booked COW pairs are dropped
                        # below exactly like a preempted sequence's
                        self.fail(f.seq, f.reason)
            # keep only pairs of sequences that SURVIVED the eviction pass:
            # a preempted sequence's freed COW dst can be re-allocated to a
            # later sequence in this same decision, and executing the stale
            # copy would alias two writes onto one physical page
            cow = [p for s, ps in per_seq if s in self.running for p in ps]
            decoding = [s for s in self.running
                        if not s.prefilling and not s.done]
            if not decoding:  # everyone got evicted while making room
                self._last_was_prefill = False
                return None
            self.stats.decode_steps += 1
            self.stats.occupancy_sum += len(decoding) / self.cfg.max_batch
            self._last_was_prefill = False
            if speculating:
                # decode_tokens/accepted accounting lands in
                # completed_verify, once acceptance is known
                dseq = tuple(drafts.get(s.rid, ()) for s in decoding)
                self.stats.verify_steps += 1
                self.stats.draft_tokens += sum(len(d) for d in dseq)
                self.trace.append("verify " + ",".join(
                    f"r{s.rid}+{len(d)}" for s, d in zip(decoding, dseq)))
                return VerifyBatch(tuple(decoding), dseq,
                                   self._record_cow(cow))
            self.stats.decode_tokens += len(decoding)
            self.trace.append(
                "decode " + ",".join(f"r{s.rid}" for s in decoding))
            return DecodeBatch(tuple(decoding), self._record_cow(cow))
        self._last_was_prefill = False
        return None  # only future arrivals remain — engine ticks the clock

    def lookahead_decode(self, pending: DecodeBatch) -> DecodeBatch | None:
        """Overlapped-loop fast path (DESIGN.md §15): the decision for step
        N+1 computed *before* step N's sampled tokens are applied, so the
        host schedules while the device computes.  Safe only when the next
        decision is provably the same decode batch regardless of what step
        N sampled — membership identical to ``pending`` and nothing host-
        visible can change it: no waiting request (admission could join),
        no eos / exhausted token budget (a lane could retire), no deadline
        (expiry could time a lane out), no speculation (drafts need step
        N's token on host), and watchdog off (its per-decision check must
        observe post-apply state).  Any violated condition returns None
        with *zero* scheduler mutation — the caller applies the pending
        tokens and falls back to :meth:`next_decision`, which then sees
        exactly the state the synchronous loop would have seen; likewise
        page pressure (OutOfPages) bails out rather than evicting, because
        preempting a sequence with an unapplied in-flight token would drop
        that token from its recompute prompt.  On success the clock,
        stats, and trace advance bitwise-identically to the synchronous
        ``next_decision`` for the same step, which is what keeps the
        async ≡ sync trace contract checkable."""
        if self.waiting or self.speculate > 0 or self.watchdog:
            return None
        decoding = [s for s in self.running if not s.prefilling]
        if (len(decoding) != len(self.running)
                or len(decoding) != len(pending.seqs)
                or any(a is not b for a, b in zip(decoding, pending.seqs))):
            return None
        for s in decoding:
            r = s.req
            if (r.eos_id is not None or r.deadline_step is not None
                    or r.deadline_t is not None
                    or len(s.out_tokens) + 1 >= r.max_new_tokens):
                return None
        pairs: list[tuple[int, int]] = []
        try:
            for s in decoding:
                # post-apply kv_len is kv_len + 1: the write page at the
                # new position is either step N's (already exclusive) or
                # freshly allocated here (refcount 1), so cow stays empty;
                # cow_range is still consulted for defense in depth
                self.kv.ensure(s.slot, s.kv_len + 1)
                self.kv.cow_range(s.slot, s.kv_len, s.kv_len + 1, pairs)
        except OutOfPages:
            return None  # eviction is the slow path's job (see docstring)
        self.clock += 1
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(decoding) / self.cfg.max_batch
        self.stats.decode_tokens += len(decoding)
        self._last_was_prefill = False
        self.trace.append(
            "decode " + ",".join(f"r{s.rid}" for s in decoding))
        return DecodeBatch(tuple(decoding), self._record_cow(pairs))

    def completed_decode(self, batch: DecodeBatch, tokens) -> None:
        """Deferred feedback for one executed DecodeBatch: append each
        lane's sampled token.  ``tokens`` aligns with ``batch.seqs``.
        Sequences that left ``running`` between dispatch and apply
        (cancelled or quarantined — the §15 voiding rule) are skipped,
        mirroring :meth:`completed_verify`; their terminal record already
        carries the tokens they had when they left."""
        for seq, tok in zip(batch.seqs, tokens):
            if seq not in self.running:
                continue
            seq.out_tokens.append(int(tok))

    def _propose(self, seq: Sequence) -> tuple[int, ...]:
        """Draft tokens for one sequence, capped so the verify step can
        never overrun max_seq_len, the request's token budget (emitting
        n_draft + 1 tokens must fit max_new_tokens), or an eos already in
        the draft (tokens after it could never be emitted)."""
        cap = min(self.speculate,
                  self.cfg.max_seq_len - seq.kv_len,
                  seq.req.max_new_tokens - len(seq.out_tokens) - 1)
        if cap <= 0:
            return ()
        d = [int(t) for t in
             self.draft_source.propose(seq.prompt + seq.out_tokens, cap)][:cap]
        if seq.req.eos_id is not None and seq.req.eos_id in d:
            d = d[:d.index(seq.req.eos_id) + 1]
        return tuple(d)

    # --------------------------------------------------------- feedback
    def completed_prefill(self, chunk: PrefillChunk) -> None:
        seq = chunk.seq
        seq.prefill_pos = chunk.start + chunk.length
        if self.prefix_cache and seq.req.block_hashes:
            # register every prompt page this chunk filled completely: its
            # KV is on device now, so future admissions may share it
            n_full = min(seq.prefill_pos // self.cfg.page_size,
                         len(seq.req.block_hashes))
            for bi in range(seq.registered_blocks, n_full):
                self.kv.register_block(seq.slot, bi,
                                       seq.req.block_hashes[bi])
            seq.registered_blocks = max(seq.registered_blocks, n_full)

    def append_token(self, seq: Sequence, token: int) -> None:
        seq.out_tokens.append(token)

    def completed_verify(self, batch: VerifyBatch,
                         results: list[tuple[int, list[int]]]) -> None:
        """Feedback for one executed VerifyBatch.  ``results`` aligns with
        ``batch.seqs``: per sequence, ``(n_accepted, emitted)`` from the
        longest-agreeing-prefix rule (``draft.accept_drafts``, possibly
        truncated at eos).  Appends the emitted tokens (they are decode
        output — generated, never prefill), counts acceptance, and rolls
        back the rejected suffix by truncating the page table to the
        decode-step postcondition: coverage of ``kv_len - 1`` tokens, the
        exact state a chain of plain decode steps would have left
        (DESIGN.md §14)."""
        for seq, drft, (n_acc, emitted) in zip(batch.seqs, batch.drafts,
                                               results):
            if seq not in self.running:   # quarantined/cancelled mid-step
                continue
            for t in emitted:
                seq.out_tokens.append(int(t))
            self.stats.decode_tokens += len(emitted)
            self.stats.accepted_tokens += n_acc
            self.kv.truncate(seq.slot, seq.kv_len - 1)
            self.trace.append(f"accept r{seq.rid}:{n_acc}/{len(drft)}")

    def retire_finished(self) -> list[Sequence]:
        """Retire sequences that completed normally (terminal status OK,
        recorded in :attr:`finished`).  Returns the retired sequences —
        host-only test harnesses read their streams directly."""
        done = [s for s in self.running if s.done]
        for seq in done:
            self._finish_seq(seq, OK, None)
            self.stats.retired += 1
            self.trace.append(f"retire r{seq.rid}")
        return done

    def full_output(self, seq: Sequence) -> list[int]:
        """Generated tokens incl. any emitted before an eviction."""
        prior = getattr(self, "_requeued_outputs", {}).get(seq.rid, [])
        return prior + seq.out_tokens
