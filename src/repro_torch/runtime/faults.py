"""Deterministic fault injection for the serving engine (DESIGN.md §12).

Verbatim copy of ``repro.runtime.faults`` (pure Python, no device work), kept
in the port so that it never imports the JAX package.

Robustness claims need to be *testable*: "the engine survives allocation
failures" is a property only if the failures arrive on a reproducible
schedule.  This module provides a seeded :class:`FaultInjector` that the
engine threads through its failure-prone sites:

* ``alloc`` — :meth:`PagePool.alloc <repro_torch.runtime.kv_cache.PagePool.alloc>`
  raises ``OutOfPages`` before touching any state, exercising the
  scheduler's evict-retry / deferred-admission paths under page pressure
  that the workload itself would not generate.
* ``fork`` — the copy-on-write dst allocation inside
  ``KVCacheManager.cow_range`` fails, exercising the mid-COW retry path
  (bookkeeping must survive a half-completed range).
* ``step`` — host-side dispatch of a jitted step raises
  :class:`TransientStepError` *before* the device function runs (device
  state untouched), exercising the engine's bounded retry/backoff and,
  when retries are exhausted, the per-request FAILED path.
* poisoned requests — :meth:`FaultInjector.poisoned` marks a deterministic
  subset of request ids as unexecutable; the engine fails them at their
  first prefill dispatch instead of running the step.

Every decision is a pure function of ``(seed, site, occurrence index)``
(or ``(seed, rid)`` for poison) via a truncated blake2b hash, so:

* the same seed + same workload reproduces the same fault schedule, byte
  for byte — the chaos property tests replay it;
* the schedule at one site does not depend on how often *other* sites
  were hit (per-site counters), so adding instrumentation never shifts
  an existing schedule;
* host-side scheduling is identical at tp=1 and tp=N, so a sharded
  engine sees the same faults as the single-device engine.

Injection happens strictly *before* the guarded operation mutates
anything, which is what makes "unaffected requests stay argmax-identical
to the fault-free trace" a provable property rather than a hope.
"""
from __future__ import annotations

import dataclasses
import hashlib


class InjectedFault(RuntimeError):
    """Base of injector-raised errors (never raised for real causes)."""


class TransientStepError(InjectedFault):
    """Injected host-side step-dispatch failure; retryable (the device
    function was never entered, so no state changed)."""


SITES = ("alloc", "fork", "step")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seed-keyed fault schedule (DESIGN.md §12).

    Rates are per-*occurrence* probabilities evaluated deterministically
    from ``(seed, site, n)``; the ``*_at`` tuples additionally force an
    injection at exact occurrence indices (0-based per site) for targeted
    tests ("fail the 3rd allocation").  ``poison_rids`` force-poisons
    specific request ids; ``poison_rate`` poisons a deterministic
    pseudo-random subset keyed by ``(seed, rid)``.
    """
    seed: int = 0
    alloc_fail_rate: float = 0.0    # PagePool.alloc -> OutOfPages
    cow_fail_rate: float = 0.0      # cow_range dst alloc -> OutOfPages
    step_error_rate: float = 0.0    # step dispatch -> TransientStepError
    poison_rate: float = 0.0        # fraction of rids that always fail
    alloc_fail_at: tuple[int, ...] = ()
    cow_fail_at: tuple[int, ...] = ()
    step_error_at: tuple[int, ...] = ()
    poison_rids: tuple[int, ...] = ()

    def site_rate(self, site: str) -> float:
        return {"alloc": self.alloc_fail_rate, "fork": self.cow_fail_rate,
                "step": self.step_error_rate}[site]

    def site_forced(self, site: str) -> tuple[int, ...]:
        return {"alloc": self.alloc_fail_at, "fork": self.cow_fail_at,
                "step": self.step_error_at}[site]


def _uniform(seed: int, site: str, n: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, site, n)."""
    h = hashlib.blake2b(f"{seed}|{site}|{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultInjector:
    """Stateful front-end of a :class:`FaultPlan`: per-site occurrence
    counters plus injected-fault accounting.  One injector serves one
    engine run; construct a fresh one to replay the identical schedule.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.calls = {s: 0 for s in SITES}      # guarded-site occurrences
        self.injected = {s: 0 for s in SITES}   # faults actually fired
        self.poisoned_rids: set[int] = set()    # rids observed poisoned

    def fire(self, site: str) -> bool:
        """Advance ``site``'s occurrence counter; True when this occurrence
        is scheduled to fail.  The caller raises the site's error type
        *before* mutating any state."""
        n = self.calls[site]
        self.calls[site] = n + 1
        hit = (n in self.plan.site_forced(site)
               or _uniform(self.plan.seed, site, n) < self.plan.site_rate(site))
        if hit:
            self.injected[site] += 1
        return hit

    def poisoned(self, rid: int) -> bool:
        """True when ``rid`` is poisoned (always fails at execution) —
        a pure function of (seed, rid), stable across the run."""
        hit = (rid in self.plan.poison_rids
               or _uniform(self.plan.seed, "poison", rid)
               < self.plan.poison_rate)
        if hit:
            self.poisoned_rids.add(rid)
        return hit

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def describe(self) -> str:
        """One-line audit of what actually fired (for logs/benches)."""
        parts = [f"{s}={self.injected[s]}/{self.calls[s]}" for s in SITES]
        parts.append(f"poisoned={len(self.poisoned_rids)}")
        return " ".join(parts)
