"""Draft sources for self-speculative decoding (DESIGN.md §14).

Verbatim copy of ``repro.runtime.draft`` (pure Python, no device work), kept
in the port so that it never imports the JAX package.

Speculative decoding converts memory-bound one-token decode steps into
small batched verify passes: a *draft source* proposes up to K tokens per
running sequence from host-side context (no device work), the engine
scores all drafts in one fixed-shape ``verify_step`` ``[max_batch, K+1]``
pass, and the longest agreeing prefix is accepted.  Greedy accept/reject
is deterministic, so spec-on must be argmax-identical to spec-off —
``tests/test_spec_decode.py`` asserts exactly that.

Draft sources are pluggable through the same registry pattern as
``scheduler.SchedulerPolicy``: implement :class:`DraftSource`, register
in :data:`DRAFT_SOURCES`, select by name via
``EngineConfig(draft_source=...)``.

Determinism contract: ``propose`` must be a pure function of its
arguments (context tokens + the source's construction-time config).  The
engine calls it once per sequence per verify step from the host
scheduler loop; a source that consults wall clock, shared mutable state,
or an unseeded RNG breaks replayability of the scheduler decision trace.

Speculation and the overlapped loop (DESIGN.md §15): drafting is a HOST
function of the emitted token stream, so a verify step for position N+1
cannot be proposed until step N's sampled token has crossed back to the
host — speculation therefore always rides the engine's synchronous slow
path, and ``Scheduler.lookahead_decode`` bails whenever
``speculate > 0``.  The two optimizations compose per-workload, not
per-step: async overlap pays on stable decode-bound stretches, drafts
pay on self-repetitive content.
Correctness never depends on draft *quality* — a garbage draft just
yields zero accepted tokens and the verify step degrades to a decode
step (the bonus token keeps forward progress) — so the chaos-friendly
:class:`RandomDraftSource` exists precisely to prove that in property
tests.
"""
from __future__ import annotations

import hashlib
from typing import Protocol, Sequence


class DraftSource(Protocol):
    """Proposes up to ``max_tokens`` draft tokens for one sequence.

    ``context`` is the full visible token stream (prompt + emitted
    output, last element = the token the next step would feed).  The
    return value may be shorter than ``max_tokens`` (including empty —
    the engine then runs a plain decode-shaped verify step).
    """

    def propose(self, context: Sequence[int],
                max_tokens: int) -> list[int]: ...


class NgramDraftSource:
    """Prompt-lookup drafting (self-speculation without a draft model).

    Finds the most recent *earlier* occurrence of the last ``n``-gram of
    the context and proposes the tokens that followed it — the classic
    prompt-lookup decoder.  Deterministic: pure function of the context.
    Tries the longest configured n-gram first and falls back to shorter
    ones, preferring the match nearest the end of the context (recency).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: Sequence[int],
                max_tokens: int) -> list[int]:
        ctx = list(context)
        if max_tokens <= 0 or len(ctx) < 2:
            return []
        for n in range(min(self.max_ngram, len(ctx) - 1),
                       self.min_ngram - 1, -1):
            tail = ctx[-n:]
            # newest earlier occurrence: scan right-to-left, excluding
            # the tail's own position
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    cont = ctx[start + n:start + n + max_tokens]
                    if cont:
                        return cont
                    break  # matched but nothing follows; try shorter n
        return []


class RandomDraftSource:
    """Seeded garbage drafts for chaos/property testing.

    Deterministic: each proposal is a pure function of (seed, context) —
    same seed and context always yield the same drafts, so runs replay
    exactly.  Acceptance will be ~zero on any real vocab; the parity
    suite uses this to prove correctness never depends on draft quality.
    """

    def __init__(self, seed: int = 0, vocab_size: int = 32000):
        self.seed = seed
        self.vocab_size = vocab_size

    def propose(self, context: Sequence[int],
                max_tokens: int) -> list[int]:
        if max_tokens <= 0:
            return []
        h = hashlib.blake2b(digest_size=8)
        h.update(str(self.seed).encode())
        h.update(b"|")
        h.update(",".join(str(t) for t in context).encode())
        out = []
        state = int.from_bytes(h.digest(), "little")
        for _ in range(max_tokens):
            state = (state * 6364136223846793005 + 1442695040888963407) \
                % (1 << 64)
            out.append((state >> 33) % self.vocab_size)
        return out


DRAFT_SOURCES = {
    "ngram": NgramDraftSource,
    "random": RandomDraftSource,
}


def make_draft_source(name: str, **kw) -> DraftSource:
    """Instantiate a registered draft source by name."""
    try:
        cls = DRAFT_SOURCES[name]
    except KeyError:
        raise ValueError(
            f"unknown draft source {name!r}; registered: "
            f"{sorted(DRAFT_SOURCES)}") from None
    return cls(**kw)


def accept_drafts(draft: Sequence[int],
                  argmax: Sequence[int]) -> tuple[int, list[int]]:
    """The greedy longest-agreeing-prefix rule (pure host function).

    ``draft`` is the n proposed tokens [d1..dn]; ``argmax`` is the n+1
    greedy model outputs from the verify pass, where ``argmax[i]`` is
    the model's next-token prediction *after* consuming draft token i
    (``argmax[0]`` follows the real last token t0).  Tokens are accepted
    while the model would have produced them itself:

        accept d_{i+1}  iff  d_{j+1} == argmax[j] for all j <= i

    Returns ``(n_accepted, emitted)`` where ``emitted`` is the accepted
    prefix plus the one bonus token ``argmax[n_accepted]`` — the model's
    own prediction at the first disagreement (or after a fully-accepted
    draft).  ``len(emitted) == n_accepted + 1`` always: a verify step
    emits at least one token (forward progress) and at most n+1, exactly
    the tokens the non-speculative greedy loop would have produced
    one step at a time.  This equivalence is what makes spec-on ≡
    spec-off argmax parity hold token-for-token.
    """
    if len(argmax) < len(draft) + 1:
        raise ValueError(
            f"need {len(draft) + 1} argmax rows for {len(draft)} drafts, "
            f"got {len(argmax)}")
    n_accepted = 0
    for d, a in zip(draft, argmax):
        if d != a:
            break
        n_accepted += 1
    emitted = list(draft[:n_accepted]) + [int(argmax[n_accepted])]
    return n_accepted, emitted
