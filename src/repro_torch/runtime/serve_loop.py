"""Serving: the one-shot prefill+decode reference and the continuous-batching
paged-KV engine (port of ``repro.runtime.serve_loop``).

``pack_params`` runs the offline packer + load-time compression on every
SparseLinear (prune -> quantize -> Phi -> compress).  ``generate`` is the
dense-cache one-shot path, the parity oracle of the engine.
:class:`ServeEngine` is the step-driven engine: requests join mid-flight,
prefill chunks interleave with decode steps, finished sequences retire and
free their KV pages.  Scheduling and page accounting are the host-side
copies in ``scheduler`` / ``kv_cache``; the two model steps run eagerly.

Not ported yet (raise ``NotImplementedError``, ROADMAP A.5 / A.8): tensor
parallelism, the prefix cache, speculative decoding, the overlapped
(async) loop and fault injection.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from repro_torch.models import model as M
from repro_torch.runtime import scheduler as sch
from repro_torch.runtime.kv_cache import KVCacheManager, PagedKVConfig
from repro_torch.runtime.scheduler import (DecodeBatch, PrefillChunk,
                                           Request, Scheduler, make_policy)


@dataclasses.dataclass
class ServeStats:
    """Wall-clock accounting of one ``generate`` call (one-shot path)."""
    prefill_s: float
    decode_s: float
    tokens_generated: int

    @property
    def decode_tok_s(self) -> float:
        return self.tokens_generated / max(self.decode_s, 1e-9)


def pack_params(params: dict[str, Any], cfg: ModelConfig) -> dict[str, Any]:
    """Load-time compression (§4.3): run ``linear.prepare`` on every
    SparseLinear leaf-dict (a dict holding only a weight matrix 'w').
    Embedding tables and routers are not GEMMs and stay as they are."""
    sp = cfg.sparsity
    if sp.mode == "dense" or sp.pattern is None:
        return params

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, dict):
            if name in ("embed", "router") or "router" in node:
                return node
            if set(node) == {"w"} and node["w"].dim() >= 2 \
                    and node["w"].shape[-1] % sp.pattern[1] == 0:
                return sl.prepare(node, sp)
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg: ModelConfig, tokens: torch.Tensor,
             max_new_tokens: int):
    """Prefill the prompt batch [B, S], then greedy-decode
    ``max_new_tokens`` steps.  Returns (tokens [B, max_new_tokens],
    ServeStats)."""
    b, s = tokens.shape
    dev = tokens.device
    t0 = time.time()
    logits, cache, kv_len = M.prefill(params, cfg, tokens,
                                      max_len=s + max_new_tokens)
    _sync(dev)
    t_prefill = time.time() - t0
    outs = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    t1 = time.time()
    for _ in range(max_new_tokens):
        outs.append(tok)
        logits, cache, kv_len = M.serve_step(params, cfg, tok, cache, kv_len)
        tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    return torch.stack(outs, 1), ServeStats(t_prefill, time.time() - t1,
                                            b * max_new_tokens)


# ----------------------------------------------------------------- engine
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Sizing knobs for the paged serving engine.  ``tp``,
    ``prefix_cache``, ``speculate``, ``async_loop`` and ``faults`` keep the
    JAX names and must stay at their defaults until they are ported."""
    max_batch: int = 4        # decode slots
    page_size: int = 8        # tokens per KV page
    num_pages: int = 64       # physical pages per attention layer
    max_seq_len: int = 128    # prompt + generated cap per sequence
    prefill_chunk: int = 16   # prompt tokens per engine step
    policy: str = "fcfs"      # scheduler policy name (fcfs | priority)
    max_queue: int | None = None  # bounded admission queue
    watchdog: bool = False    # assert kv invariants after every decision
    tp: int = 1
    prefix_cache: bool = False
    speculate: int = 0
    async_loop: bool = False
    faults: Any = None

    def __post_init__(self):
        unported = {"tp": self.tp != 1, "prefix_cache": self.prefix_cache,
                    "speculate": self.speculate != 0,
                    "async_loop": self.async_loop,
                    "faults": self.faults is not None}
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"EngineConfig {on}: not ported yet (ROADMAP A.5 / A.8)")

    def kv_config(self) -> PagedKVConfig:
        return PagedKVConfig(page_size=self.page_size,
                             num_pages=self.num_pages,
                             max_batch=self.max_batch,
                             max_seq_len=self.max_seq_len)


@dataclasses.dataclass
class Completion:
    """A finished request: its greedy stream, eviction count and terminal
    status (``OK | TIMEOUT | CANCELLED | REJECTED | FAILED``)."""
    rid: int
    prompt: list[int]
    tokens: list[int]
    evictions: int = 0
    status: str = sch.OK
    reason: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == sch.OK


@dataclasses.dataclass
class EngineStats:
    """Engine-level counters accumulated over a ``run``."""
    steps: int = 0
    wall_s: float = 0.0
    warmup_s: float = 0.0
    decode_tokens: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    recompute_tokens: int = 0
    evictions: int = 0
    mean_occupancy: float = 0.0
    precision: str = "none"
    completed_ok: int = 0
    cancelled: int = 0
    timeouts: int = 0
    rejected: int = 0
    failed: int = 0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.wall_s, 1e-9)


class ServeEngine:
    """Continuous-batching engine over the SlideSparse pipeline.

    Two fixed-shape steps: a [1, prefill_chunk] prompt-chunk step and a
    [max_batch] decode step.  Every linear goes through ``linear.apply``
    (on the card the compressed-matmul kernel, or in ``mode="slided"`` the
    fused slided matmul) and, with
    ``sparsity.fused_attention``, every paged attention step through the
    paged-attention kernel.  Greedy sampling (first maximal index, as
    ``jnp.argmax``) runs on the device; the host fetches the ids only.
    The KV page pools are updated in place.  ``first_logits[rid]`` keeps
    the logits of each request's last prefill chunk (its first token)."""

    def __init__(self, params, cfg: ModelConfig,
                 ecfg: EngineConfig | None = None, device=None):
        from repro_torch import resolve_device

        self.ecfg = ecfg or EngineConfig()
        if cfg.is_encoder_decoder:
            raise NotImplementedError("paged engine is decoder-only")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        namespace = (f"{cfg.name}|{cfg.sparsity.recipe.name}"
                     f"|kv={cfg.kv_cache_dtype}|ps={self.ecfg.page_size}")
        self.kv = KVCacheManager(self.ecfg.kv_config(), namespace=namespace)
        self.sched = Scheduler(self.kv, self.ecfg.prefill_chunk,
                               policy=make_policy(self.ecfg.policy),
                               max_queue=self.ecfg.max_queue,
                               watchdog=self.ecfg.watchdog)
        self.cache = M.make_paged_cache(cfg, self.ecfg.num_pages,
                                        self.ecfg.page_size,
                                        self.ecfg.max_batch, self.device)
        self.completions: dict[int, Completion] = {}
        self.first_logits: dict[int, torch.Tensor] = {}
        self._prompts: dict[int, list[int]] = {}
        self.stats = EngineStats(precision=cfg.sparsity.recipe.name)

    def _t(self, arr, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=self.device)

    def _prefill(self, tokens, page_table, start: int, length: int):
        logits, self.cache = M.paged_prefill_chunk(
            self.params, self.cfg, self._t(tokens), self.cache,
            self._t(page_table), start, length, self.ecfg.page_size)
        return torch.argmax(logits, -1), logits

    def _decode(self, token, page_table, kv_len, active):
        logits, self.cache = M.paged_decode_step(
            self.params, self.cfg, self._t(token), self.cache,
            self._t(page_table), self._t(kv_len),
            self._t(active, torch.bool), self.ecfg.page_size)
        return torch.argmax(logits, -1)

    # ------------------------------------------------------------ warmup
    def warmup(self) -> float:
        """Run both steps once on dummy inputs that write nothing (a
        zero-length prefill chunk, a decode step with every slot
        inactive): the kernels build and load here, outside any measured
        window, and the page pools, page accounting and stats stay as they
        were.  Returns the elapsed seconds (``stats.warmup_s``)."""
        ec = self.ecfg
        t0 = time.time()
        ptab = self.kv.page_table_array()
        self._prefill(np.zeros((1, ec.prefill_chunk), np.int32), ptab[:1],
                      0, 0)
        self._decode(np.zeros((ec.max_batch,), np.int32), ptab,
                     np.zeros((ec.max_batch,), np.int32),
                     np.zeros((ec.max_batch,), bool))
        _sync(self.device)
        self.stats.warmup_s = time.time() - t0
        return self.stats.warmup_s

    # ------------------------------------------------------------ intake
    def submit(self, prompt: list[int], max_new_tokens: int,
               rid: int | None = None, arrival: int = 0,
               eos_id: int | None = None, priority: int = 0,
               deadline_steps: int | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue a request.  Admission is typed, never an exception: an
        oversized prompt or a full bounded queue produces a REJECTED
        completion."""
        rid = rid if rid is not None else len(self._prompts)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not prompt:
            raise ValueError("prompt must be non-empty")
        self._prompts[rid] = list(prompt)
        self.sched.submit(Request(
            rid=rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            arrival=arrival, eos_id=eos_id, priority=priority,
            deadline_step=(arrival + deadline_steps
                           if deadline_steps is not None else None),
            deadline_t=(time.monotonic() + deadline_s
                        if deadline_s is not None else None)))
        self._drain_finished()
        return rid

    def cancel(self, rid: int) -> bool:
        """Drop a waiting or running request (pages released); emits a
        CANCELLED completion with the tokens generated so far."""
        self.sched.retire_finished()
        hit = self.sched.cancel(rid)
        self._drain_finished()
        return hit

    # -------------------------------------------------------------- step
    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """The engine's one device -> host synchronization point."""
        return x.cpu().numpy()

    def _drain_finished(self) -> list[Completion]:
        out = []
        for fin in self.sched.take_finished():
            comp = Completion(fin.rid, self._prompts.get(fin.rid, []),
                              list(fin.tokens), fin.evictions,
                              status=fin.status, reason=fin.reason)
            self.completions[fin.rid] = comp
            out.append(comp)
        return out

    def step(self) -> list[Completion]:
        """Execute one scheduler decision; returns newly finished
        requests (any terminal status)."""
        self.stats.steps += 1
        decision = self.sched.next_decision()
        if decision is None:
            return self._drain_finished()
        if isinstance(decision, PrefillChunk):
            seq, start, length = decision.seq, decision.start, decision.length
            chunk = seq.prompt[start:start + length]
            chunk = chunk + [0] * (self.ecfg.prefill_chunk - length)
            pt = self.kv.page_table_array()[seq.slot:seq.slot + 1]
            ids, logits = self._prefill([chunk], pt, start, length)
            self.sched.completed_prefill(decision)
            if not seq.prefilling:  # prompt done -> first token
                self.first_logits[seq.rid] = logits[0]
                self.sched.append_token(seq, int(self._fetch(ids)[0]))
        else:
            assert isinstance(decision, DecodeBatch)
            bmax = self.ecfg.max_batch
            token = np.zeros((bmax,), np.int32)
            kvl = np.zeros((bmax,), np.int32)
            active = np.zeros((bmax,), bool)
            for seq in decision.seqs:
                token[seq.slot] = seq.out_tokens[-1]
                kvl[seq.slot] = seq.kv_len - 1  # context written
                active[seq.slot] = True
            toks = self._fetch(self._decode(token, self.kv.page_table_array(),
                                            kvl, active))
            for seq in decision.seqs:
                self.sched.append_token(seq, int(toks[seq.slot]))
        self.sched.retire_finished()
        return self._drain_finished()

    def run(self, on_step=None) -> dict[int, Completion]:
        """Drive until every submitted request reaches a terminal status.
        ``on_step(engine, step_index)`` runs after every engine step."""
        t0 = time.time()
        while self.sched.has_work:
            self.step()
            if on_step is not None:
                on_step(self, self.stats.steps)
        self.sched.retire_finished()
        self._drain_finished()
        _sync(self.device)
        s, ss = self.stats, self.sched.stats
        s.wall_s = time.time() - t0
        s.decode_tokens, s.decode_steps = ss.decode_tokens, ss.decode_steps
        s.prefill_tokens, s.evictions = ss.prefill_tokens, ss.evicted
        s.recompute_tokens = ss.recompute_tokens
        s.mean_occupancy = ss.mean_occupancy
        s.cancelled, s.timeouts = ss.cancelled, ss.timeouts
        s.rejected, s.failed = ss.rejected, ss.failed
        s.completed_ok = sum(1 for c in self.completions.values() if c.ok)
        return dict(self.completions)
