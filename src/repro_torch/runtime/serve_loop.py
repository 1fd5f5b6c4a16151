"""Serving: the one-shot prefill+decode reference and the continuous-batching
paged-KV engine (port of ``repro.runtime.serve_loop``).

``pack_params`` runs the offline packer + load-time compression on every
SparseLinear (prune -> quantize -> Phi -> compress).  ``generate`` is the
dense-cache one-shot path, the parity oracle of the engine.
:class:`ServeEngine` is the step-driven engine: requests join mid-flight,
prefill chunks interleave with decode steps, finished sequences retire and
free their KV pages.  Scheduling and page accounting are the host-side
copies in ``scheduler`` / ``kv_cache``.  The two fixed-shape model steps
read their inputs from static device buffers and, on CUDA, are captured
once each as a CUDA graph (the counterpart of JAX's jitted steps, compiled
once) and replayed.  ``async_loop`` is JAX's overlapped loop (DESIGN.md
§15): the host applies step N's tokens while the device runs step N+1.

Not ported yet (raise ``NotImplementedError``, ROADMAP A.3 / A.5): tensor
parallelism, the prefix cache, speculative decoding and fault injection.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from repro_torch.kernels import ops as kops
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
    """Sizing knobs for the paged serving engine.

    ``device_sample`` fetches the steps' on-device argmax ids (``[B]`` /
    ``[1]`` int32); False fetches the float32 logits and takes the argmax
    on the host.  Either way the steps compute both, so the flag changes
    only what crosses to the host.  ``async_loop`` overlaps the host's
    scheduling with the device (DESIGN.md §15): decode dispatch is
    decoupled from applying its tokens, and on the lookahead fast path
    step N's device-resident ids feed step N+1 with no host round trip.
    Streams, traces and statuses equal ``async_loop=False``.

    ``tp``, ``prefix_cache``, ``speculate`` and ``faults`` keep the JAX
    names and must stay at their defaults until they are ported."""
    max_batch: int = 4        # decode slots
    page_size: int = 8        # tokens per KV page
    num_pages: int = 64       # physical pages per attention layer
    max_seq_len: int = 128    # prompt + generated cap per sequence
    prefill_chunk: int = 16   # prompt tokens per engine step
    policy: str = "fcfs"      # scheduler policy name (fcfs | priority)
    max_queue: int | None = None  # bounded admission queue
    watchdog: bool = False    # assert kv invariants after every decision
    device_sample: bool = True  # fetch on-device argmax ids, not logits
    async_loop: bool = False    # overlap host scheduling with device steps
    tp: int = 1
    prefix_cache: bool = False
    speculate: int = 0
    faults: Any = None

    def __post_init__(self):
        unported = {"tp": self.tp != 1, "prefix_cache": self.prefix_cache,
                    "speculate": self.speculate != 0,
                    "faults": self.faults is not None}
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"EngineConfig {on}: not ported yet (ROADMAP A.3 / A.5)")

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
    # overlapped loop instrumentation (DESIGN.md §15)
    host_gap_s: float = 0.0     # device-idle time: step ready -> next dispatch
    overlap_frac: float = 0.0   # 1 - host_gap_s/wall_s (device-busy fraction)
    d2h_bytes: int = 0          # step-output bytes fetched device -> host
    lookahead_steps: int = 0    # decode steps dispatched via the fast path

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.wall_s, 1e-9)


class _Step:
    """One fixed-shape model step: its inputs, its body, its outputs.

    The inputs are views of one int32 device buffer, written by one
    host -> device copy per dispatch from pinned memory (``fill``); PyTorch's
    pinned-memory cache records an event with that copy and hands the
    block out again only once the copy has run, so no staging buffer is
    rewritten while its copy may still be queued.  On CUDA the body is
    captured once as a CUDA graph and every later ``run`` replays it: the
    outputs are then static buffers that the next replay overwrites.  The
    kernels' launch counters see the launches the graph records at
    capture added on each replay, so a graphed run counts what an eager
    run of the same steps counts."""

    def __init__(self, fields: dict[str, tuple[int, ...]], body,
                 device: torch.device):
        self.body, self.device = body, device
        self.layout, n = {}, 0
        for name, shape in fields.items():
            size = math.prod(shape)
            self.layout[name] = (n, size, shape)
            n += size
        self.buf = torch.zeros((n,), dtype=torch.int32, device=device)
        self.inputs = {name: self.buf[o:o + size].view(shape)
                       for name, (o, size, shape) in self.layout.items()}
        self.graph = None
        self.captures = 0
        self.counts = None      # launch counters one replay adds
        self.out = None         # (ids int32, logits) of the last run

    def fill(self, **values) -> None:
        host = np.empty(self.buf.shape, np.int32)
        for name, (o, size, _) in self.layout.items():
            host[o:o + size] = np.asarray(values[name]).reshape(size)
        staged = torch.from_numpy(host)
        if self.device.type == "cuda":
            staged = staged.pin_memory()
        self.buf.copy_(staged, non_blocking=True)

    def run(self):
        if self.graph is None:
            self.out = self.body(self.inputs)
        else:
            self.graph.replay()
            kops.add_launch_counts(self.counts)
        return self.out

    def capture(self) -> None:
        """Record the body as a CUDA graph (once).  Call it after one eager
        run, so the kernels are built and their one-time attribute set-up
        is done outside the capture."""
        graph = torch.cuda.CUDAGraph()
        with kops.recorded_launches() as counts:
            with torch.cuda.graph(graph):
                out = self.body(self.inputs)
        self.graph, self.out, self.counts = graph, out, counts
        self.captures += 1


class ServeEngine:
    """Continuous-batching engine over the SlideSparse pipeline.

    Two fixed-shape steps: a [1, prefill_chunk] prompt-chunk step and a
    [max_batch] decode step.  Every linear goes through ``linear.apply``
    (on the card the compressed-matmul kernel, or in ``mode="slided"`` the
    fused slided matmul) and, with ``sparsity.fused_attention``, every
    paged attention step through the paged-attention kernel.  Greedy
    sampling (first maximal index, as ``jnp.argmax``) runs on the device.

    The steps read no device value on the host: each dispatch is one copy
    of its inputs to a static device buffer and one run of the step.  On
    CUDA ``warmup`` captures each step once as a CUDA graph (JAX's
    compile-once contract, ``captures`` == 1 per step) and every step
    replays it; a capture or replay failure raises.  On the CPU the same
    code runs eagerly.  The engine's only device -> host synchronization
    is ``_fetch``, which waits for one step's sampled ids.  The KV page
    pools are updated in place.  ``first_logits[rid]`` keeps the logits
    of each request's last prefill chunk (its first token).

    ``_eager`` (private) keeps a CUDA engine from capturing: the eager
    steps the graphs are held against."""

    def __init__(self, params, cfg: ModelConfig,
                 ecfg: EngineConfig | None = None, device=None, *,
                 _eager: bool = False):
        from repro_torch import resolve_device

        self.ecfg = ec = ecfg or EngineConfig()
        if cfg.is_encoder_decoder:
            raise NotImplementedError("paged engine is decoder-only")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        namespace = (f"{cfg.name}|{cfg.sparsity.recipe.name}"
                     f"|kv={cfg.kv_cache_dtype}|ps={ec.page_size}")
        self.kv = KVCacheManager(ec.kv_config(), namespace=namespace)
        self.sched = Scheduler(self.kv, ec.prefill_chunk,
                               policy=make_policy(ec.policy),
                               max_queue=ec.max_queue,
                               watchdog=ec.watchdog)
        self.cache = M.make_paged_cache(cfg, ec.num_pages, ec.page_size,
                                        ec.max_batch, self.device)
        self.completions: dict[int, Completion] = {}
        self.first_logits: dict[int, torch.Tensor] = {}
        self._prompts: dict[int, list[int]] = {}
        self.stats = EngineStats(precision=cfg.sparsity.recipe.name)
        self._graphed = self.device.type == "cuda" and not _eager
        maxp = ec.kv_config().max_pages_per_seq
        bmax = ec.max_batch
        self._steps = {
            "prefill": _Step({"tokens": (1, ec.prefill_chunk),
                              "page_table": (1, maxp), "start": (),
                              "real_len": ()}, self._prefill_body,
                             self.device),
            "decode": _Step({"tokens": (bmax,), "page_table": (bmax, maxp),
                             "kv_len": (bmax,), "active": (bmax,)},
                            self._decode_body, self.device)}
        # overlapped-loop state (DESIGN.md §15): the dispatched-but-not-
        # applied decode step (decision + its queued ids copy) and the
        # instant the last fetched step output became ready
        self._pending = None
        self._t_ready: float | None = None

    @property
    def captures(self) -> dict[str, int]:
        """CUDA graph captures per step (0 on the CPU or when eager)."""
        return {name: st.captures for name, st in self._steps.items()}

    def _prefill_body(self, inp):
        logits, _ = M.paged_prefill_chunk(
            self.params, self.cfg, inp["tokens"], self.cache,
            inp["page_table"], inp["start"], inp["real_len"],
            self.ecfg.page_size)
        return torch.argmax(logits, -1).to(torch.int32), logits

    def _decode_body(self, inp):
        logits, _ = M.paged_decode_step(
            self.params, self.cfg, inp["tokens"], self.cache,
            inp["page_table"], inp["kv_len"], inp["active"] != 0,
            self.ecfg.page_size)
        return torch.argmax(logits, -1).to(torch.int32), logits

    def _prefill(self, tokens, page_table, start: int, length: int):
        """Dispatch one prompt chunk; returns its (ids, logits) outputs."""
        st = self._steps["prefill"]
        self._note_dispatch()
        st.fill(tokens=tokens, page_table=page_table, start=start,
                real_len=length)
        return st.run()

    def _decode(self, token, page_table, kv_len, active):
        """Dispatch one decode step; ``token=None`` threads the previous
        decode step's device-resident ids in as this step's tokens (a
        device-side copy queued before the step)."""
        st = self._steps["decode"]
        self._note_dispatch()
        st.fill(tokens=np.zeros_like(kv_len) if token is None else token,
                page_table=page_table, kv_len=kv_len, active=active)
        if token is None:
            st.inputs["tokens"].copy_(st.out[0])
        return st.run()

    # ------------------------------------------------------------ warmup
    def warmup(self) -> float:
        """Run both steps once on dummy inputs that write nothing real (a
        zero-length prefill chunk, a decode step with every slot
        inactive: their writes land in the spare page): the kernels build,
        load and make their one-time set-up here, outside any measured
        window.  On CUDA each step is then captured as a CUDA graph, once
        per engine, and asserted to hold exactly one capture.  The page
        pools' real pages, the page accounting and the stats stay as they
        were.  Returns the elapsed seconds (``stats.warmup_s``)."""
        ec = self.ecfg
        t0 = time.time()
        ptab = self.kv.page_table_array()
        dummy = {"prefill": dict(tokens=np.zeros((1, ec.prefill_chunk)),
                                 page_table=ptab[:1], start=0, real_len=0),
                 "decode": dict(tokens=np.zeros(ec.max_batch),
                                page_table=ptab,
                                kv_len=np.zeros(ec.max_batch),
                                active=np.zeros(ec.max_batch))}
        for name, st in self._steps.items():
            st.fill(**dummy[name])
            st.run()
            if self._graphed and st.graph is None:
                st.capture()
        _sync(self.device)
        self._check_captures()
        self.stats.warmup_s = time.time() - t0
        return self.stats.warmup_s

    def _ensure_captured(self) -> None:
        """Warm up on first use, as a jitted step compiles on first call."""
        if self._graphed and self._steps["decode"].graph is None:
            self.warmup()

    def _check_captures(self) -> None:
        if self._graphed:
            assert self.captures == {"prefill": 1, "decode": 1}, \
                f"each step must be captured exactly once: {self.captures}"

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
        CANCELLED completion with the tokens generated so far.  An
        in-flight decode step (``async_loop``) is applied first, so a
        cancel keeps the synchronous loop's step-boundary semantics."""
        self._apply_pending()
        self.sched.retire_finished()
        hit = self.sched.cancel(rid)
        self._drain_finished()
        return hit

    # -------------------------------------------------------------- step
    def _to_host(self, x: torch.Tensor):
        """Queue a copy of a step output into pinned host memory, and an
        event after it; ``_fetch`` waits for that event only, never for
        work queued later."""
        if not x.is_cuda:
            return x.clone(), None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _fetch(self, handle) -> np.ndarray:
        """Materialize one queued step output on the host: the engine's
        ONLY device -> host synchronization point.  Accounts the payload
        in ``stats.d2h_bytes`` ([B] int32 per decode step on the
        device-sample path) and stamps ``_t_ready``: host time from here
        to the next dispatch is device-idle gap (``stats.host_gap_s``)."""
        host, done = handle
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        self.stats.d2h_bytes += arr.nbytes
        self._t_ready = time.time()
        return arr

    def _note_dispatch(self) -> None:
        """Called immediately before handing the device new step work:
        closes the host-gap window opened by the last ``_fetch``."""
        if self._t_ready is not None:
            self.stats.host_gap_s += max(0.0, time.time() - self._t_ready)
            self._t_ready = None

    def _apply_pending(self) -> None:
        """Land the in-flight decode step (async loop): fetch its sampled
        ids, waiting for that step only, and append them through
        ``Scheduler.completed_decode``, which skips lanes whose sequence
        left ``running`` between dispatch and apply."""
        if self._pending is None:
            return
        batch, handle = self._pending
        self._pending = None
        ids = self._fetch(handle)
        self.sched.completed_decode(
            batch, [int(ids[s.slot]) for s in batch.seqs])

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
        requests (any terminal status).

        With ``async_loop`` a decode step may still be in flight from the
        previous call.  The fast path asks the scheduler for a lookahead
        decode decision (provably the same batch whatever the in-flight
        step sampled) and dispatches it at once, threading step N's
        device-resident ids in as step N+1's tokens; only then does the
        host land step N's tokens, while the device runs step N+1.  With
        no safe lookahead the pending step is applied first and the
        decision falls through to the synchronous path, which then sees
        exactly the state the synchronous loop would have: async-on
        traces equal async-off."""
        self._ensure_captured()
        self.stats.steps += 1
        if self.ecfg.async_loop and self._pending is not None:
            la = self.sched.lookahead_decode(self._pending[0])
            if la is not None:
                return self._threaded_decode(la)
            self._apply_pending()
            self.sched.retire_finished()
        return self._sync_step()

    def _threaded_decode(self, la: DecodeBatch) -> list[Completion]:
        """Fast-path decode dispatch: step N+1 starts from step N's
        on-device ids before step N's results reach the host."""
        batch, _ = self._pending
        bmax = self.ecfg.max_batch
        kvl = np.zeros((bmax,), np.int32)
        active = np.zeros((bmax,), bool)
        for seq in la.seqs:
            # tokens are not applied yet, so seq.kv_len is the pre-apply
            # length == the context-written count the decode step wants;
            # inactive lanes of the threaded ids carry lane garbage, whose
            # writes are dropped like the sync path's zero padding
            kvl[seq.slot] = seq.kv_len
            active[seq.slot] = True
        ids, _ = self._decode(None, self.kv.page_table_array(), kvl, active)
        handle = self._to_host(ids)
        self.stats.lookahead_steps += 1
        # overlap window: the device runs step N+1 while the host fetches
        # and applies step N here
        self._apply_pending()
        self._t_ready = None  # the device holds queued work: not idle
        self._pending = (la, handle)
        self.sched.retire_finished()  # no-op by the lookahead precondition
        return self._drain_finished()

    def _sync_step(self) -> list[Completion]:
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
                # the static output is overwritten by the next chunk
                self.first_logits[seq.rid] = logits[0].clone()
                # mid-prompt chunks fetch nothing; the last one [1] int32,
                # or the logits row on the host-sample path
                if self.ecfg.device_sample:
                    tok = int(self._fetch(self._to_host(ids))[0])
                else:
                    tok = int(np.argmax(self._fetch(
                        self._to_host(logits[0].float()))))
                self.sched.append_token(seq, tok)
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
            ids, logits = self._decode(token, self.kv.page_table_array(),
                                       kvl, active)
            if self.ecfg.async_loop:
                # defer the apply: the tokens land at the next step() /
                # cancel() boundary, overlapped with host scheduling
                self._pending = (decision, self._to_host(ids))
                return self._drain_finished()
            if self.ecfg.device_sample:
                toks = self._fetch(self._to_host(ids))          # [B] int32
            else:
                toks = np.argmax(self._fetch(self._to_host(logits.float())),
                                 axis=-1)
            for seq in decision.seqs:
                self.sched.append_token(seq, int(toks[seq.slot]))
        self.sched.retire_finished()
        return self._drain_finished()

    def run(self, on_step=None) -> dict[int, Completion]:
        """Drive until every submitted request reaches a terminal status.
        ``on_step(engine, step_index)`` runs after every engine step."""
        self._ensure_captured()
        self._t_ready = None  # idle time before the run is not the run's
        t0 = time.time()
        while self.sched.has_work:
            self.step()
            if on_step is not None:
                on_step(self, self.stats.steps)
        self._apply_pending()  # nothing may stay in flight past run
        self.sched.retire_finished()
        self._drain_finished()
        _sync(self.device)
        self._check_captures()
        s, ss = self.stats, self.sched.stats
        s.wall_s = time.time() - t0
        s.overlap_frac = max(0.0, min(1.0, 1.0 - s.host_gap_s
                                      / max(s.wall_s, 1e-9)))
        s.decode_tokens, s.decode_steps = ss.decode_tokens, ss.decode_steps
        s.prefill_tokens, s.evictions = ss.prefill_tokens, ss.evicted
        s.recompute_tokens = ss.recompute_tokens
        s.mean_occupancy = ss.mean_occupancy
        s.cancelled, s.timeouts = ss.cancelled, ss.timeouts
        s.rejected, s.failed = ss.rejected, ss.failed
        s.completed_ok = sum(1 for c in self.completions.values() if c.ok)
        return dict(self.completions)
