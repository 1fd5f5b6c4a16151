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
once) and replayed.  Two more fixed-shape steps serve the engine's
features: the copy-on-write page copy behind the radix prefix cache
(DESIGN.md §11) and the speculative verify step (§14).  Faults injected
by ``faults.FaultInjector`` meet bounded step retries (§12).
``async_loop`` is JAX's overlapped loop (DESIGN.md §15): the host applies
step N's tokens while the device runs step N+1.

Tensor parallelism (``EngineConfig.tp = N``, DESIGN.md §9): the engine
runs in each of N ``torch.distributed`` ranks (``sharding.dist`` starts
them), each holding only its shard of the weights (column- / row-parallel
linears, ``sharding.tp.shard_params``) and of the paged KV pool (KVH/N
heads) and SSM state; the steps run the same kernels on the local shapes
inside ``tp.activate``, with one all-reduce after each row-parallel
projection and greedy ids from ``tp.argmax_tokens``, so the streams are
the single-rank engine's.  The host scheduler runs in every rank; its
decisions depend only on the submitted traffic, the sampled ids (the
same on every rank) and the seeded ``FaultPlan``, so the ranks issue
their collectives in the same order.  A wall-clock deadline would not be
the same on every rank and is refused under tp > 1.  TP steps run eager:
a gloo collective is a host call, which a CUDA graph cannot capture
(``captures`` reads 0).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import math
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M, moe
from repro_torch.runtime import draft as draft_mod, faults as fl
from repro_torch.runtime import scheduler as sch
from repro_torch.runtime.kv_cache import KVCacheManager, PagedKVConfig
from repro_torch.runtime.scheduler import (DecodeBatch, PrefillChunk,
                                           Request, Scheduler, VerifyBatch,
                                           make_policy)
from repro_torch.sharding import tp as tpmod


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
    SparseLinear leaf-dict (a dict holding only a weight matrix 'w'), in
    the unit lists of a decoder and the encoder/decoder layer lists of an
    encoder-decoder alike.  Embedding tables and routers are not GEMMs and
    stay as they are.  An
    MoE block's expert stacks run as batched matmuls, not SparseLinear:
    they are pruned to the pattern once here (``moe.prune_stacks``),
    where JAX prunes them on every call."""
    sp = cfg.sparsity
    if sp.mode == "dense" or sp.pattern is None:
        return params

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, dict):
            if name in ("embed", "router"):
                return node
            if "router" in node:
                return moe.prune_stacks(node, sp)
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
             max_new_tokens: int, *, extra_embeds=None):
    """Prefill the prompt batch [B, S], then greedy-decode
    ``max_new_tokens`` steps.  ``extra_embeds``: the modality stub's
    output, the audio frames an encoder-decoder needs or a vision prefix
    (``M.prefill``).  Returns (tokens [B, max_new_tokens], ServeStats)."""
    b, s = tokens.shape
    dev = tokens.device
    t0 = time.time()
    logits, cache, kv_len = M.prefill(params, cfg, tokens,
                                      max_len=s + max_new_tokens,
                                      extra_embeds=extra_embeds)
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
    Streams, traces and statuses equal ``async_loop=False``; speculation
    and a live fault injector always take the synchronous path.

    ``prefix_cache`` turns on radix-prefix reuse over ref-counted
    copy-on-write pages (DESIGN.md §11): an admission that shares
    full-page prompt blocks with earlier traffic forks the cached pages
    and prefills only the uncached suffix; a shared page is copied by the
    COW step before a step writes into it.  ``speculate=K > 0`` turns on
    self-speculative decoding (§14): ``draft_source`` (``ngram`` |
    ``random``) proposes up to K tokens per running sequence and the
    ``[max_batch, K+1]`` verify step scores them in one pass; the longest
    agreeing prefix is accepted, so greedy streams equal ``speculate=0``.
    ``faults`` (a ``faults.FaultPlan``) injects deterministic faults
    (§12); a failed step dispatch is retried up to ``step_retries`` times
    with a backoff of ``retry_backoff_s * 2**attempt`` (jittered), then
    fails the decision's requests.  ``tp`` is the tensor-parallel degree
    (DESIGN.md §9): the engine then runs in each of ``tp`` ranks of the
    default ``torch.distributed`` group.  Page counts are per shard-
    replicated table: every rank holds the same ``num_pages`` page
    structure, each page carrying its KVH/tp heads."""
    max_batch: int = 4        # decode slots
    page_size: int = 8        # tokens per KV page
    num_pages: int = 64       # physical pages per attention layer
    max_seq_len: int = 128    # prompt + generated cap per sequence
    prefill_chunk: int = 16   # prompt tokens per engine step
    tp: int = 1
    prefix_cache: bool = False  # radix prefix cache + COW pages (§11)
    policy: str = "fcfs"      # scheduler policy name (fcfs | priority)
    speculate: int = 0        # max draft tokens per verify step (0 = off)
    draft_source: str = "ngram"  # draft source name (ngram | random)
    device_sample: bool = True  # fetch on-device argmax ids, not logits
    async_loop: bool = False    # overlap host scheduling with device steps
    max_queue: int | None = None  # bounded admission queue
    watchdog: bool = False    # assert kv invariants after every decision
    step_retries: int = 2     # transient step-error retries before FAILED
    retry_backoff_s: float = 0.0  # backoff base between step retries
    faults: Any = None        # faults.FaultPlan: deterministic injection

    def kv_config(self) -> PagedKVConfig:
        return PagedKVConfig(page_size=self.page_size,
                             num_pages=self.num_pages,
                             max_batch=self.max_batch,
                             max_seq_len=self.max_seq_len, tp=self.tp)


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
    """Engine-level counters accumulated over a ``run``.
    ``prefill_tokens`` counts first-pass prompt tokens only; the
    re-prefills that recompute-preemption forces are
    ``recompute_tokens``."""
    steps: int = 0
    wall_s: float = 0.0
    warmup_s: float = 0.0
    decode_tokens: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    recompute_tokens: int = 0
    evictions: int = 0
    mean_occupancy: float = 0.0
    tp: int = 1               # tensor-parallel degree of the run
    precision: str = "none"
    # speculative decoding (DESIGN.md §14)
    verify_steps: int = 0     # VerifyBatch steps executed
    draft_tokens: int = 0     # draft tokens proposed
    accepted_tokens: int = 0  # draft tokens accepted (bonus tokens excluded)
    # prefix cache (DESIGN.md §11)
    prefix_cache: bool = False
    prefix_hit_tokens: int = 0       # prompt tokens served from cached pages
    prefill_chunks_skipped: int = 0  # prefill steps avoided by hits
    cow_copies: int = 0              # device page copies (copy-on-write)
    cached_page_evictions: int = 0   # LRU reclaims of refcount-0 pages
    # request lifecycle (DESIGN.md §12)
    completed_ok: int = 0
    cancelled: int = 0
    timeouts: int = 0
    rejected: int = 0
    failed: int = 0
    quarantined: int = 0             # watchdog invariant quarantines
    admission_deferrals: int = 0     # admissions deferred by alloc failure
    step_errors: int = 0             # transient step-dispatch faults seen
    step_retries: int = 0            # retries that recovered a step
    faults_injected: int = 0         # injector-fired faults (all sites)
    goodput_tokens: int = 0          # tokens of OK completions only
    p95_queue_wait_steps: float = 0.0
    # overlapped loop instrumentation (DESIGN.md §15)
    host_gap_s: float = 0.0     # device-idle time: step ready -> next dispatch
    overlap_frac: float = 0.0   # 1 - host_gap_s/wall_s (device-busy fraction)
    d2h_bytes: int = 0          # step-output bytes fetched device -> host
    lookahead_steps: int = 0    # decode steps dispatched via the fast path

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.wall_s, 1e-9)

    @property
    def acceptance_rate(self) -> float:
        """Accepted fraction of proposed draft tokens (0 when no drafts)."""
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def goodput_tok_s(self) -> float:
        """Throughput counting only tokens delivered in OK completions."""
        return self.goodput_tokens / max(self.wall_s, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        """Cached fraction of all prompt tokens that needed KV."""
        total = (self.prefix_hit_tokens + self.prefill_tokens
                 + self.recompute_tokens)
        return self.prefix_hit_tokens / max(total, 1)

    @property
    def decode_tok_s_per_device(self) -> float:
        """Decode throughput divided by the TP degree."""
        return self.decode_tok_s / max(self.tp, 1)


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
        is done outside the capture.  A dead engine (its steps and their
        bound bodies form a cycle) frees its graphs wherever the cyclic
        collector runs, and freeing a graph during a capture invalidates
        the capture: the collector runs first and stays off until the
        capture ends."""
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kops.recorded_launches() as counts:
                with torch.cuda.graph(graph):
                    out = self.body(self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.graph, self.out, self.counts = graph, out, counts
        self.captures += 1


class ServeEngine:
    """Continuous-batching engine over the SlideSparse pipeline.

    Fixed-shape steps: a [1, prefill_chunk] prompt-chunk step, a
    [max_batch] decode step, on a stack with a page pool a [_cow_lanes]
    copy-on-write page-copy step and, with ``speculate=K > 0``, a
    [max_batch, K+1] verify step.
    Scheduling, drafting, accept/reject and page accounting stay on the
    host.  Every linear goes through ``linear.apply``
    (on the card the compressed-matmul kernel, or in ``mode="slided"`` the
    fused slided matmul) and, with ``sparsity.fused_attention``, every
    paged attention step through the paged-attention kernel.  Greedy
    sampling (first maximal index, as ``jnp.argmax``) runs on the device.

    The steps read no device value on the host: each dispatch is one copy
    of its inputs to a static device buffer and one run of the step.  On
    CUDA ``warmup`` captures each step once as a CUDA graph (JAX's
    compile-once contract, ``captures`` == 1 per step) and every step
    replays it; a capture or replay failure raises.

    With ``prefix_cache`` the engine hashes each prompt's full pages at
    enqueue, the scheduler forks cached pages in at admission, and the
    COW step copies a shared page before the step that writes into it;
    paged K/V writes are token-local, so cache-on streams equal cache-off.
    With ``faults`` the injector's ``step`` site fires before a step's
    inputs are copied, so a retry is always safe; a poisoned request
    fails at its first prefill dispatch.  On the CPU the same
    code runs eagerly.  The engine's only device -> host synchronization
    is ``_fetch``, which waits for one step's sampled ids.  The KV page
    pools are updated in place.  ``first_logits[rid]`` keeps the logits
    of each request's last prefill chunk (its first token).

    On a stack with SSM layers each slot also carries recurrent state: a
    prefill chunk names its slot and whether it is the sequence's first
    (``reset`` zeroes the slot's state), and a decode step keeps the
    state of inactive slots.  As in JAX, such an engine refuses
    ``prefix_cache`` and ``speculate``.  Under MoE the rows of a step
    share expert capacity, so an inactive decode lane (fed token 0, as
    JAX feeds it) takes capacity too.

    With ``tp > 1`` the engine is one rank of a tensor-parallel group (see
    the module docstring): ``params`` is the whole loaded tree, of which
    the rank keeps only its shard; ``first_logits`` and the host-sample
    path read the whole vocabulary (gathered).  It raises ValueError
    unless ``torch.distributed`` is initialized with world size ``tp``.

    ``_eager`` (private) keeps a CUDA engine from capturing: the eager
    steps the graphs are held against."""

    def __init__(self, params, cfg: ModelConfig,
                 ecfg: EngineConfig | None = None, device=None, *,
                 _eager: bool = False):
        from repro_torch import resolve_device

        self.ecfg = ec = ecfg or EngineConfig()
        if cfg.is_encoder_decoder:
            raise NotImplementedError("paged engine is decoder-only")
        self._group = None
        if ec.tp > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    f"tp={ec.tp} needs torch.distributed initialized with "
                    f"world size {ec.tp}, one process per rank "
                    "(sharding.dist.launch starts them); no process group "
                    "is initialized")
            if dist.get_world_size() != ec.tp:
                raise ValueError(
                    f"tp={ec.tp} needs a process group of world size "
                    f"{ec.tp}, not {dist.get_world_size()}")
            tpmod.validate(cfg, ec.tp)
            self._group = dist.group.WORLD
            # each rank keeps only its shard from here on
            params = tpmod.shard_params(params, cfg, dist.get_rank(), ec.tp)
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        if ec.prefix_cache and cfg.uses_ssm:
            raise ValueError(
                "prefix_cache requires an attention-only stack: SSM layers "
                "carry per-slot recurrent state that cached pages cannot "
                "restore at the resume point (DESIGN.md §11)")
        if ec.speculate > 0 and cfg.uses_ssm:
            raise ValueError(
                "speculate requires an attention-only stack: SSM layers "
                "advance per-slot recurrent state in place, so a rejected "
                "draft suffix cannot be rolled back (DESIGN.md §14)")
        if ec.speculate < 0:
            raise ValueError(f"speculate={ec.speculate} must be >= 0")
        # prefix-cache entries are keyed to the exact serving recipe
        namespace = (f"{cfg.name}|{cfg.sparsity.recipe.name}"
                     f"|kv={cfg.kv_cache_dtype}|tp={ec.tp}"
                     f"|ps={ec.page_size}")
        self.injector = (fl.FaultInjector(ec.faults)
                         if ec.faults is not None else None)
        self.kv = KVCacheManager(ec.kv_config(), namespace=namespace,
                                 injector=self.injector)
        self.draft_source = None
        if ec.speculate > 0:
            kw = ({"vocab_size": cfg.vocab_size}
                  if ec.draft_source == "random" else {})
            self.draft_source = draft_mod.make_draft_source(ec.draft_source,
                                                            **kw)
        self.sched = Scheduler(self.kv, ec.prefill_chunk,
                               policy=make_policy(ec.policy),
                               prefix_cache=ec.prefix_cache,
                               max_queue=ec.max_queue,
                               watchdog=ec.watchdog,
                               speculate=ec.speculate,
                               draft_source=self.draft_source)
        with self._tp():  # the rank's shard of the pools and SSM state
            self.cache = M.make_paged_cache(cfg, ec.num_pages, ec.page_size,
                                            ec.max_batch, self.device)
        self.completions: dict[int, Completion] = {}
        self.first_logits: dict[int, torch.Tensor] = {}
        self._prompts: dict[int, list[int]] = {}
        self.stats = EngineStats(tp=ec.tp, precision=cfg.sparsity.recipe.name)
        # a TP step's collectives are host calls: its steps stay eager
        self._graphed = (self.device.type == "cuda" and not _eager
                         and ec.tp == 1)
        maxp = ec.kv_config().max_pages_per_seq
        bmax = ec.max_batch
        # one COW call copies a decode batch's write pages (<= 1 per slot)
        # or a prefill chunk's page span
        self._cow_lanes = max(bmax, -(-ec.prefill_chunk // ec.page_size) + 1)
        # verify lanes: the last emitted token + up to `speculate` drafts
        self._verify_lanes = ec.speculate + 1
        self._steps = {
            "prefill": _Step({"tokens": (1, ec.prefill_chunk),
                              "page_table": (1, maxp), "start": (),
                              "real_len": (), "slot": (), "reset": ()},
                             self._prefill_body, self.device),
            "decode": _Step({"tokens": (bmax,), "page_table": (bmax, maxp),
                             "kv_len": (bmax,), "active": (bmax,)},
                            self._decode_body, self.device)}
        if any(kind != "ssm" for kind in cfg.unit_pattern):
            # a stack with no page pool has no pages to copy
            self._steps["cow"] = _Step({"src": (self._cow_lanes,),
                                        "dst": (self._cow_lanes,)},
                                       self._cow_body, self.device)
        if ec.speculate > 0:
            self._steps["verify"] = _Step(
                {"tokens": (bmax, self._verify_lanes),
                 "page_table": (bmax, maxp), "kv_len": (bmax,),
                 "real_len": (bmax,), "active": (bmax,)},
                self._verify_body, self.device)
        # overlapped-loop state (DESIGN.md §15): the dispatched-but-not-
        # applied decode step (decision + its queued ids copy), the
        # instant the last fetched step output became ready, and the
        # backoff occurrence counter (its jitter)
        self._pending = None
        self._t_ready: float | None = None
        self._backoff_n = 0

    @property
    def captures(self) -> dict[str, int]:
        """CUDA graph captures per step (0 on the CPU, when eager and under
        tp > 1)."""
        return {name: st.captures for name, st in self._steps.items()}

    def _tp(self):
        """The tensor-parallel context of this rank's steps (none at
        tp = 1)."""
        if self._group is None:
            return contextlib.nullcontext()
        return tpmod.activate(self._group)

    def _whole(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary of a step's (vocab-sharded) logits."""
        with self._tp():
            return tpmod.gather_last(logits)

    def _prefill_body(self, inp):
        with self._tp():
            logits, _ = M.paged_prefill_chunk(
                self.params, self.cfg, inp["tokens"], self.cache,
                inp["page_table"], inp["start"], inp["real_len"],
                inp["slot"], inp["reset"] != 0, self.ecfg.page_size)
            return tpmod.argmax_tokens(logits), logits

    def _decode_body(self, inp):
        with self._tp():
            logits, _ = M.paged_decode_step(
                self.params, self.cfg, inp["tokens"], self.cache,
                inp["page_table"], inp["kv_len"], inp["active"] != 0,
                self.ecfg.page_size)
            return tpmod.argmax_tokens(logits), logits

    def _verify_body(self, inp):
        with self._tp():
            logits, _ = M.paged_verify_step(
                self.params, self.cfg, inp["tokens"], self.cache,
                inp["page_table"], inp["kv_len"], inp["real_len"],
                inp["active"] != 0, self.ecfg.page_size)
            return tpmod.argmax_tokens(logits), logits

    def _cow_body(self, inp):
        # per-rank elementwise on the head-sharded pools
        M.paged_copy_pages(self.cfg, self.cache, inp["src"], inp["dst"])

    def _dispatch(self, name: str, **inputs) -> _Step:
        """Copy a step's inputs to its static buffer, through the fault
        injector's ``step`` site with bounded retry and backoff: a
        :class:`faults.TransientStepError` fires before anything is
        copied, so retrying is always safe.  Exhausting ``step_retries``
        raises it for the caller to fail the decision's requests.  The
        caller runs the returned step."""
        if self.injector is not None:
            attempts = self.ecfg.step_retries + 1
            for attempt in range(attempts):
                if not self.injector.fire("step"):
                    break
                self.stats.step_errors += 1
                if attempt + 1 >= attempts:
                    raise fl.TransientStepError(
                        f"injected step failure persisted through "
                        f"{self.ecfg.step_retries} retries")
                self.stats.step_retries += 1
                if self.ecfg.retry_backoff_s:
                    self._backoff_wait(attempt)
        st = self._steps[name]
        self._note_dispatch()
        st.fill(**inputs)
        return st

    def _backoff_wait(self, attempt: int) -> None:
        """Backoff between step retries: ``retry_backoff_s * 2**attempt``
        with a deterministic jitter of 0.5x-1.5x (blake2b of the fault seed
        and the backoff occurrence), so a schedule replays exactly.  A
        deferred decode apply is drained first and only the rest of the
        delay is slept."""
        base = self.ecfg.retry_backoff_s * (2 ** attempt)
        seed = self.ecfg.faults.seed if self.ecfg.faults is not None else 0
        h = hashlib.blake2b(f"backoff|{seed}|{self._backoff_n}".encode(),
                            digest_size=8).digest()
        self._backoff_n += 1
        delay = base * (0.5 + int.from_bytes(h, "big") / 2.0 ** 64)
        t0 = time.time()
        self._apply_pending()
        remaining = delay - (time.time() - t0)
        if remaining > 0:
            time.sleep(remaining)

    def _prefill(self, tokens, page_table, start: int, length: int,
                 slot: int = 0, reset: bool = False):
        """Dispatch one prompt chunk of the sequence in ``slot`` (``reset``
        on its first chunk zeroes the slot's SSM state); returns its
        (ids, logits) outputs."""
        return self._dispatch("prefill", tokens=tokens, page_table=page_table,
                              start=start, real_len=length, slot=slot,
                              reset=reset).run()

    def _decode(self, token, page_table, kv_len, active):
        """Dispatch one decode step; ``token=None`` threads the previous
        decode step's device-resident ids in as this step's tokens (a
        device-side copy queued before the step)."""
        st = self._dispatch(
            "decode", tokens=np.zeros_like(kv_len) if token is None
            else token, page_table=page_table, kv_len=kv_len, active=active)
        if token is None:
            st.inputs["tokens"].copy_(st.out[0])
        return st.run()

    def _verify(self, tokens, page_table, kv_len, real_len, active):
        """Dispatch one verify step; returns its ([B, K+1] ids, logits)."""
        return self._dispatch("verify", tokens=tokens, page_table=page_table,
                              kv_len=kv_len, real_len=real_len,
                              active=active).run()

    def _run_cow(self, pairs) -> None:
        """Copy the host-decided copy-on-write pages on the device before
        the step that writes into the (now exclusive) dst pages, in calls
        of the fixed ``_cow_lanes`` shape; unused lanes copy page 0 into
        the spare page."""
        if not pairs:
            return
        st, n = self._steps["cow"], self._cow_lanes  # pairs need a pool
        for i in range(0, len(pairs), n):
            src = np.zeros((n,), np.int32)
            dst = np.full((n,), self.ecfg.num_pages, np.int32)
            for j, (a, b) in enumerate(pairs[i:i + n]):
                src[j], dst[j] = a, b
            self._note_dispatch()
            st.fill(src=src, dst=dst)
            st.run()
        self.stats.cow_copies += len(pairs)

    # ------------------------------------------------------------ warmup
    def warmup(self) -> float:
        """Run every step once on dummy inputs that write nothing real (a
        zero-length prefill chunk, decode and verify steps with every slot
        inactive, a COW call whose lanes all copy into the spare page:
        their writes land in the spare page, and slot 0's SSM state is
        written back unchanged): the kernels build,
        load and make their one-time set-up here, outside any measured
        window.  On CUDA each step is then captured as a CUDA graph, once
        per engine, and asserted to hold exactly one capture.  The page
        pools' real pages, the page accounting and the stats stay as they
        were.  Returns the elapsed seconds (``stats.warmup_s``)."""
        ec = self.ecfg
        t0 = time.time()
        ptab = self.kv.page_table_array()
        dummy = {"prefill": dict(tokens=np.zeros((1, ec.prefill_chunk)),
                                 page_table=ptab[:1], start=0, real_len=0,
                                 slot=0, reset=False),
                 "decode": dict(tokens=np.zeros(ec.max_batch),
                                page_table=ptab,
                                kv_len=np.zeros(ec.max_batch),
                                active=np.zeros(ec.max_batch)),
                 "cow": dict(src=np.zeros(self._cow_lanes),
                             dst=np.full(self._cow_lanes, ec.num_pages)),
                 "verify": dict(tokens=np.zeros((ec.max_batch,
                                                 self._verify_lanes)),
                                page_table=ptab,
                                kv_len=np.zeros(ec.max_batch),
                                real_len=np.ones(ec.max_batch),
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
            assert all(n == 1 for n in self.captures.values()), \
                f"each step must be captured exactly once: {self.captures}"

    # ------------------------------------------------------------ intake
    def submit(self, prompt: list[int], max_new_tokens: int,
               rid: int | None = None, arrival: int = 0,
               eos_id: int | None = None, priority: int = 0,
               deadline_steps: int | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue a request.  Admission is typed, never an exception: an
        oversized prompt or a full bounded queue produces a REJECTED
        completion.  Under tp > 1 every rank submits the same requests in
        the same order, and ``deadline_s`` is refused (each rank's clock
        would time the request out at its own step)."""
        rid = rid if rid is not None else len(self._prompts)
        if deadline_s is not None and self.ecfg.tp > 1:
            raise ValueError("deadline_s is a wall-clock deadline, which "
                             "the ranks of a tp > 1 engine would not agree "
                             "on; use deadline_steps")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not prompt:
            raise ValueError("prompt must be non-empty")
        self._prompts[rid] = list(prompt)
        # the chained full-page hashes ride the request, so admission can
        # probe the prefix index
        hashes = (self.kv.hashes_for(prompt)
                  if self.ecfg.prefix_cache else None)
        self.sched.submit(Request(
            rid=rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
            arrival=arrival, eos_id=eos_id, priority=priority,
            block_hashes=hashes,
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
        traces equal async-off.  A live fault injector turns the fast path
        off: the lookahead's allocations would shift its schedule."""
        self._ensure_captured()
        self.stats.steps += 1
        if self.ecfg.async_loop and self._pending is not None:
            la = (self.sched.lookahead_decode(self._pending[0])
                  if self.injector is None else None)
            if la is not None:
                return self._threaded_decode(la)
            self._apply_pending()
            self.sched.retire_finished()
        return self._sync_step()

    def _threaded_decode(self, la: DecodeBatch) -> list[Completion]:
        """Fast-path decode dispatch: step N+1 starts from step N's
        on-device ids before step N's results reach the host."""
        self._run_cow(la.cow)  # empty: lookahead write pages are exclusive
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
        if (isinstance(decision, PrefillChunk) and self.injector is not None
                and self.injector.poisoned(decision.seq.rid)):
            # fail at dispatch, before the step or its COW copies run (the
            # pairs all belong to this sequence, whose pages are freed)
            self.sched.fail(decision.seq, sch.REASON_POISONED)
            return self._drain_finished()
        self._run_cow(decision.cow)
        try:
            if isinstance(decision, PrefillChunk):
                self._prefill_chunk(decision)
            elif isinstance(decision, VerifyBatch):
                self._verify_batch(decision)
            else:
                assert isinstance(decision, DecodeBatch)
                if self._decode_batch(decision):
                    return self._drain_finished()
        except fl.TransientStepError:
            # retries exhausted before anything was copied: fail the
            # decision's requests and keep serving everyone else
            doomed = ([decision.seq] if isinstance(decision, PrefillChunk)
                      else list(decision.seqs))
            for seq in doomed:
                self.sched.fail(seq, sch.REASON_STEP_ERROR)
        self.sched.retire_finished()
        return self._drain_finished()

    def _prefill_chunk(self, decision: PrefillChunk) -> None:
        seq, start, length = decision.seq, decision.start, decision.length
        chunk = seq.prompt[start:start + length]
        chunk = chunk + [0] * (self.ecfg.prefill_chunk - length)
        pt = self.kv.page_table_array()[seq.slot:seq.slot + 1]
        ids, logits = self._prefill([chunk], pt, start, length, seq.slot,
                                    start == seq.resume_pos)
        self.sched.completed_prefill(decision)
        if not seq.prefilling:  # prompt done -> first token
            # the static output is overwritten by the next chunk
            first = self._whole(logits[0])
            self.first_logits[seq.rid] = first.clone()
            # mid-prompt chunks fetch nothing; the last one [1] int32,
            # or the logits row on the host-sample path
            if self.ecfg.device_sample:
                tok = int(self._fetch(self._to_host(ids))[0])
            else:
                tok = int(np.argmax(self._fetch(
                    self._to_host(first.float()))))
            self.sched.append_token(seq, tok)

    def _verify_batch(self, decision: VerifyBatch) -> None:
        bmax, lanes = self.ecfg.max_batch, self._verify_lanes
        token = np.zeros((bmax, lanes), np.int32)
        kvl = np.zeros((bmax,), np.int32)
        rlen = np.ones((bmax,), np.int32)
        active = np.zeros((bmax,), bool)
        for seq, drft in zip(decision.seqs, decision.drafts):
            token[seq.slot, 0] = seq.out_tokens[-1]
            token[seq.slot, 1:1 + len(drft)] = drft
            kvl[seq.slot] = seq.kv_len - 1  # context written
            rlen[seq.slot] = 1 + len(drft)
            active[seq.slot] = True
        ids, logits = self._verify(token, self.kv.page_table_array(), kvl,
                                   rlen, active)
        if self.ecfg.device_sample:
            argmax_all = self._fetch(self._to_host(ids))    # [B, K+1] int32
        else:
            argmax_all = np.argmax(self._fetch(self._to_host(
                self._whole(logits).float())), axis=-1)
        results = []
        for seq, drft in zip(decision.seqs, decision.drafts):
            # lane i's logits predict the token after lane i; lanes past
            # 1 + len(drft) are padding, never read
            argmax = [int(t) for t in argmax_all[seq.slot, :1 + len(drft)]]
            n_acc, emitted = draft_mod.accept_drafts(drft, argmax)
            eos = seq.req.eos_id
            if eos is not None and eos in emitted:
                # tokens after eos were never generated; if the cut drops
                # the bonus token, every emitted token is an accepted draft
                emitted = emitted[:emitted.index(eos) + 1]
                n_acc = min(n_acc, len(emitted))
            results.append((n_acc, emitted))
        # appends the tokens, counts acceptance, truncates the rejected
        # suffix's pages (the KV rollback)
        self.sched.completed_verify(decision, results)

    def _decode_batch(self, decision: DecodeBatch) -> bool:
        """Run one decode step; True when its apply is deferred (the
        overlapped loop)."""
        bmax = self.ecfg.max_batch
        token = np.zeros((bmax,), np.int32)
        kvl = np.zeros((bmax,), np.int32)
        active = np.zeros((bmax,), bool)
        for seq in decision.seqs:
            token[seq.slot] = seq.out_tokens[-1]
            kvl[seq.slot] = seq.kv_len - 1  # context written
            active[seq.slot] = True
        ids, logits = self._decode(token, self.kv.page_table_array(), kvl,
                                   active)
        if self.ecfg.async_loop:
            # defer the apply: the tokens land at the next step() /
            # cancel() boundary, overlapped with host scheduling
            self._pending = (decision, self._to_host(ids))
            return True
        if self.ecfg.device_sample:
            toks = self._fetch(self._to_host(ids))          # [B] int32
        else:
            toks = np.argmax(self._fetch(self._to_host(
                self._whole(logits).float())), axis=-1)
        for seq in decision.seqs:
            self.sched.append_token(seq, int(toks[seq.slot]))
        return False

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
        s.verify_steps = ss.verify_steps
        s.draft_tokens = ss.draft_tokens
        s.accepted_tokens = ss.accepted_tokens
        s.prefix_cache = self.ecfg.prefix_cache
        s.prefix_hit_tokens = ss.prefix_hit_tokens
        s.prefill_chunks_skipped = ss.prefill_chunks_skipped
        s.cached_page_evictions = self.kv.pool.cached_evictions
        s.cancelled, s.timeouts = ss.cancelled, ss.timeouts
        s.rejected, s.failed = ss.rejected, ss.failed
        s.quarantined = ss.quarantined
        s.admission_deferrals = ss.admission_deferrals
        s.p95_queue_wait_steps = ss.queue_wait_pct(95.0)
        s.completed_ok = sum(1 for c in self.completions.values() if c.ok)
        s.goodput_tokens = sum(len(c.tokens)
                               for c in self.completions.values() if c.ok)
        if self.injector is not None:
            s.faults_injected = self.injector.total_injected
        return dict(self.completions)
