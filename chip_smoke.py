#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

Phases (any failed check exits nonzero):
1. device and build: the card's name and power limit, then the five CUDA
   kernels built from ``src/repro_torch/csrc`` (one nvcc each, together),
   with ptxas' registers, shared memory and spills of every instance (B4
   and B5 must not spill) and, where cuobjdump exists, their tensor-core
   instructions (B3 must hold sparse IMMA.SP and no dense IMMA, B5 wgmma
   IGMMA and f16 HMMA);
2. B1, the compressed-matmul kernel, against its plain version at every
   h2o-danube-3-4b projection shape x R in {1, 4, prefill_chunk} x
   recipes int8, w4 (bit-equal) and fp8, none (bf16; tolerance below),
   kernel and bf16 ``torch.matmul`` timed in turns; R in {5, 16, 17}
   across the decode/prefill switch, and N = 2, 3 with ragged M and K;
2b. B3 (fused quant+lift+GEMM on the 2:4 sparse tensor cores, fed the
   2:4 operand of Phi(W)), B4 (quant+lift) and B5 (dense quantized GEMM)
   against their plain versions at the same shapes x R: B3 int8/w4, B4
   and B5 int8 bit-equal, fp8 within two bf16 ulps of max|plain|; the
   pipeline B4 -> B5 bit-equal to B3 for int8; B5 also at R 16/17/2048
   across its decode/prefill switch, beside ``torch._int_mm`` (cuBLASLt
   int8) at R >= 17, and its split-K calls (cluster-summed at prefill,
   reduce kernel at decode) launched twice, bit-identical; B3 at R
   5/16/17 across its switch, one split-K call launched twice, int8 and
   w4 weights with planted zeros (a lone non-zero at each window
   position); the same checks at N = 2, 3 with ragged shapes and f32
   inputs; B3 with bias + SiLU; the compute-bound row R = 2048 (B3, B5
   and ``torch._int_mm`` in turns, B5/B3); the launch floor, a one-block
   no-op read by the same timer, beside B4;
3. B2, the paged-attention kernel, against its split plain version at the
   kernel's own split count, at full width (H=32, KVH=8, hd=120, page
   16): decode B=4 up to ~1000 tokens, the verify step's 4 and 5 lanes
   at B=4 (each verify row bit-equal to a decode call at kv_len + lane,
   fp32 and bf16 queries), a 128-lane prefill chunk, and the split edges (rows of 1, 15, 16, 17 tokens beside one of ~4000), window
   off and 300, bf16 and int8 pools, fp32 queries and the main path's
   bf16 queries (tolerances below), each bf16 call launched twice and
   held bit-identical; kernel and SDPA timed in turns;
4. the engine: full 24-layer h2o-danube-3-4b, 6:8 compressed, int8
   recipe, bf16 activations and KV pages, fused paged attention, serving
   4 staggered requests, once eager and once with each step captured as
   a CUDA graph in ``warmup``; one prefill chunk and one decode step of
   each must dispatch under ``set_sync_debug_mode("error")`` (no host
   synchronization on the step path); the graphed engine must hold one
   capture per step (the COW step's too) and give the eager run's streams, first-token logits
   (bit for bit) and kernel launch counts; both kernels' counts must rise
   during ``run()``, every request must finish OK, the page accounting
   must balance, and each request's last-prefill logits must agree with
   the one-shot prefill on the same weights, within a fixed limit that
   two planted faults, read in the same run, must exceed (the "short"
   fault patched in before its engine captures);
5. the slided engine: the same model, weights and traffic in
   ``mode="slided"``, eager and graphed as above; B3's count must rise
   during ``run()`` and B1's stay at 0, and the streams and first-token
   logits must equal the compressed engine's bit for bit.  Then the
   overlapped loop (``async_loop``) on the same traffic: streams,
   scheduler trace and launch counts equal to the synchronous graphed
   run, with lookahead steps; a ``torch.profiler`` trace of decode steps,
   eager then graphed (host share, device idle share, top device
   operations); and eager, graphed and overlapped decode tok/s timed in
   turns;
6. the engine features, on phases 4 and 5's packed weights, graphed
   (page 16, batch 4, prefill chunk 128): the prefix cache in both modes
   (4 staggered requests behind a 250-token system prompt, a fifth that
   repeats one prompt and must copy-on-write a page the other holds, a
   sixth after all retired; streams equal to the cache-off engine, hits,
   COW copies); speculative decoding with ngram drafts on a repeated
   phrase, K = 3 in both modes and K = 4 compressed (streams equal to
   speculate=0, drafts accepted, B2's and the linear kernel's counts
   rising); fault injection (a step error rate, one poisoned request) on
   the synchronous and the overlapped loop (the poisoned request FAILED,
   survivors equal to phase 5's streams, retries taken, both loops
   ending alike); int8 KV pages (graphed == eager bit for bit, the
   logits gate with its planted faults).  Every engine holds one capture
   per step, the COW, resumed-prefill and verify dispatches pass the
   sync check, and every run's pages balance.  For the record: decode
   tok/s spec-off against spec-on and prefill seconds prefix-off against
   prefix-on in turns, acceptance and hit rates, graph nodes per step;
7. the float gate: the engine at recipe "none" with fp32 activations and
   KV pages (full width, depth cut to FLOAT_LAYERS), graphed, against
   one-shot ``generate``: identical streams, or each first divergence a
   tie within rounding (one-shot top-2 margin below max|engine -
   one-shot| of the logits there);
8. the model families (ROADMAP A.3): the kernel shapes they add held
   against the plain versions (B2 at head_dim 64 with 3 query heads per
   KV head, window off; B1 and B3 int8 bit-equal at N = 48, 128, 512,
   1536, 3072, 49155, 50280 and K = 1536, 3072), then granite-moe-3b-a800m
   (attention + MoE: B1 + B2 compressed, B3 + B2 slided) and mamba2-780m
   (Mamba-2 SSD: B1 or B3 alone, ``wo`` drawn at random), each at full
   width and depth, int8, bf16, fused attention, batch 4, page 16, chunk
   128, one seeded draw packed both ways: no host sync, one capture per
   step, graphed == eager and slided == compressed bit for bit; granite's
   last-prefill logits at its capacity factor each below both of that
   request's planted faults' readings (a chunk and a whole prompt drop
   different MoE slots), and at capacity factor E / k, where nothing is
   dropped, within LOGIT_RL2 and each below every planted fault's reading;
   mamba2's schedule with a decode step between two prefill chunks of
   one request; the overlapped loop (streams held to the synchronous
   loop for every request that never shared a decode step with lane
   garbage under MoE capacity, trace and launches whole); a profile of
   graphed decode steps, graph nodes per step and eager, graphed and
   overlapped decode tok/s in turns; the float gate on mamba2 at full
   depth (recipe none, fp32); and ``launch/serve_batched.py``'s granite
   engine demo (fp32 activations) with bf16 and with fp32 KV pages, each
   divergence from one-shot logged with the one-shot top-2 margin there
   and held to a tie within rounding, and every stream equal to one-shot
   with fp32 pages.
9. the audio and vision families (ROADMAP A.3): B1 and B3 int8
   bit-equal at whisper-small's and qwen2-vl-72b's projection shapes x R
   in {1, 4, prefill_chunk} and at R = 6000 (4 x 1500 audio frames) for
   whisper's K = 768 shapes, B1 and B3 with bias + GELU within phase
   2b's tolerance, B2 at 64 query heads over 8 KV heads of 128 (bf16 and
   int8 pools); whisper-small at full width and depth (12 + 12 layers),
   one seeded draw packed both ways, served one-shot through
   ``generate`` with seeded audio frames [4, 1500, 768]: slided ==
   compressed bit for bit, 121 kernel launches a decode step, the first
   decode step's logits against a full prefill over [tokens; next]
   beside two planted faults (the step's position one off, the last
   encoder frame dropped), the same at recipe none in fp32, a profiled
   decode step and the share of its cross-K/V projections;
   qwen2-vl-72b at full width, depth cut to QWEN_LAYERS, phase 8's
   engine gates (text only), phase 4's logits gate, one-shot
   ``generate`` with a vision prefix [4, 256, 8192] in 320-token prompts
   (slided == compressed, decode vs full prefill beside the prefix left
   out), and ``apply_mrope`` on the card (equal streams == RoPE bit for
   bit).  The phase prints its time.
10. single-device training (ROADMAP A.3), in two child processes, the
   card's memory then free of earlier phases: (a) three
   ``steps.train_step`` calls at h2o-danube-3-4b's smoke width, fp32,
   masked 6:8, on the card and on the CPU from the same params and
   batches (losses within rtol 1e-5, params within PARITY_RL2), beside
   a planted fault (the STE replaced by a plain prune) that must exceed
   that gate; (c) at full width, depth 2, after two steps every masked
   linear's effective weight 6:8 and its gradient non-zero at the pruned
   positions; (d) remat on (2 x 2 segments) vs off at full width, depth
   4, loss and gradients within the REMAT gates, peak memory of each;
   (e) int8 AdamW moments at full width, depth 2, 15 steps, the last
   three losses below the first three; (f) exact resume at smoke width
   (10 steps vs 6 and a resume to 10) and a bit-exact save -> restore of
   full-width params and AdamW state at depth 1, in a temporary
   directory; a profiled full-depth step (kernel time shares of the STE
   masks, AdamW and the matmuls); B1-B5 launch no time; then
   ``python -m repro_torch.launch.train`` at full width and depth,
   masked 6:8, bf16, TRAIN_STEPS steps of 8 x 256: exit 0, finite
   losses, the mean of the last five below the first five's by 0.1;
   median step ms, tokens/s and peak device memory.  The phase prints
   its time.
11. tensor parallelism (ROADMAP A.1): B1 and B3 int8 bit-equal at one
   rank's shard shapes at tp = 2, B3 given ``act_absmax`` (int8, w4; wo
   3840 x 1920 and w_down 3840 x 5120 at R 1, 4, 128) bit-equal to its
   plain version and, given the rows' own absmax, to B3 without it, B2
   at H = 16 over KVH = 4; then two gloo ranks sharing the card
   (``tp_rank``), each drawing phase 4's seeded weights once and keeping
   its shards, serve phase 5's traffic eager at tp = 2, compressed and
   slided: the ranks' streams identical and equal to phases 4 and 5's
   tp = 1 eager streams (or each divergence a tie within rounding at the
   tp = 1 logits), the last-prefill logits within TP_RL2 of tp = 1's
   beside two planted faults read in the same run on the compressed
   engine (one rank leaves one layer's w_down unreduced; one rank
   quantizes its row-parallel projections with its local absmax) that
   must exceed it, B1 or B3 (and
   B3's act_absmax instance, counted on its own) and B2 launched in
   ``run()``, each rank's linears half of tp = 1's, 4 KV heads a pool,
   the pages balanced; the launcher at TP_LAUNCH_LAYERS layers in fp32
   (``--tp 2 --dist-backend gloo`` streams == ``--tp 1``;
   ``--dist-backend nccl`` refused on one card); tp = 2 vs tp = 1 eager
   decode tok/s, the
   collectives per decode step and the phase's time;
12. multi-device training (ROADMAP A.3): the single device's side here
   (``train_loop.train`` of h2o-danube-3-4b at full width, MESH_LAYERS
   layers, masked 6:8, bf16, int8 AdamW moments, 8 x 256 tokens, three
   steps; the gradients of a batch with -1 labels); then four gloo ranks
   sharing the card (``mesh_rank``): (a) ``train(mesh=...)`` over (data
   2, model 2), the same three steps checkpointed (losses within
   MESH_LOSS_RTOL, params within MESH_PARAM_RL2), each rank's resident
   bytes of params + AdamW state against the logical total, seconds and
   collectives a step, and the sharded step's gradients on the -1 batch
   within MESH_GRAD_RL2 beside two planted faults that must exceed it
   (one rank skips the data-parallel gradient sum; the loss is the mean
   of the local means); (b) ``gpipe_apply`` over (stage 4), one danube
   block a stage at fp32, 4 microbatches of 2 x 256, output and every
   stage's gradients against the sequential run; (c)
   ``compressed_crosspod_mean`` of a [10240, 3840] leaf over (pod 2,
   data 2), bit-equal to the local recomputation, its int8 bytes on the
   wire; B1-B5 launch no time; then (d) two ranks restore (a)'s
   checkpoint onto ``elastic_mesh`` (data 1, model 2), through
   ``restore`` given the mesh and through ``elastic.reshard``, every
   leaf bit-equal to (a)'s final state; the phase's time;
13. the cost model, the autotuner and the dry run (ROADMAP A.2, A.4):
   the card's published peaks from ``repro_torch.kernels.roofline``
   (every bound of phases 2, 2b, 3 and 11 comes from it and equals the
   digit the old constants printed) beside ``measure_peaks()``; the
   autotuner, its cache in a temporary directory: B1 and B3 int8 tuned
   through ``kernels.ops`` at h2o-danube-3-4b's five linear shapes x R
   in TUNE_RS and B2 at phase 3's decode geometry, each winner's output
   bit-equal to the heuristic's and to the plain version (B2 within 2^-7
   of max|plain|), every entry's efficiency at most 1, winner and
   heuristic timed in turns, B2's verify rows at the tuned split
   bit-equal to decode calls, the cache file read back in a child
   process, a tune request inside a CUDA graph capture timing nothing; a
   slided engine captured on the tuned cache giving phase 5's streams
   (and with speculate=3, random drafts, too), one capture a step, its
   graphed decode tok/s in turns with one captured before tuning; the
   dry run in child processes (fake CUDA tensors): phase 10's
   configuration's peak within DRY_PEAK_RTOL of phase 10's measured
   ``max_memory_allocated``, phase 12's on a dry (data 2, model 2) mesh
   equal to phase 12's ranks' resident bytes, collectives and their
   bytes, rank for rank, and h2o-danube-3-4b train_4k on 16x16; the
   phase within PHASE13_S seconds;
14. the library API and the examples (ROADMAP A.1, A.2): (a)
   ``launch.quickstart.run`` on the card (w [512, 1024], x [64, 1024],
   seeded): B1's fp32 instance and B3 each launched (their counts rise),
   B3's output bit-equal to ``ref.slided_matmul_quant`` and B1's within
   QUICK_TOL of ``ref.compressed_matmul_fp``, max |compressed - dense|
   and max |slided - dense| within QUICK_TOL, the storage 1048576 ->
   884736 bytes, the int8 mean relative error within QUICK_INT8_REL, and
   ``python -m repro_torch.launch.quickstart`` exiting 0 as a child; (b)
   ``launch.sparsity_sweep.sweep`` at int8, its steps sized from a timed
   probe of one regime to about SWEEP_S seconds: every loss finite, each
   regime's last tenth below its first, its table beside JAX's CPU
   figures and Figure 2's ordering printed as a finding; (c) ``python -m
   repro_torch.launch.train_tiny_lm --int8-opt --sparse 6 8`` as a child
   to TINY_STEPS and rerun to twice that (resumed from its checkpoint,
   the loss falling), beside (b); the phase within PHASE14_S seconds;
15. a ``kernels`` JSON line (the five kernels, launches of the
   h2o-danube-3-4b runs, and B3's act_absmax instance with the launches
   of phase 11's slided run; phase 12's zero launches; phase 14's
   quickstart launches), the card line, and the final result line.

It imports neither JAX nor the JAX package, and prints every table it
measures on standard output.
"""
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PREFILL_CHUNK = 128
SHAPES = [(3840, 3840), (960, 3840), (10240, 3840), (3840, 10240),
          (32000, 3840)]
# linears per decode step of the 24-layer model: wq+wo, wk+wv, gate+up,
# down per layer, and the lm_head once
STEP_COUNTS = {(3840, 3840): 48, (960, 3840): 48, (10240, 3840): 48,
               (3840, 10240): 24, (32000, 3840): 1}
# ||engine - one-shot|| / ||one-shot|| of the last-prefill logits: a sound
# engine read at most 0.0663 on the H100, the planted faults at least 0.47
# per request (PERF.md); the limit sits between, 3x above the former
LOGIT_RL2 = 0.2
# whisper's decode step against a full prefill over [tokens; next],
# relative L2 of the logits.  int8: a sound step read 0.0186 on the H100,
# the step's position one off 0.0585, so the limit sits between; the last
# of 1500 encoder frames dropped moves the logits by 3.6e-4 (fp32), far
# inside int8's rounding, and is held by the fp32 gate only.  Recipe none
# in fp32: sound 8.7e-7, the faults 0.0545 and 3.6e-4; the limit sits
# near the geometric mean of the sound reading and the frame fault's
WHISPER_RL2, WHISPER_FLOAT_RL2 = 0.035, 2e-5
B2_TOL = 1e-4                  # fp32 queries: max abs error, outputs O(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, in ms, averaged over ``iters`` calls; the
    L2 cache is flushed before each call (the main path finds each weight
    cold), and the flush runs before the start event.  The device then
    spins ~0.2 ms, so the host has enqueued the call before its start
    event is reached and the reading holds no host time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def samples(self, fn, iters=10, warmup=2, clean=False):
        """The device time of each of ``iters`` calls, in ms.  The flush
        writes the buffer, so a call finds L2 full of dirty lines whose
        write-back competes with its reads; ``clean`` flushes by reading
        it instead."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(iters):
            if clean:
                self.flush.view(torch.int64).sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(400_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return out

    def __call__(self, fn, iters=10, warmup=2):
        return sum(self.samples(fn, iters, warmup)) / iters

    def rounds(self, fns, iters=10, clean=False):
        """Each function timed in turns in one call (in order, then in
        reverse), so drift of the card between them cancels; the median
        call time of each, in ms."""
        import statistics
        got = [self.samples(fn, iters, clean=clean) for fn in fns]
        for i in reversed(range(len(fns))):
            got[i] += self.samples(fns[i], iters, clean=clean)
        return [statistics.median(g) for g in got]

    def turns(self, kernel, library, iters=10):
        """Kernel and library in turns (kernel, library, library, kernel);
        the median call time of each, in ms."""
        return self.rounds([kernel, library], iters)


def _peaks(kind: str):
    """The card's published peaks for ``kind`` ('int8' or 'bf16') from
    ``repro_torch.kernels.roofline``."""
    from repro_torch.kernels import roofline
    return roofline.peaks({"int8": "int8", "bf16": "bfloat16"}[kind])


def bytes_s(nbytes: float) -> float:
    """Seconds ``nbytes`` take at the card's memory rate."""
    return nbytes / (_peaks("bf16").bw_gbps * 1e9)


def ops_s(ops: float, kind: str = "int8") -> float:
    """Seconds ``ops`` take at the card's peak for ``kind``."""
    return ops / (_peaks(kind).gflops * 1e9)


BOUNDS = {"checked": 0}


def bound(bytes_moved: float, ops: float, kind: str):
    """(ms, 'bytes' | 'operations'): ``roofline_us`` of this script's own
    byte and operation counts at ``roofline.peaks(kind)``.  Each bound is
    held to the digit it printed before the module, when this script
    divided by its own constants: 3.35e12 B/s and the dense tensor-core
    peaks 1979e12 (int8) and 989e12 (bf16) a second."""
    from repro_torch.kernels import roofline
    cost, p = roofline.Cost(bytes_moved, ops), _peaks(kind)
    ms, by = roofline.roofline_us(cost, p) / 1e3, roofline.bound_by(cost, p)
    t_b, t_o = bytes_moved / 3.35e12, ops / {"int8": 1979e12,
                                             "bf16": 989e12}[kind]
    assert f"{ms:.4f}" == f"{max(t_b, t_o) * 1e3:.4f}", (ms, t_b, t_o)
    assert by == ("bytes" if t_b >= t_o else "operations"), (by, t_b, t_o)
    BOUNDS["checked"] += 1
    return ms, by


# ----------------------------------------------------------------- phase 2
def phase_b1(torch, timer):
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided, \
        decompress_original
    from repro_torch.kernels import ref, slide_matmul as smm

    log("== B1 compressed_matmul vs plain (bf16 out; int8/w4 bit-equal; "
        "fp8/none within 2 bf16 ulps of max|plain|) ==")
    log("recipe M K R | kernel_ms plain_ms library_ms bound_ms bound_by "
        "| max_abs_err")
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_s": 0.0, "ops_s": 0.0}
    for recipe in ("int8", "w4", "fp8", "none"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode="compressed",
                                recipe=recipe)
        rec = cfg.recipe
        for m, k in SHAPES:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            c = CompressedSlided(p["values"], p["indices"], k, 6, 8, 2, 4,
                                 packed=rec.packed_weights)
            w_dense = decompress_original(c).to(torch.bfloat16)
            if rec.quantized:
                w_dense = (w_dense.float() * p["s_w"]).to(torch.bfloat16)
            for r in (1, 4, PREFILL_CHUNK):
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                if rec.quantized:
                    qx = rec.quantize_act(x)
                    args = (qx.q, c.values, c.indices, qx.scale, p["s_w"])

                    def kern():
                        return smm.compressed_matmul_cuda(
                            *args, n_fam=4, packed=c.packed,
                            out_dtype=torch.bfloat16)

                    def plain():
                        return ref.compressed_matmul_dequant(
                            qx.q, qx.scale, c, p["s_w"], torch.bfloat16)
                    x_bytes = r * k * qx.q.element_size() + 4 * r
                else:
                    def kern():
                        return smm.compressed_matmul_cuda(
                            x, c.values, c.indices, None, None, n_fam=4,
                            out_dtype=torch.bfloat16)

                    def plain():
                        return ref.compressed_matmul_fp(x, c, torch.bfloat16)
                    x_bytes = r * k * 2

                def library():
                    return torch.matmul(x, w_dense.T)

                n0 = smm.launch_count()
                y, y_ref = kern(), plain()
                torch.cuda.synchronize()
                assert smm.launch_count() == n0 + 1
                err = (y.float() - y_ref.float()).abs().max().item()
                scale = y_ref.float().abs().max().item()
                if recipe in ("int8", "w4"):
                    assert torch.equal(y, y_ref), \
                        f"B1 {recipe} {m}x{k} R={r}: not bit-equal ({err})"
                else:
                    assert err <= 2 ** -7 * scale, \
                        f"B1 {recipe} {m}x{k} R={r}: err {err} > 2^-7*{scale}"
                max_err = max(max_err, err)
                t_k, t_l = timer.turns(kern, library)
                t_p = timer(plain, iters=3, warmup=1)
                w_bytes = (c.values.numel() * c.values.element_size()
                           + c.indices.numel()
                           + (4 * m if rec.quantized else 0))
                nbytes = w_bytes + x_bytes + r * m * 2
                ops = 2 * r * m * k * 0.75  # the 6:8 non-zero budget
                kind = "int8" if rec.quantized else "bf16"
                b_ms, b_by = bound(nbytes, ops, kind)
                log(f"{recipe} {m} {k} {r} | {t_k:.4f} {t_p:.4f} {t_l:.4f} "
                    f"{b_ms:.4f} {b_by} | {err:.3g}")
                if recipe == "int8" and r == 4:
                    n = STEP_COUNTS[(m, k)]
                    step["ms"] += n * t_k
                    step["plain_ms"] += n * t_p
                    step["library_ms"] += n * t_l
                    step["bytes_s"] += n * bytes_s(nbytes)
                    step["ops_s"] += n * ops_s(ops)
            del w, p, c, w_dense
    torch.cuda.empty_cache()

    # both sides of the decode/prefill switch (R <= DECODE_MAX_R) on one
    # shape, and the other families with ragged M and K (K = 120: position
    # rows not 16-byte multiples, so the byte-wise paths run; M not a
    # multiple of the 4- or 64-row blocks), R across both instances
    cases = 0
    for z, l, shapes, rs in (
            (6, 8, [(3840, 3840)], (5, 16, 17)),
            (2, 4, [(37, 120), (100, 48), (960, 3840)], (1, 5, 17, 40)),
            (4, 6, [(37, 120), (100, 48), (960, 3840)], (1, 5, 17, 40))):
        for recipe in ("int8", "w4", "fp8"):
            cfg = sl.SparsityConfig(pattern=(z, l), mode="compressed",
                                    recipe=recipe)
            rec = cfg.recipe
            for m, k in shapes:
                w = torch.randn((m, k), generator=gen, device="cuda")
                p = sl.prepare({"w": w}, cfg)
                c = CompressedSlided(p["values"], p["indices"], k, z, l, 2, 4,
                                     packed=rec.packed_weights)
                for r in rs:
                    x = torch.randn((r, k), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    qx = rec.quantize_act(x)
                    y = smm.compressed_matmul_cuda(
                        qx.q, c.values, c.indices, qx.scale, p["s_w"],
                        n_fam=l // 2, packed=c.packed,
                        out_dtype=torch.bfloat16)
                    y_ref = ref.compressed_matmul_dequant(
                        qx.q, qx.scale, c, p["s_w"], torch.bfloat16)
                    err = (y.float() - y_ref.float()).abs().max().item()
                    if recipe in ("int8", "w4"):
                        assert torch.equal(y, y_ref), \
                            f"B1 {z}:{l} {recipe} {m}x{k} R={r}: not " \
                            f"bit-equal ({err})"
                    else:
                        scale = y_ref.float().abs().max().item()
                        assert err <= 2 ** -7 * scale, \
                            f"B1 {z}:{l} {recipe} {m}x{k} R={r}: err {err}"
                    max_err = max(max_err, err)
                    cases += 1
    log(f"B1 R across the decode/prefill switch (R <= "
        f"{smm.DECODE_MAX_R} decodes) and N = 2, 3 with ragged M, K: "
        f"{cases} cases held")
    step["bound_ms"] = max(step["bytes_s"], step["ops_s"]) * 1e3
    step["bound_by"] = ("bytes" if step["bytes_s"] >= step["ops_s"]
                        else "operations")
    log(f"B1 per decode step (int8, R=4, 169 linears): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']})")
    return max_err, step


# ---------------------------------------------------------------- phase 2b
def phase_slided_kernels(torch, timer):
    """B3 (fused quant+lift+GEMM), B4 (quant+lift) and B5 (dense quantized
    GEMM) against their plain versions at every projection shape x R."""
    from repro_torch.core import linear as sl, packer
    from repro_torch.kernels import fused_quant_slide as fqs, \
        fused_slide_matmul as fsm, quant_matmul as qmm, ref

    log("== B3 fused_slided_matmul / B4 fused_quant_slide / B5 quant_matmul "
        "vs plain (int8, w4 and B4 bit-equal; fp8 within 2 bf16 ulps of "
        "max|plain|; B4->B5 bit-equal to B3 for int8) ==")
    log("kernel recipe M K R | kernel_ms plain_ms library_ms bound_ms "
        "bound_by | max_abs_err")
    gen = torch.Generator(device="cuda").manual_seed(3)
    names = ("B3", "B4", "B5")
    int_mm_rows = []
    err = dict.fromkeys(names, 0.0)
    step = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bytes_s": 0.0, "ops_s": 0.0, "dense_bytes_s": 0.0}
            for n in names}

    def check(name, recipe, m, k, r, y, y_ref):
        e = (y.float() - y_ref.float()).abs().max().item()
        if name == "B4" or recipe in ("int8", "w4"):
            assert torch.equal(y.view(torch.uint8) if y.dtype ==
                               torch.float8_e4m3fn else y,
                               y_ref.view(torch.uint8) if y_ref.dtype ==
                               torch.float8_e4m3fn else y_ref), \
                f"{name} {recipe} {m}x{k} R={r}: not bit-equal ({e})"
        else:
            scale = y_ref.float().abs().max().item()
            assert e <= 2 ** -7 * scale, \
                f"{name} {recipe} {m}x{k} R={r}: err {e} > 2^-7*{scale}"
        err[name] = max(err[name], e)

    def measure(name, recipe, m, k, r, kern, plain, library, nbytes, ops,
                dense_bytes=None, int_mm=None):
        if library is not None:
            t_k, t_l = timer.turns(kern, library)
        else:
            t_k, t_l = timer(kern), None
        t_p = timer(plain, iters=3, warmup=1)
        b_ms, b_by = bound(nbytes, ops, "int8")
        lib = f"{t_l:.4f}" if t_l is not None else "null"
        if name == "B5" and recipe == "int8" and r == 4:
            # the same calls after a flush that leaves L2 clean
            t_kc, t_lc = timer.rounds([kern, library], clean=True)
            lib += f" (clean L2: kernel {t_kc:.4f}, library {t_lc:.4f})"
        if int_mm is not None:
            # the paper's dense baseline: cuBLASLt int8 on the same operands
            t_k2, t_i = timer.turns(kern, int_mm)
            lib += f" (kernel {t_k2:.4f} vs torch._int_mm {t_i:.4f})"
            int_mm_rows.append((m, k, r, t_k2, t_i))
        # B3: the bound over the dense slided matrix, as it was read before
        # the 2:4 operand, for continuity
        old = (f" (dense slided {bound(dense_bytes, ops, 'int8')[0]:.4f})"
               if dense_bytes is not None else "")
        log(f"{name} {recipe} {m} {k} {r} | {t_k:.4f} {t_p:.4f} {lib} "
            f"{b_ms:.4f}{old} {b_by} | {err[name]:.3g}")
        if recipe == "int8" and r == 4:
            n = STEP_COUNTS[(m, k)]
            st = step[name]
            st["ms"] += n * t_k
            st["plain_ms"] += n * t_p
            st["library_ms"] = (None if t_l is None
                                else st["library_ms"] + n * t_l)
            st["bytes_s"] += n * bytes_s(nbytes)
            st["ops_s"] += n * ops_s(ops)
            st["dense_bytes_s"] += n * bytes_s(dense_bytes or 0)

    def operand_bytes(p):
        return (p["sp_values"].numel() + 4 * p["sp_meta"].numel()
                + 4 * p["s_w"].numel())

    for recipe in ("int8", "w4", "fp8", "fp8w4"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode="slided", recipe=recipe)
        rec, dec = cfg.recipe, cfg.decomposition()
        fp8 = rec.act == "fp8"
        for m, k in SHAPES:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            sv, sm, s_w = p["sp_values"], p["sp_meta"], p["s_w"]
            gk = fsm.lifted_width(k, 4)
            # Phi(W) itself: B5's operand in the B4 -> B5 pipeline
            ws = fsm.dense_from_operand(sv, sm, m, gk,
                                        packed=rec.packed_weights)
            w_bytes = operand_bytes(p)
            dense_w = m * gk // (2 if rec.packed_weights else 1) + 4 * m
            # the dense K-wide operands: B5's weights and the yardstick's
            qw = rec.quantize_weight(packer.prune_to_pattern(w, dec.source))
            w_dense = (qw.q.float() * qw.scale).to(torch.bfloat16)
            del w, p
            for r in (1, 4, PREFILL_CHUNK):
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)

                def b3():
                    return fsm.fused_slided_matmul_cuda(
                        x, sv, sm, s_w, n_fam=4, act=rec.act,
                        packed=rec.packed_weights, out_dtype=torch.bfloat16)

                def b3_plain():
                    return ref.slided_matmul_sparse(x, sv, sm, s_w, dec, rec,
                                                    torch.bfloat16)

                def library():
                    return torch.matmul(x, w_dense.T)

                n0 = fsm.launch_count()
                y = b3()
                torch.cuda.synchronize()
                assert fsm.launch_count() == n0 + 1
                check("B3", recipe, m, k, r, y, b3_plain())
                measure("B3", recipe, m, k, r, b3, b3_plain, library,
                        w_bytes + r * k * 2 + r * m * 2,
                        2 * r * m * k * 0.75,
                        dense_w + r * k * 2 + r * m * 2)
                if rec.packed_weights:
                    continue
                q, s_x = fqs.fused_quant_slide_cuda(x, n_fam=4, fp8=fp8)
                q_ref, s_ref = ref.fused_quant_slide(x, dec, fp8=fp8)
                check("B4", recipe, m, k, r, q, q_ref)
                check("B4", recipe, m, k, r, s_x, s_ref)
                if recipe == "int8":
                    # the two-kernel pipeline sums the same integers
                    y2 = qmm.quant_matmul_cuda(q, s_x, ws, s_w,
                                               out_dtype=torch.bfloat16)
                    assert torch.equal(y2, y), \
                        f"B4->B5 != B3 at {m}x{k} R={r}"
                measure("B4", recipe, m, k, r,
                        lambda: fqs.fused_quant_slide_cuda(x, n_fam=4,
                                                           fp8=fp8),
                        lambda: ref.fused_quant_slide(x, dec, fp8=fp8), None,
                        r * k * 2 + r * gk + 4 * r, 0)
                qx = rec.quantize_act(x)

                def b5():
                    return qmm.quant_matmul_cuda(qx.q, qx.scale, qw.q,
                                                 qw.scale,
                                                 out_dtype=torch.bfloat16)

                def b5_plain():
                    return ref.quant_matmul(qx.q, qx.scale, qw.q, qw.scale,
                                            torch.bfloat16)
                check("B5", recipe, m, k, r, b5(), b5_plain())
                measure("B5", recipe, m, k, r, b5, b5_plain, library,
                        r * k + 4 * r + m * k + 4 * m + r * m * 2,
                        2 * r * m * k,
                        int_mm=(lambda: torch._int_mm(qx.q, qw.q.t()))
                        if recipe == "int8" and r > 16 else None)
            if not rec.packed_weights:
                # B5 across its decode/prefill switch (R <= DECODE_MAX_R)
                # and at a long prefill, every shape
                for r in (16, 17, 2048):
                    qx = rec.quantize_act(torch.randn(
                        (r, k), generator=gen, device="cuda"))
                    check("B5", recipe, m, k, r,
                          qmm.quant_matmul_cuda(qx.q, qx.scale, qw.q,
                                                qw.scale,
                                                out_dtype=torch.bfloat16),
                          ref.quant_matmul(qx.q, qx.scale, qw.q, qw.scale,
                                           torch.bfloat16))
            if recipe == "int8" and (m, k) == (3840, 3840):
                # one split-K decode call launched twice: bit-identical
                x = torch.randn((4, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                splits = fsm.splits_for(4, m, gk)
                assert splits > 1, f"B3 decode runs one split ({splits})"
                y1, y2 = b3(), b3()
                assert torch.equal(y1, y2), "B3 split-K: two launches differ"
                log(f"B3 split-K decode {m}x{k} R=4: {splits} splits, two "
                    "launches bit-identical")
                # B5's split-K: summed in a cluster at prefill, by a
                # second kernel at decode (x too long for shared memory)
                for r, (mm, kk) in ((PREFILL_CHUNK, (m, k)),
                                    (16, (m, 10240))):
                    qx = rec.quantize_act(torch.randn(
                        (r, kk), generator=gen, device="cuda"))
                    qw5 = rec.quantize_weight(torch.randn(
                        (mm, kk), generator=gen, device="cuda"))
                    splits = qmm.splits_for(r, mm, kk)
                    assert splits > 1, f"B5 {mm}x{kk} R={r}: one split"
                    y1, y2 = (qmm.quant_matmul_cuda(
                        qx.q, qx.scale, qw5.q, qw5.scale,
                        out_dtype=torch.bfloat16) for _ in range(2))
                    assert torch.equal(y1, y2), \
                        f"B5 split-K {mm}x{kk} R={r}: two launches differ"
                    check("B5", recipe, mm, kk, r, y1, ref.quant_matmul(
                        qx.q, qx.scale, qw5.q, qw5.scale, torch.bfloat16))
                    log(f"B5 split-K {mm}x{kk} R={r}: {splits} splits, two "
                        "launches bit-identical")
            # R across the decode/prefill switch (R <= DECODE_MAX_R)
            if (m, k) == (3840, 3840):
                for r in (5, 16, 17):
                    x = torch.randn((r, k), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    check("B3", recipe, m, k, r, b3(), b3_plain())
            del sv, sm, ws, s_w, qw, w_dense
        torch.cuda.empty_cache()

    # planted zeros: every window of the model's shape holds one non-zero
    # at position 0, 1, 2 or 3 (JAX's slot order would give the pair
    # (p, 0)), or two, or none; int8 and w4 bit-equal at R 1 / 4 / 128
    for recipe in ("int8", "w4"):
        rec = sl.SparsityConfig(pattern=(6, 8), mode="slided",
                                recipe=recipe).recipe
        m, gk = 3840, fsm.lifted_width(3840, 4)
        hi = 8 if rec.packed_weights else 128
        vals = torch.randint(1, hi, (m, gk // 4, 4), generator=gen,
                             device="cuda", dtype=torch.int8)
        vals = torch.where(torch.rand((m, gk // 4, 4), generator=gen,
                                      device="cuda") < 0.5, vals, -vals)
        kind = torch.randint(0, 7, (m, gk // 4, 1), generator=gen,
                             device="cuda")
        pos = torch.arange(4, device="cuda")
        keep = (pos == kind) | ((kind == 4) & (pos % 2 == 0)) | (
            (kind == 5) & (pos >= 2))
        ws = torch.where(keep, vals, torch.zeros((), dtype=torch.int8,
                                                 device="cuda"))
        ws = ws.reshape(m, gk)
        src = packer.pack_nibbles(ws) if rec.packed_weights else ws
        sv, sm = fsm.sparse_operand(src, packed=rec.packed_weights)
        assert torch.equal(fsm.dense_from_operand(
            sv, sm, m, gk, packed=rec.packed_weights), src)
        s_w = torch.rand((m, 1), generator=gen, device="cuda") * 1e-3
        for r in (1, 4, PREFILL_CHUNK):
            x = torch.randn((r, 3840), generator=gen,
                            device="cuda").to(torch.bfloat16)
            y = fsm.fused_slided_matmul_cuda(x, sv, sm, s_w, n_fam=4,
                                             packed=rec.packed_weights,
                                             out_dtype=torch.bfloat16)
            check("B3", recipe, m, 3840, r, y,
                  ref.slided_matmul_sparse(x, sv, sm, s_w,
                                           sl.SparsityConfig(
                                               pattern=(6, 8)).decomposition(),
                                           rec, torch.bfloat16))
        del sv, sm, ws, src
    log("B3 planted zeros (one non-zero at each window position) int8/w4 "
        "at 3840x3840, R 1/4/128: bit-equal")

    # the other families and ragged edges: N = 2, 3 (gamma*K not a
    # multiple of 16 at K = 120, so the byte-wise tails run), M not a
    # multiple of the tiles, R across both tilings, f32 and bf16 inputs
    cases = 0
    for z, l in ((2, 4), (4, 6)):
        for recipe in ("int8", "w4", "fp8"):
            cfg = sl.SparsityConfig(pattern=(z, l), mode="slided",
                                    recipe=recipe)
            rec, dec = cfg.recipe, cfg.decomposition()
            for m, k in ((37, 120), (100, 48), (960, 3840)):
                w = torch.randn((m, k), generator=gen, device="cuda")
                p = sl.prepare({"w": w}, cfg)
                ws = fsm.dense_from_operand(p["sp_values"], p["sp_meta"], m,
                                            fsm.lifted_width(k, l // 2),
                                            packed=rec.packed_weights)
                for r in (1, 5, 17, 40):
                    for dt in (torch.float32, torch.bfloat16):
                        x = torch.randn((r, k), generator=gen,
                                        device="cuda").to(dt)
                        y = fsm.fused_slided_matmul_cuda(
                            x, p["sp_values"], p["sp_meta"], p["s_w"],
                            n_fam=l // 2, act=rec.act,
                            packed=rec.packed_weights,
                            out_dtype=torch.bfloat16)
                        check("B3", recipe, m, k, r, y,
                              ref.slided_matmul_sparse(
                                  x, p["sp_values"], p["sp_meta"], p["s_w"],
                                  dec, rec, torch.bfloat16))
                        cases += 1
                        if rec.packed_weights:
                            continue
                        fp8 = rec.act == "fp8"
                        q, s_x = fqs.fused_quant_slide_cuda(x, n_fam=l // 2,
                                                            fp8=fp8)
                        q_ref, s_ref = ref.fused_quant_slide(x, dec, fp8=fp8)
                        check("B4", recipe, m, k, r, q, q_ref)
                        check("B4", recipe, m, k, r, s_x, s_ref)
                        y5 = qmm.quant_matmul_cuda(q, s_x, ws, p["s_w"],
                                                   out_dtype=torch.bfloat16)
                        check("B5", recipe, m, k, r, y5, ref.quant_matmul(
                            q, s_x, ws, p["s_w"], torch.bfloat16))
                        if recipe == "int8":
                            assert torch.equal(y5, y), \
                                f"B4->B5 != B3 at {z}:{l} {m}x{k} R={r}"
    log(f"N = 2, 3 and ragged shapes: {cases} B3/B4/B5 cases held (w4: B3 "
        "only)")

    # the epilogue: bias + SiLU at one shape, against the plain version
    cfg = sl.SparsityConfig(pattern=(6, 8), mode="slided", recipe="int8")
    m, k = 10240, 3840
    w = (torch.randn((m, k), generator=gen, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    p = sl.prepare({"w": w}, cfg)
    bias = torch.randn((m,), generator=gen, device="cuda")
    x = torch.randn((4, k), generator=gen, device="cuda").to(torch.bfloat16)
    y = fsm.fused_slided_matmul_cuda(x, p["sp_values"], p["sp_meta"],
                                     p["s_w"], bias, n_fam=4,
                                     out_dtype=torch.bfloat16,
                                     activation="silu")
    y_ref = ref.slided_matmul_sparse(x, p["sp_values"], p["sp_meta"],
                                     p["s_w"], cfg.decomposition(), "int8",
                                     torch.bfloat16, bias=bias,
                                     activation="silu")
    check("B3", "int8+bias+silu", m, k, 4, y, y_ref)
    log(f"B3 int8 + bias + SiLU {m}x{k} R=4: max abs err "
        f"{(y.float() - y_ref.float()).abs().max().item():.3g}")
    del w, p
    torch.cuda.empty_cache()

    # the compute-bound row: a long prefill, R = 2048 (int8).  B3, B5 and
    # cuBLASLt's int8 GEMM in turns; B5 / B3 is the ratio the paper's
    # 4/3 speaks of (dense time over sparse time is 1.33 there)
    cfg = sl.SparsityConfig(pattern=(6, 8), mode="slided", recipe="int8")
    rec, dec = cfg.recipe, cfg.decomposition()
    r = 2048
    log(f"== compute-bound row, R = {r}, int8: B3 / B5 / torch._int_mm ms "
        "in turns, bound ms, B5 / B3 ==")
    for m, k in ((3840, 3840), (10240, 3840)):
        w = (torch.randn((m, k), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        p = sl.prepare({"w": w}, cfg)
        qw = rec.quantize_weight(packer.prune_to_pattern(w, dec.source))
        x = torch.randn((r, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        qx = rec.quantize_act(x)

        def b3():
            return fsm.fused_slided_matmul_cuda(
                x, p["sp_values"], p["sp_meta"], p["s_w"], n_fam=4,
                out_dtype=torch.bfloat16)

        def b5():
            return qmm.quant_matmul_cuda(qx.q, qx.scale, qw.q, qw.scale,
                                         out_dtype=torch.bfloat16)
        check("B3", "int8", m, k, r, b3(), ref.slided_matmul_sparse(
            x, p["sp_values"], p["sp_meta"], p["s_w"], dec, rec,
            torch.bfloat16))
        check("B5", "int8", m, k, r, b5(), ref.quant_matmul(
            qx.q, qx.scale, qw.q, qw.scale, torch.bfloat16))
        t3, t5, ti = timer.rounds(
            [b3, b5, lambda: torch._int_mm(qx.q, qw.q.t())])
        ops = 2 * r * m * k
        b3_ms = bound(operand_bytes(p) + r * k * 2 + r * m * 2, ops * 0.75,
                      "int8")[0]
        b5_ms = bound(r * k + 4 * r + m * k + 4 * m + r * m * 2, ops,
                      "int8")[0]
        log(f"R={r} {m}x{k}: B3 {t3:.4f} (bound {b3_ms:.4f}) B5 {t5:.4f} "
            f"(bound {b5_ms:.4f}) torch._int_mm {ti:.4f} ms; B5/B3 "
            f"{t5 / t3:.3f}, B5/_int_mm {t5 / ti:.3f}")
        int_mm_rows.append((m, k, r, t5, ti))
        del w, p, qw
    torch.cuda.empty_cache()

    # B4's floor: the same timer around a one-block launch that does
    # nothing, the least a decode-sized call can read
    floor = timer(fqs.noop_cuda)
    step["B4"]["floor_ms"] = floor
    log(f"launch floor (one-block no-op, same timer): {floor:.4f} ms a call, "
        f"{169 * floor:.3f} ms for 169 calls")
    for m, k, r, t5, ti in int_mm_rows:
        log(f"B5 vs torch._int_mm {m}x{k} R={r}: {t5:.4f} / {ti:.4f} ms "
            f"({t5 / ti:.3f})")

    for name, what in (("B3", "169 slided linears"),
                       ("B4", "169 quant+lift calls"),
                       ("B5", "169 dense int8 linears")):
        st = step[name]
        st["bound_ms"] = max(st["bytes_s"], st["ops_s"]) * 1e3
        st["bound_by"] = ("bytes" if st["bytes_s"] >= st["ops_s"]
                          else "operations")
        lib = (f"{st['library_ms']:.3f} ms" if st["library_ms"] is not None
               else "null")
        old = (f"; bound over the dense slided matrix "
               f"{max(st['dense_bytes_s'], st['ops_s']) * 1e3:.3f} ms"
               if name == "B3" else
               f"; launch floor {169 * st['floor_ms']:.3f} ms"
               if name == "B4" else "")
        log(f"{name} per decode step (int8, R=4, {what}): kernel "
            f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms, library "
            f"{lib}, bound {st['bound_ms']:.3f} ms ({st['bound_by']}){old}")
    return err, step


# ----------------------------------------------------------------- phase 3
def phase_b2(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import ref, paged_attention as pa

    log(f"== B2 paged_attention vs its split plain version at the kernel's "
        f"own split count S (fp32 q: max abs err <= {B2_TOL}; bf16 q, the "
        "main path's instance: within 2^-7 of max|plain|; bf16 q twice: "
        "bit-identical) ==")
    log("case pool window S | kernel_ms plain_ms library_ms bound_ms "
        "bound_by | max_abs_err fp32 bf16")
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kvh, hd, ps, num_pages = 32, 8, 120, 16, 320
    max_err, main = 0.0, None
    # decode at the main path's batch, a 128-lane prefill chunk, and the
    # split edges: rows of 1, 15, 16 and 17 tokens (one page and its
    # edges) beside one of ~4000, whose table leaves the short rows' splits
    # past their tails unallocated; window 300 leaves whole splits of the
    # long row below every query's window
    # and the verify step's geometry, K + 1 = 4 and 5 lanes at the main
    # path's batch, whose rows must give a decode call's bits
    cases = [("decode", [1000, 517, 77, 260], 1, True),
             ("verify3", [1000, 517, 77, 260], 4, True),
             ("verify4", [1000, 517, 77, 260], 5, True),
             ("prefill", [257], PREFILL_CHUNK, True),
             ("edges", [1, 15, 16, 17, 3999], 1, False)]
    verify = {}
    for name, kv_len, lanes, timed in cases:
        b = len(kv_len)
        maxp = -(-(max(kv_len) + lanes - 1) // ps) + 2
        splits = pa.splits_for(b, kvh, maxp, ps, lanes, h // kvh)
        if name.startswith("verify"):
            assert splits == pa.splits_for(b, kvh, maxp, ps, 1, h // kvh), \
                f"B2 {name} splits differently from decode"
        if name == "decode":
            assert splits > 1, f"B2 decode runs one split ({splits})"
            log(f"B2 decode grid: B x KVH x S = {b} x {kvh} x {splits} "
                "attend blocks, then the merge")
        perm = torch.randperm(num_pages - 1, generator=gen,
                              device="cuda") + 1
        table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
        used = 0
        for i, n_tok in enumerate(kv_len):
            n = -(-(n_tok + lanes - 1) // ps)
            table[i, :n] = perm[used:used + n].to(torch.int32)
            used += n
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        for pool_kind in ("bf16", "int8"):
            shape = (num_pages, ps, kvh, hd)
            if pool_kind == "bf16":
                pool = {n_: torch.randn(shape, generator=gen,
                                        device="cuda").to(torch.bfloat16)
                        for n_ in ("k", "v")}
            else:
                pool = {n_: torch.randint(-127, 128, shape, generator=gen,
                                          device="cuda", dtype=torch.int8)
                        for n_ in ("k", "v")}
                for n_ in ("k_scale", "v_scale"):
                    pool[n_] = torch.rand((num_pages, ps, kvh, 1),
                                          generator=gen,
                                          device="cuda") * 0.02 + 1e-3
            for window in (None, 300):
                q = torch.randn((b, lanes, h, hd), generator=gen,
                                device="cuda")
                qb = q.to(torch.bfloat16)  # the main path's instance
                # a prefill chunk takes the tensor-core instance, every
                # other call the decode rows' instance (row_exact)
                exact = name != "prefill"
                y = pa.paged_attention_cuda(q, pool, table, kvl, window)
                y_ref = ref.flash_paged_split(q, pool, table, kvl, window,
                                              splits)
                yb = pa.paged_attention_cuda(qb, pool, table, kvl, window,
                                             exact)
                yb2 = pa.paged_attention_cuda(qb, pool, table, kvl, window,
                                              exact)
                yb_ref = ref.flash_paged_split(qb, pool, table, kvl, window,
                                               splits)
                if name.startswith("verify"):
                    # row i of the verify call == a decode call at kv_len+i
                    for lane in range(lanes):
                        for qq, yy in ((q, y), (qb, yb)):
                            one = pa.paged_attention_cuda(
                                qq[:, lane:lane + 1].contiguous(), pool,
                                table, kvl + lane, window)
                            assert torch.equal(one[:, 0], yy[:, lane]), \
                                f"B2 {name} {pool_kind} {window} lane " \
                                f"{lane} ({qq.dtype}) differs from decode"
                torch.cuda.synchronize()
                err32 = (y - y_ref).abs().max().item()
                assert err32 <= B2_TOL, \
                    f"B2 {name} {pool_kind} {window} fp32: {err32}"
                err = (yb.float() - yb_ref.float()).abs().max().item()
                scale = yb_ref.float().abs().max().item()
                assert err <= 2 ** -7 * scale, \
                    f"B2 {name} {pool_kind} {window} bf16: {err} > " \
                    f"2^-7*{scale}"
                assert torch.equal(yb, yb2), \
                    f"B2 {name} {pool_kind} {window}: two launches differ"
                max_err = max(max_err, err32, err)
                if not timed:
                    log(f"{name} {pool_kind} {window} {splits} | - | "
                        f"{err32:.3g} {err:.3g}")
                    continue
                # yardstick: SDPA over K/V gathered beforehand (bf16)
                kg = pool["k"][table.long()].reshape(b, -1, kvh, hd)
                vg = pool["v"][table.long()].reshape(b, -1, kvh, hd)
                if pool_kind == "int8":
                    kg = kg.float() * pool["k_scale"][table.long()].reshape(
                        b, -1, kvh, 1)
                    vg = vg.float() * pool["v_scale"][table.long()].reshape(
                        b, -1, kvh, 1)
                kg = kg.to(torch.bfloat16).transpose(1, 2).contiguous()
                vg = vg.to(torch.bfloat16).transpose(1, 2).contiguous()
                pos = torch.arange(kg.shape[2], device="cuda")
                row_len = kvl[:, None] + torch.arange(lanes, device="cuda")
                mask = pos[None, None, :] < row_len[:, :, None]
                if window is not None:
                    mask &= pos[None, None, :] >= row_len[:, :, None] - window
                mask = mask[:, None]
                qt = qb.transpose(1, 2)
                t_k, t_l = timer.turns(
                    lambda: pa.paged_attention_cuda(qb, pool, table, kvl,
                                                    window, exact),
                    lambda: F.scaled_dot_product_attention(
                        qt, kg, vg, attn_mask=mask, enable_gqa=True))
                t_p = timer(lambda: ref.flash_paged_split(
                    qb, pool, table, kvl, window, splits), iters=3, warmup=1)
                seen = 0
                for n_tok in kv_len:
                    for lane in range(lanes):
                        rl = n_tok + lane
                        seen += rl - max(0, rl - window) if window else rl
                # K/V tokens some row needs: [lo, kv_len + lanes - 1)
                toks = sum(n_tok + lanes - 1
                           - (max(0, n_tok - window) if window else 0)
                           for n_tok in kv_len)
                itemsize = pool["k"].element_size()
                nbytes = (2 * toks * kvh * hd * itemsize
                          + (2 * toks * kvh * 4
                             if pool_kind == "int8" else 0)
                          + 2 * q.numel() * 2 + table.numel() * 4 + 4 * b)
                ops = 4 * seen * (h // kvh) * kvh * hd
                b_ms, b_by = bound(nbytes, ops, "bf16")
                log(f"{name} {pool_kind} {window} {splits} | {t_k:.4f} "
                    f"{t_p:.4f} {t_l:.4f} {b_ms:.4f} {b_by} | {err32:.3g} "
                    f"{err:.3g}")
                row = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                       "bound_ms": b_ms, "bound_by": b_by}
                if pool_kind == "bf16" and window is None:
                    if name == "decode":
                        main = row
                    elif name.startswith("verify"):
                        verify[name] = row
        del pool
    torch.cuda.empty_cache()
    # per decode step: the model's 24 attention layers at this shape
    step = {k_: (24 * v if k_.endswith("ms") else v) for k_, v in main.items()}
    log(f"B2 per decode step (24 layers, B=4, bf16 pool): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    for name, row in verify.items():
        log(f"B2 per {name} step (24 layers, B=4, L={name[-1]}+1, bf16 pool; "
            f"rows of a verify call bit-equal to decode calls): kernel "
            f"{24 * row['ms']:.3f} ms, plain {24 * row['plain_ms']:.3f} ms, "
            f"library {24 * row['library_ms']:.3f} ms, bound "
            f"{24 * row['bound_ms']:.3f} ms ({row['bound_by']})")
    return max_err, step


# ----------------------------------------------------------------- phase 4
PLENS, NEW_TOKENS = [53, 117, 211, 298], 32
FLOAT_LAYERS = 8               # depth of the float-recipe gate's model
# one CUDA graph per step of an engine with speculation off: a stack with
# a page pool (any attention layer) has a COW step too


def _one_each(cfg):
    pool = any(kind != "ssm" for kind in cfg.unit_pattern)
    return {"prefill": 1, "decode": 1, **({"cow": 1} if pool else {})}
PROFILE_STEPS = 8              # decode steps in each profiler window


def _counters():
    """Each kernel's wrapper module, which counts the kernel's launches."""
    from repro_torch.kernels import fused_quant_slide, fused_slide_matmul, \
        paged_attention, quant_matmul, slide_matmul
    return {"compressed_matmul": slide_matmul,
            "paged_attention": paged_attention,
            "fused_slided_matmul": fused_slide_matmul,
            "fused_quant_slide": fused_quant_slide,
            "quant_matmul": quant_matmul}


def _linear_bytes(params):
    """Bytes of a danube tree's linears (every unit's mixer and FFN
    projections and the lm_head)."""
    return sum(t.numel() * t.element_size()
               for u in params["units"] for lp in u.values()
               for blk in ("mixer", "ffn") for lin in lp[blk].values()
               for t in lin.values()) + sum(
        t.numel() * t.element_size() for t in params["lm_head"].values())


def _engine_setup(torch, mode, recipe="int8", dtype=None, num_layers=None,
                  keep_raw=False):
    """h2o-danube-3-4b at full width, 6:8 in ``mode``, fused attention,
    packed from the seed-0 init (bf16 activations and KV pages as
    registered, or ``dtype`` for both; the registered 24 layers, or
    ``num_layers``); the 4 staggered prompts drawn from the same
    generator.  Returns (cfg, params, prompts, ecfg), and with ``keep_raw``
    the unpacked draw fifth."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.linear import SparsityConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    base = registry.get("h2o-danube-3-4b")
    assert base.dtype == "bfloat16" and base.kv_cache_dtype == "bfloat16"
    over = {"dtype": dtype, "kv_cache_dtype": dtype} if dtype else {}
    if num_layers:
        over["num_layers"] = num_layers
    cfg = dataclasses.replace(
        base, **over,
        sparsity=SparsityConfig(pattern=(6, 8), mode=mode, recipe=recipe,
                                fused_attention=True))
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    raw = M.init(cfg, gen)
    params = serve_loop.pack_params(raw, cfg)
    if not keep_raw:
        del raw
    torch.cuda.synchronize()
    packed = _linear_bytes(params)
    log(f"init + pack: {time.time() - t0:.1f} s; {cfg.num_layers} layers, "
        f"{mode} {recipe} linears {packed / 1e9:.2f} GB; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in PLENS]
    ecfg = serve_loop.EngineConfig(max_batch=4, page_size=16, num_pages=128,
                                   max_seq_len=max(PLENS) + NEW_TOKENS,
                                   prefill_chunk=PREFILL_CHUNK)
    if keep_raw:
        return cfg, params, prompts, ecfg, raw
    return cfg, params, prompts, ecfg


def _sync_free(torch, eng, label):
    """Dispatch under ``torch.cuda.set_sync_debug_mode("error")`` one
    prefill chunk, one decode step, a COW call (where the stack has a page
    pool), a resumed prefill chunk (start > 0) and, when ``eng``
    speculates, a verify step, each step's ids' copy to the host queued
    too: any host synchronization on the step path raises.  The dummy
    inputs write only the spare page.  The COW call counts one copy in
    ``eng.stats``."""
    import numpy as np
    ec = eng.ecfg
    ptab = eng.kv.page_table_array()
    b = ec.max_batch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._prefill(np.zeros((1, ec.prefill_chunk)), ptab[:1], 0, 0)
        eng._decode(np.zeros(b), ptab, np.zeros(b), np.zeros(b))
        eng._to_host(eng._steps["decode"].out[0])
        if "cow" in eng.captures:
            eng._run_cow([(0, ec.num_pages)])
        eng._prefill(np.zeros((1, ec.prefill_chunk)), ptab[:1],
                     3 * ec.page_size, 0)
        if ec.speculate:
            eng._verify(np.zeros((b, ec.speculate + 1)), ptab, np.zeros(b),
                        np.ones(b), np.zeros(b))
            eng._to_host(eng._steps["verify"].out[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    cow = " a COW call," if "cow" in eng.captures else ""
    log(f"sync check {label}: a prefill chunk, a decode step,{cow} a "
        f"resumed prefill chunk"
        f"{' and a verify step' if ec.speculate else ''} ran under "
        "set_sync_debug_mode('error'), no host synchronization")


def _sync_check_bites(torch):
    """The control of the sync check: boolean-mask indexing (the form of
    the pool scatter the engine dropped) must raise under the mode."""
    x = torch.arange(8, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x[x > 3]
        bites = False
    except RuntimeError:
        bites = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bites, "set_sync_debug_mode('error') let a nonzero through"
    log("sync check control: boolean-mask indexing raises under "
        "set_sync_debug_mode('error')")


def _engine_pair(torch, cfg, params, ecfg):
    """An eager engine (private ``_eager``: the steps run op by op) and a
    graphed one (each step captured once in ``warmup``) on the same
    weights, both warmed up and put through the sync check.  No capture
    may warn of an empty graph (a step with nothing to record)."""
    import warnings
    from repro_torch.runtime import serve_loop
    eager = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda",
                                   _eager=True)
    log(f"warmup eager: {eager.warmup():.2f} s")
    graphed = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = graphed.warmup()
    graph_warnings = [str(w.message) for w in caught
                      if "graph" in str(w.message).lower()
                      and "empty" in str(w.message).lower()]
    log(f"warmup graphed (eager pass + capture): {t:.2f} s; captures "
        f"{graphed.captures}; empty-graph warnings {len(graph_warnings)}")
    assert not graph_warnings, graph_warnings
    assert set(eager.captures.values()) == {0}, eager.captures
    assert graphed.captures == _one_each(cfg), graphed.captures
    _sync_free(torch, eager, "eager")
    _sync_free(torch, graphed, "graphed")
    return eager, graphed


def _note_rows(e, rows, state, whole=None):
    """``on_step`` bookkeeping of the logits each decode step sampled from:
    the decode step's output row of each slot that decoded in it, appended
    per request to ``rows`` (``whole`` gathers vocab-sharded logits)."""
    if e.sched.stats.decode_steps > state["steps"]:
        logits = e._steps["decode"].out[1]
        if whole is not None:
            logits = whole(logits)
        for rid, slot in state["decoding"]:
            rows.setdefault(rid, []).append(logits[slot].clone())
        state["steps"] = e.sched.stats.decode_steps
    state["decoding"] = [(s.rid, s.slot) for s in e.sched.running
                         if not s.prefilling and not s.done]


def _serve_reqs(eng, reqs, split=False, rows=None):
    """Submit ``reqs`` [(rid, prompt, arrival)], NEW_TOKENS each, and run
    with every kernel count set to 0 just before ``run()``; the pages must
    balance after it.  Returns (completions of these rids, launches read
    just after, split or None).  With ``split`` each step ends in a
    synchronize, a step that advanced the scheduler's decode count is a
    decode (or verify) step and one that did not a prefill step, and
    split is {"prefill": seconds, "decode": seconds, "decode_steps": n}.
    With a dict ``rows`` each request's decode-step logits rows are kept
    there (``_note_rows``)."""
    import torch
    counters = _counters()
    for rid, p, arrival in reqs:
        eng.submit(p, NEW_TOKENS, rid=rid, arrival=arrival)
    marks = []
    state = {"decoding": [], "steps": eng.sched.stats.decode_steps}

    def on_step(e, k):
        if split:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), e.sched.stats.decode_steps))
        if rows is not None:
            _note_rows(e, rows, state)

    for mod in counters.values():
        mod.reset_counts()
    t_prev, d_prev = time.perf_counter(), eng.sched.stats.decode_steps
    out = eng.run(on_step=on_step if split or rows is not None else None)
    launches = {name: mod.launch_count() for name, mod in counters.items()}
    part = None
    if split:
        part = {"prefill": 0.0, "decode": 0.0, "decode_steps": 0}
        for t, d in marks:
            part["decode" if d > d_prev else "prefill"] += t - t_prev
            part["decode_steps"] += d - d_prev
            t_prev, d_prev = t, d
    eng.kv.check()
    pool = eng.kv.pool
    assert pool.num_free + pool.num_cached == eng.ecfg.num_pages, \
        "page accounting does not balance"
    return {rid: out[rid] for rid, _, _ in reqs}, launches, part


def _engine_run(eng, prompts, label, split=True, rows=None):
    """Serve the prompts, staggered, through ``_serve_reqs``; every
    request must finish OK.  Returns (completions, launches)."""
    out, launches, part = _serve_reqs(
        eng, [(i, p, 2 * i) for i, p in enumerate(prompts)], split, rows)
    s = eng.stats
    how = (f" (prefill steps {part['prefill']:.3f} s, decode steps "
           f"{part['decode']:.3f} s)" if split
           else " (no per-step synchronize)")
    log(f"run {label}: {s.steps} steps, {s.decode_steps} decode steps, "
        f"{s.decode_tokens} decode tokens in {s.wall_s:.3f} s{how}; "
        f"{s.decode_tok_s:.2f} tok/s; launches {launches}")
    assert all(c.ok and len(c.tokens) == NEW_TOKENS for c in out.values())
    return out, launches


def _hold_graphed(torch, eager, e_out, e_launches, graphed, g_out,
                  g_launches, label):
    """The graphed run equals the eager run of the same engine: streams,
    first-token logits bit for bit, and every kernel's launch count."""
    assert graphed.captures == _one_each(graphed.cfg), graphed.captures
    for i, c in g_out.items():
        assert c.tokens == e_out[i].tokens, \
            f"{label} request {i}: graphed stream differs from eager"
        got, want = graphed.first_logits[i], eager.first_logits[i]
        assert torch.equal(got, want), \
            f"{label} request {i}: graphed first logits differ from eager " \
            f"(max {(got.float() - want.float()).abs().max().item()})"
    assert g_launches == e_launches, (g_launches, e_launches)
    log(f"{label} graphed == eager: {len(g_out)} streams and first-token "
        f"logits bit-equal, launches equal {g_launches}; 1 capture per step")


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _logits_gate(torch, cfg, params, ecfg, prompts, eng, out, label,
                 limit=LOGIT_RL2, separate=False):
    """Hold ``eng``'s last-prefill logits to the one-shot prefill on the
    same weights, at ``limit``, beside two planted faults that must read
    above it.  With ``separate`` the faults need not pass ``limit``;
    instead every sound reading must lie below every planted fault's
    reading of every request.  With no limit, each request's sound
    reading must lie below both of its own planted faults' readings."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    # Gate of the last-prefill logits: the relative L2 distance
    # ||engine - one-shot|| / ||one-shot|| of each request, at the fixed
    # limit LOGIT_RL2.  The engine (paged kernel, fp32 softmax, 128-token
    # chunks) and the one-shot prefill (plain chunked SDPA in bf16) round
    # differently, and int8 activation quantization turns a rounding
    # difference into a whole step in the next linear, so a sound engine
    # sits above 0 (0.057-0.066).  Two planted faults are read in the same run
    # and must land above the limit, or the gate could not tell them from
    # that noise: "short", a graphed engine captured with every query row
    # missing its newest key (kv_len one short at the paged-attention
    # call), and "dropped", the engine's logits against the one-shot
    # prefill of the prompt without its last token.
    orig = kops.paged_attention

    def short_by_one(q, pool, page_table, kv_len, **kw):
        return orig(q, pool, page_table, kv_len - 1, **kw)

    kops.paged_attention = short_by_one
    try:  # the patch is in place when the graphs are captured
        bad = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
        bad.warmup()
        for i, p in enumerate(prompts):
            bad.submit(p, 1, rid=i, arrival=2 * i)
        bad.run()
    finally:
        kops.paged_attention = orig
    assert bad.captures == _one_each(cfg), bad.captures

    same, total = 0, 0
    read = {"sound": [], "short": [], "dropped": []}
    for i, p in enumerate(prompts):
        tok = torch.tensor([p], dtype=torch.int32, device="cuda")
        ref = M.prefill(params, cfg, tok)[0][0].float()
        got = eng.first_logits[i].float()
        read["sound"].append(_rel_l2(got, ref))
        read["short"].append(_rel_l2(bad.first_logits[i].float(), ref))
        read["dropped"].append(_rel_l2(
            got, M.prefill(params, cfg, tok[:, :-1])[0][0].float()))
        ref_toks, _ = serve_loop.generate(params, cfg, tok, NEW_TOKENS)
        same += sum(int(a == b) for a, b in zip(ref_toks[0].tolist(),
                                                out[i].tokens))
        total += NEW_TOKENS
        log(f"request {i}: prompt {len(p)}; last-prefill relative L2 vs "
            f"one-shot: sound {read['sound'][-1]:.5f}, short "
            f"{read['short'][-1]:.5f}, dropped {read['dropped'][-1]:.5f}; "
            f"max|diff|/std {((got - ref).abs().max() / ref.std()).item():.4f}"
            f"; argmax {int(got.argmax())} / {int(ref.argmax())}")
    log(f"identical tokens vs one-shot generate ({label}): {same}/{total} "
        f"({same / total:.3f})")
    worst = {k: max(v) for k, v in read.items()}
    log(f"last-prefill logits ({label}), worst relative L2: sound "
        f"{worst['sound']:.5f}"
        f", planted faults short {worst['short']:.5f} and dropped "
        f"{worst['dropped']:.5f}; limit {limit}")
    if limit is None:
        for i, sound in enumerate(read["sound"]):
            least = min(read["short"][i], read["dropped"][i])
            assert sound < least, \
                f"request {i}: sound reading {sound} not below both " \
                f"planted faults' ({least})"
        return read
    assert worst["sound"] <= limit, \
        f"engine logits off by {worst['sound']} > {limit}"
    if separate:
        least = min(min(read["short"]), min(read["dropped"]))
        log(f"separation ({label}): least planted-fault reading "
            f"{least:.5f} over worst sound reading {worst['sound']:.5f} = "
            f"{least / worst['sound']:.2f}")
        assert worst["sound"] < least, \
            f"worst sound reading {worst['sound']} not below every " \
            f"planted fault's ({least})"
        return read
    for fault in ("short", "dropped"):
        assert worst[fault] > limit, \
            f"planted fault {fault} ({worst[fault]}) passes the gate"
    return read


def phase_engine(torch, card):
    from repro_torch.kernels import slide_matmul as smm

    log("== engine: h2o-danube-3-4b 24L d3840, 6:8 compressed int8, bf16, "
        "fused attention; eager, then each step a CUDA graph ==")
    _sync_check_bites(torch)
    cfg, params, prompts, ecfg = _engine_setup(torch, "compressed")
    eager, eng = _engine_pair(torch, cfg, params, ecfg)
    rows = {}  # the eager decode logits, phase 11's tp = 1 reference
    e_out, e_launches = _engine_run(eager, prompts, "eager", rows=rows)
    eager_tok_s = eager.stats.decode_tok_s
    out, launches = _engine_run(eng, prompts, "graphed")
    log(f"B1 weight tiles decompressed {smm.decompress_count()}")
    assert launches["compressed_matmul"] > 0, launches
    assert launches["paged_attention"] > 0, launches
    assert launches["fused_slided_matmul"] == 0, launches
    _hold_graphed(torch, eager, e_out, e_launches, eng, out, launches,
                  "compressed")
    s = eng.stats
    log(f"decode throughput {s.decode_tok_s:.2f} tok/s graphed, "
        f"{eager.stats.decode_tok_s:.2f} eager (decode tokens over run wall "
        f"time incl. prefill) on {card}")
    del eager
    _logits_gate(torch, cfg, params, ecfg, prompts, eng, out, "int8")
    result = {"tokens": {i: c.tokens for i, c in out.items()},
              "first_logits": {i: v.cpu() for i, v in eng.first_logits.items()},
              "tok_s": s.decode_tok_s, "pack": (cfg, params),
              "prompts": prompts, "ecfg": ecfg,
              "eager_tok_s": eager_tok_s,
              "rows": {i: torch.stack(v).cpu() for i, v in rows.items()}}
    return launches, result


# ----------------------------------------------------------------- phase 5
def _decode_window(torch, eng, rid0, prompts):
    """Submit the prompts at once and step until every request decodes
    (no prefill left); returns the rids."""
    clock = eng.sched.clock
    rids = [rid0 + i for i in range(len(prompts))]
    for rid, p in zip(rids, prompts):
        eng.submit(p, NEW_TOKENS, rid=rid, arrival=clock)
    while eng.sched.waiting or any(s.prefilling for s in eng.sched.running):
        eng.step()
    torch.cuda.synchronize()
    return rids


def _profile(torch, eng, prompts, rid0, label):
    """A torch.profiler trace of PROFILE_STEPS decode steps of ``eng``,
    then as many steps without the profiler.  The trace gives the device
    time (the union of device activity), the device operations that took
    the most time and the host runtime calls that did; its window holds
    the profiler's own cost, which is large for graph launches.  The
    unprofiled steps give the step's wall time and the host's share of it
    (the wall time less the host's wait in ``_fetch``, over the wall
    time); the device idle share is 1 - traced device time over the
    unprofiled wall time (the window's own idle share is printed too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    rids = _decode_window(torch, eng, rid0, prompts)
    d0 = eng.sched.stats.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            with record_function("decode_step"):
                eng.step()
        torch.cuda.synchronize()
    waits, fetch = [], eng._fetch

    def timed_fetch(handle):
        t = time.perf_counter()
        arr = fetch(handle)
        waits.append(time.perf_counter() - t)
        return arr

    eng._fetch = timed_fetch
    try:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        wall = (time.perf_counter() - t0) * 1e6  # us, as the trace
    finally:
        del eng._fetch
    assert eng.sched.stats.decode_steps - d0 == 2 * PROFILE_STEPS, \
        "a profiled step was not a decode step"
    eng.run()
    assert all(eng.completions[r].ok for r in rids)
    evs = prof.events()
    steps = [e for e in evs if e.name == "decode_step"
             and e.device_type == DeviceType.CPU]
    assert len(steps) == PROFILE_STEPS, len(steps)
    lo = min(e.time_range.start for e in steps)
    hi = max(e.time_range.end for e in steps)
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    assert dev, f"profile {label}: no device activity recorded"
    busy, end = 0.0, lo
    for a, b, _ in dev:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    window = hi - lo

    def top(events):
        by = {}
        for a, b, name in events:
            if a < hi and b > lo:
                by[name] = by.get(name, 0.0) + min(b, hi) - max(a, lo)
        return sorted(by.items(), key=lambda kv: -kv[1])[:8]

    host_calls = [(e.time_range.start, e.time_range.end, e.name) for e in evs
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith("cuda")]
    out = {"step_ms": wall / PROFILE_STEPS / 1e3,
           "host_share": (wall - 1e6 * sum(waits)) / wall,
           "idle_share": max(0.0, 1 - busy / wall),
           "device_ms": busy / PROFILE_STEPS / 1e3}
    log(f"profile {label}: traced window {window / 1e3:.3f} ms for "
        f"{PROFILE_STEPS} decode steps, {len(dev)} device activities, device "
        f"time {busy / 1e3:.3f} ms ({out['device_ms']:.3f} a step), window "
        f"idle share {1 - busy / window:.3f}; unprofiled {wall / 1e3:.3f} ms "
        f"({out['step_ms']:.3f} a step), host share {out['host_share']:.3f} "
        f"(wait in _fetch {sum(waits) * 1e3:.3f} ms), device idle share "
        f"{out['idle_share']:.3f}")
    for name, us in top(dev):
        log(f"  top device op {label}: {us / 1e3:.3f} ms  {name[:100]}")
    for name, us in top(host_calls)[:3]:
        log(f"  top host runtime call {label}: {us / 1e3:.3f} ms  {name}")
    return out


def _timed_turns(torch, engines, prompts, want, card, wants=None):
    """Decode tok/s of each engine (decode tokens over its run's wall
    time, prefill included) on the chip_smoke traffic, the engines in
    turns (in order, then in reverse), each run's streams held to
    ``want`` (or to ``wants[label]`` where given).  An engine given as a
    function is built anew, and warmed up, for each of its turns: under
    MoE capacity a stream depends on the slot each request gets, and so
    on what the engine served before."""
    import statistics
    got = {label: [] for label in engines}
    order = list(engines) + list(reversed(engines))
    for turn, label in enumerate(order):
        eng = engines[label]
        if callable(eng):
            eng = eng()
        clock, rid0 = eng.sched.clock, 1000 * (turn + 1)
        d0 = eng.sched.stats.decode_tokens
        for i, p in enumerate(prompts):
            eng.submit(p, NEW_TOKENS, rid=rid0 + i, arrival=clock + 2 * i)
        out = eng.run()
        held = (wants or {}).get(label, want)
        for i in range(len(prompts)):
            assert out[rid0 + i].tokens == held[i], (label, i)
        got[label].append((eng.sched.stats.decode_tokens - d0)
                          / eng.stats.wall_s)
    med = {label: statistics.median(v) for label, v in got.items()}
    log(f"decode tok/s in turns ({' '.join(order)}), median of 2, on "
        f"{card}: " + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return med


def phase_slided_engine(torch, card, compressed):
    """The same model, weights and traffic in mode="slided": every linear,
    the lm_head included, through B3, and B1 never launched.  For int8 the
    two modes sum the same integer products (Phi keeps each kept weight
    once) and B2 is deterministic, so streams and first-token logits must
    equal the compressed engine's bit for bit.  Then the overlapped loop
    (async_loop), a profiler trace of eager and graphed decode steps, and
    the three engines timed in turns."""
    import dataclasses
    from repro_torch.runtime import serve_loop

    log("== slided engine: h2o-danube-3-4b 24L d3840, 6:8 slided int8, "
        "bf16, fused attention; eager, graphed, overlapped ==")
    cfg, params, prompts, ecfg = _engine_setup(torch, "slided")
    eager, eng = _engine_pair(torch, cfg, params, ecfg)
    rows = {}  # the eager decode logits, phase 11's tp = 1 reference
    e_out, e_launches = _engine_run(eager, prompts, "eager", rows=rows)
    eager_tok_s = eager.stats.decode_tok_s
    out, launches = _engine_run(eng, prompts, "graphed")
    assert launches["fused_slided_matmul"] > 0, launches
    assert launches["paged_attention"] > 0, launches
    assert launches["compressed_matmul"] == 0, launches
    _hold_graphed(torch, eager, e_out, e_launches, eng, out, launches,
                  "slided")
    tok_s = eng.stats.decode_tok_s
    log(f"decode throughput {tok_s:.2f} tok/s slided vs "
        f"{compressed['tok_s']:.2f} tok/s compressed, graphed (run wall time "
        f"incl. prefill) on {card}")
    for i, c in out.items():
        assert c.tokens == compressed["tokens"][i], \
            f"request {i}: slided stream differs from compressed"
        got = eng.first_logits[i].cpu()
        want = compressed["first_logits"][i]
        assert torch.equal(got, want), \
            f"request {i}: slided first logits differ from compressed " \
            f"(max {(got.float() - want.float()).abs().max().item()})"
    log(f"slided == compressed: {len(out)} streams and first-token logits "
        "bit-equal")

    # the overlapped loop: the same traffic, no per-step synchronize
    overlapped = serve_loop.ServeEngine(
        params, cfg, dataclasses.replace(ecfg, async_loop=True),
        device="cuda")
    log(f"warmup overlapped: {overlapped.warmup():.2f} s")
    a_out, a_launches = _engine_run(overlapped, prompts, "overlapped",
                                    split=False)
    a = overlapped.stats
    log(f"overlapped loop: lookahead_steps {a.lookahead_steps}, "
        f"overlap_frac {a.overlap_frac:.4f}, host_gap_s {a.host_gap_s:.6f}, "
        f"d2h_bytes {a.d2h_bytes} (sync graphed run: host_gap_s "
        f"{eng.stats.host_gap_s:.6f}, overlap_frac "
        f"{eng.stats.overlap_frac:.4f}, d2h_bytes {eng.stats.d2h_bytes})")
    for i, c in a_out.items():
        assert c.tokens == out[i].tokens, \
            f"request {i}: overlapped stream differs from the sync run"
    assert overlapped.sched.trace == eng.sched.trace, \
        "overlapped scheduler trace differs from the sync run"
    assert a.lookahead_steps > 0, "the fast path never fired"
    assert a_launches == launches, (a_launches, launches)
    assert overlapped.captures == _one_each(cfg), overlapped.captures
    log(f"overlapped == sync: {len(a_out)} streams and the scheduler trace "
        f"({len(eng.sched.trace)} entries) equal, launches equal")

    prof = {label: _profile(torch, e, prompts, 100, label)
            for label, e in (("eager", eager), ("graphed", eng))}
    want = {i: c.tokens for i, c in out.items()}
    tok = _timed_turns(torch, {"eager": eager, "graphed": eng,
                               "overlapped": overlapped}, prompts, want, card)
    return launches, {"profile": prof, "tok_s": tok, "pack": (cfg, params),
                      "tokens": want, "eager_tok_s": eager_tok_s,
                      "first_logits": {i: eng.first_logits[i].cpu()
                                       for i in want},
                      "rows": {i: torch.stack(v).cpu()
                               for i, v in rows.items()}}


# ----------------------------------------------------------------- phase 6
SHARED_LEN = 250               # tokens of the shared system prompt
SUFFIXES = (54, 70, 98, 120)   # distinct suffixes: 250 + 70 = 20 pages
PHRASE_LEN = 24                # the phrase the speculation traffic repeats
FAULT_PLAN = dict(seed=17, step_error_rate=0.1, poison_rids=(2,))


def _feature_engine(torch, cfg, params, ecfg, **kw):
    """A graphed engine with ``ecfg`` changed by ``kw``, warmed up: each
    of its steps (prefill, decode, COW and, speculating, verify) captured
    exactly once."""
    import dataclasses
    from repro_torch.runtime import serve_loop
    eng = serve_loop.ServeEngine(params, cfg, dataclasses.replace(ecfg, **kw),
                                 device="cuda")
    eng.warmup()
    want = dict(_one_each(eng.cfg),
                **({"verify": 1} if eng.ecfg.speculate else {}))
    assert eng.captures == want, eng.captures
    return eng


def _graph_nodes(torch, eng):
    """Nodes of each step's CUDA graph: the step's body captured once more
    into a graph that keeps its cudaGraph_t, counted by libcuda's
    cuGraphGetNodes.  None where this torch cannot keep the graph."""
    import ctypes
    from repro_torch.kernels import ops as kops
    if not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
        return None
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    nodes = {}
    for name, st in eng._steps.items():
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with kops.recorded_launches():
            with torch.cuda.graph(g):
                st.body(st.inputs)
        n = ctypes.c_size_t(0)
        err = cuda.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                                   ctypes.byref(n))
        assert err == 0, f"cuGraphGetNodes: CUresult {err}"
        nodes[name] = n.value
        del g
    torch.cuda.empty_cache()
    return nodes


def _prefix_traffic(torch, vocab):
    """Four staggered requests behind one SHARED_LEN-token system prompt,
    each with its own suffix (its 250 + 54..120 tokens end mid-page but
    for rid 1's, 20 full pages); rid 4 repeats rid 1's prompt and waits
    for a slot, so it is admitted while rid 1 still decodes, forks its 20
    pages and resumes inside the last, which rid 1 holds: its prefill
    write copies that page first (COW).  Then rid 5, a new suffix behind
    the same prompt, arrives after every other request retired, and
    revives the cached pages.  Returns (first requests, rid 5's prompt)."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def draw(n):
        return torch.randint(0, vocab, (n,), generator=gen,
                             device="cuda").tolist()

    shared = draw(SHARED_LEN)
    prompts = [shared + draw(n) for n in SUFFIXES]
    first = [(i, p, 2 * i) for i, p in enumerate(prompts)]
    first.append((4, list(prompts[1]), 8))
    return first, shared + draw(90)


def _tokens(out):
    return {rid: c.tokens for rid, c in out.items()}


def phase_features(torch, card, packs, prompts, ecfg, clean):
    """The engine features on the full-width model, packed once in phases
    4 and 5 (``packs``: mode -> (cfg, params)), graphed, page 16, batch 4,
    prefill chunk 128:
    - prefix cache, both modes: streams equal the same engine with the
      cache off; hits, COW copies, one capture of the COW step;
    - speculation (ngram drafts) on a repeated phrase, K = 3 in both modes
      and K = 4 compressed: streams equal speculate=0, drafts accepted,
      one capture of the verify step, B2's and the linear kernel's counts
      rising during run();
    - faults (a step error rate and one poisoned request) on the
      synchronous and the overlapped loop, slided, on phase 5's traffic:
      the poisoned request FAILED, survivors equal to ``clean`` (phase
      5's streams), retries taken, both loops ending alike;
    - int8 KV pages, compressed: graphed == eager bit for bit and the
      last-prefill logits gate with its two planted faults.
    The sync check covers the COW step, a resumed prefill and the verify
    step.  Decode tok/s spec-off against spec-on and prefill seconds
    prefix-off against prefix-on are timed in turns, for the record."""
    import dataclasses
    import statistics
    from repro_torch.runtime import faults as fl, scheduler as sch

    log("== engine features: h2o-danube-3-4b 24L d3840, 6:8 int8, graphed; "
        "prefix cache, speculative verify, fault injection, int8 KV ==")
    fecfg = dataclasses.replace(ecfg, num_pages=256, max_seq_len=512)
    vocab = packs["compressed"][0].vocab_size
    linear = {"compressed": "compressed_matmul",
              "slided": "fused_slided_matmul"}
    record = {}

    # -------- prefix cache: cache off, on; then on, off (prefill in turns)
    first, late = _prefix_traffic(torch, vocab)
    for mode in ("compressed", "slided"):
        cfg, params = packs[mode]
        streams, secs, engs = {}, {False: [], True: []}, {}
        for on in (False, True, True, False):
            eng = _feature_engine(torch, cfg, params, fecfg, prefix_cache=on)
            out, _, part = _serve_reqs(eng, first, split=True)
            secs[on].append(part["prefill"])
            if on in engs:  # the timing turn
                assert _tokens(out) == {r: streams[on][r] for r in out}
                continue
            late_out, _, _ = _serve_reqs(eng, [(5, late, eng.sched.clock)])
            out.update(late_out)
            assert all(c.ok and len(c.tokens) == NEW_TOKENS
                       for c in out.values()), (mode, on)
            streams[on], engs[on] = _tokens(out), eng
        assert streams[True] == streams[False], \
            f"prefix cache {mode}: streams differ from the cache-off engine"
        eng = engs[True]
        s = eng.stats
        assert s.prefix_hit_tokens > 0, f"prefix cache {mode}: no hit"
        assert s.cow_copies > 0, f"prefix cache {mode}: no COW copy"
        assert eng.captures["cow"] == 1, eng.captures
        pre = {k: statistics.median(v) for k, v in secs.items()}
        record[f"prefix {mode}"] = (s.prefix_hit_rate, pre)
        log(f"prefix cache {mode}: {len(streams[True])} streams equal to "
            f"cache-off; hit tokens {s.prefix_hit_tokens}, hit rate "
            f"{s.prefix_hit_rate:.4f}, prefill chunks skipped "
            f"{s.prefill_chunks_skipped}, COW copies {s.cow_copies}, cached "
            f"page reclaims {s.cached_page_evictions}; first 5 requests' "
            f"prefill steps in turns (off, on, on, off), median of 2: off "
            f"{pre[False]:.4f} s, on {pre[True]:.4f} s ({card})")
        _sync_free(torch, eng, f"prefix {mode}")
        del engs, eng
        torch.cuda.empty_cache()

    # -------- speculation on a repeated seeded phrase
    gen = torch.Generator(device="cuda").manual_seed(11)
    spec_reqs = []
    for i in range(4):
        phrase = torch.randint(0, vocab, (PHRASE_LEN,), generator=gen,
                               device="cuda").tolist()
        spec_reqs.append((i, phrase * (3 + i), 2 * i))  # 72..144 tokens
    for mode, ks in (("compressed", (3, 4)), ("slided", (3,))):
        cfg, params = packs[mode]
        off = _feature_engine(torch, cfg, params, fecfg)
        want, _, part = _serve_reqs(off, spec_reqs, split=True)
        want = _tokens(want)
        dec_ms = 1e3 * part["decode"] / part["decode_steps"]
        for k in ks:
            on = _feature_engine(torch, cfg, params, fecfg, speculate=k)
            out, launches, part = _serve_reqs(on, spec_reqs, split=True)
            assert all(c.ok for c in out.values())
            assert _tokens(out) == want, \
                f"speculate={k} {mode}: streams differ from speculate=0"
            s = on.stats
            assert s.accepted_tokens > 0, f"speculate={k} {mode}: none taken"
            assert on.captures["verify"] == 1, on.captures
            assert launches["paged_attention"] > 0, launches
            assert launches[linear[mode]] > 0, launches
            log(f"speculate={k} {mode}: {len(out)} streams equal to "
                f"speculate=0; {s.verify_steps} verify steps, accepted "
                f"{s.accepted_tokens}/{s.draft_tokens} (rate "
                f"{s.acceptance_rate:.4f}); launches {launches}; a verify "
                f"step {1e3 * part['decode'] / part['decode_steps']:.3f} ms "
                f"against a decode step {dec_ms:.3f} ms (speculate=0), "
                f"each step synchronized ({card})")
            if k == 3:
                _sync_free(torch, on, f"speculate=3 {mode}")
                tok = _timed_turns(
                    torch, {"spec-off": off, "spec-on": on},
                    [p for _, p, _ in spec_reqs], want, card)
                record[f"spec {mode}"] = (s.acceptance_rate, tok)
                if mode == "compressed":
                    nodes = _graph_nodes(torch, on)
                    log(f"CUDA graph nodes per step (compressed, "
                        f"speculate=3): {nodes if nodes else 'not measured'}")
                    record["nodes"] = nodes
            del on
            torch.cuda.empty_cache()
        del off

    # -------- faults on phase 5's traffic, sync and overlapped
    cfg, params = packs["slided"]
    reqs = [(i, p, 2 * i) for i, p in enumerate(prompts)]
    ends = {}
    for async_loop in (False, True):
        eng = _feature_engine(torch, cfg, params, ecfg, async_loop=async_loop,
                              faults=fl.FaultPlan(**FAULT_PLAN))
        out, _, _ = _serve_reqs(eng, reqs)
        assert (out[2].status, out[2].reason) == \
            (sch.FAILED, sch.REASON_POISONED), (out[2].status, out[2].reason)
        for rid, c in out.items():
            want = clean[rid] if c.ok else clean[rid][:len(c.tokens)]
            assert c.tokens == want, f"faults: request {rid} ({c.status})"
        s = eng.stats
        assert s.step_retries > 0, "faults: no step retried"
        ends[async_loop] = {r: (c.status, c.reason, c.tokens)
                            for r, c in out.items()}
        log(f"faults ({'overlapped' if async_loop else 'sync'}): statuses "
            f"{ {r: c.status for r, c in out.items()} }; step errors "
            f"{s.step_errors}, retries {s.step_retries}, failed {s.failed}, "
            f"lookahead steps {s.lookahead_steps}; injector "
            f"[{eng.injector.describe()}]; survivors equal the fault-free "
            "streams")
        del eng
    assert ends[True] == ends[False], "faults: the two loops ended apart"

    # -------- int8 KV pages, compressed
    cfg, params = packs["compressed"]
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    eager, eng = _engine_pair(torch, cfg8, params, ecfg)
    e_out, e_launches = _engine_run(eager, prompts, "eager int8-KV")
    out, launches = _engine_run(eng, prompts, "graphed int8-KV")
    _hold_graphed(torch, eager, e_out, e_launches, eng, out, launches,
                  "int8-KV")
    del eager
    _logits_gate(torch, cfg8, params, ecfg, prompts, eng, out,
                 "int8, int8 KV pages")
    del eng
    torch.cuda.empty_cache()
    return record


# ----------------------------------------------------------------- phase 7
def phase_float_gate(torch, card):
    """The north star's argmax-identity contract on the card: the engine
    at recipe "none" with fp32 activations and KV pages (B1's float
    instance, B2 with fp32 queries), graphed, against one-shot
    ``generate`` on the same weights and prompts.  Streams must be
    identical; where one diverges, the first divergent position may pass
    only as a tie within rounding: the one-shot logits' top-2 margin there
    below max|engine - one-shot| of the logits there."""
    log(f"== float gate: h2o-danube-3-4b full width cut to {FLOAT_LAYERS} of "
        f"24 layers, 6:8 compressed, recipe none, fp32 activations and KV "
        "pages, fused attention, graphed; streams vs one-shot generate ==")
    cfg, params, prompts, ecfg = _engine_setup(
        torch, "compressed", recipe="none", dtype="float32",
        num_layers=FLOAT_LAYERS)
    return _float_gate(torch, card, cfg, params, prompts, ecfg)


def _divergences(torch, card, cfg, params, prompts, ecfg, new_tokens,
                 label):
    """A graphed engine's streams against one-shot ``generate`` on the
    same weights.  Returns ({rid: None for an identical stream, else
    (first divergent position, one-shot top-2 margin there, max|engine -
    one-shot| of the logits there)}, identical tokens, compared tokens),
    and logs each request."""
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    eng = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
    log(f"warmup graphed ({label}): {eng.warmup():.2f} s")
    # the logits each decode step sampled from, per request: the decode
    # step's static output row of each slot that decoded in it
    rows, state = {}, {"decoding": [], "steps": 0}
    for i, p in enumerate(prompts):
        eng.submit(p, new_tokens, rid=i, arrival=2 * i)
    out = eng.run(on_step=lambda e, k: _note_rows(e, rows, state))
    assert all(c.ok and len(c.tokens) == new_tokens for c in out.values())
    eng.kv.check()
    log(f"run {label}: {eng.stats.decode_steps} decode steps in "
        f"{eng.stats.wall_s:.3f} s; {eng.stats.decode_tok_s:.2f} tok/s on "
        f"{card}")
    div, same, total = {}, 0, 0
    for i, p in enumerate(prompts):
        tok = torch.tensor([p], dtype=torch.int32, device="cuda")
        want, _ = serve_loop.generate(params, cfg, tok, new_tokens)
        want = want[0].tolist()
        got = out[i].tokens
        engine_logits = [eng.first_logits[i]] + rows.get(i, [])
        assert len(engine_logits) == new_tokens, len(engine_logits)
        # the one-shot logits of the first token, then at the first
        # divergent position, by the loop generate runs (its tokens held
        # to generate's up to there)
        logits, cache, kv_len = M.prefill(params, cfg, tok,
                                          max_len=len(p) + new_tokens)
        d0 = (engine_logits[0].float() - logits[0].float()).abs().max()
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is None:
            div[i] = None
            same += new_tokens
            total += new_tokens
            log(f"request {i}: prompt {len(p)}; {new_tokens}/{new_tokens} "
                f"tokens identical to one-shot; first-token max|engine - "
                f"one-shot| {d0.item():.3e}")
            continue
        for j in range(first):
            t = torch.argmax(logits, -1).to(torch.int32)
            assert int(t[0]) == want[j]
            logits, cache, kv_len = M.serve_step(params, cfg, t, cache,
                                                 kv_len)
        ref = logits[0].float()
        top2 = torch.topk(ref, 2).values
        margin = (top2[0] - top2[1]).item()
        diff = (engine_logits[first].float() - ref).abs().max().item()
        div[i] = (first, margin, diff)
        same += first
        total += first + 1
        log(f"request {i}: prompt {len(p)}; first divergence at position "
            f"{first} (engine {got[first]}, one-shot {want[first]}): "
            f"one-shot top-2 margin {margin:.3e}, max|engine - one-shot| "
            f"{diff:.3e}; first-token max|engine - one-shot| {d0.item():.3e}")
    return div, same, total


def _float_gate(torch, card, cfg, params, prompts, ecfg):
    """The float gate's run and check on a packed float model: a graphed
    engine's streams against one-shot ``generate``, a first divergence
    passing only as a tie within rounding."""
    div, same, total = _divergences(torch, card, cfg, params, prompts, ecfg,
                                    NEW_TOKENS, "float")
    ties = 0
    for i, d in div.items():
        if d is None:
            continue
        first, margin, diff = d
        ties += 1
        assert margin < diff, \
            f"request {i}: divergence at {first} is no tie (margin {margin}" \
            f" >= difference {diff})"
    log(f"float gate ({cfg.name}): {same}/{total} compared tokens identical "
        f"to one-shot generate, {ties} divergences, each a tie within "
        "rounding")
    return {"same": same, "total": total, "ties": ties}


# launch/serve_batched.py's granite engine demo: its default traffic and
# a smaller one
LAUNCHER_ARGV = (["--arch", "granite-moe-3b-a800m", "--engine"],
                 ["--arch", "granite-moe-3b-a800m", "--engine", "--requests",
                  "4", "--batch", "2", "--prompt-len", "24", "--new-tokens",
                  "8"])


def _launcher_kv_check(torch, card):
    """``launch/serve_batched.py``'s granite engine demo (fp32
    activations) on its own setup, for each of LAUNCHER_ARGV, run with its
    bf16 KV pages and again with fp32 pages.  The one-shot prefill
    attends over the prompt's K/V in the activation dtype, the engine
    over K/V read back from its pages (as in JAX).  Each divergence from
    one-shot is logged with the one-shot top-2 margin there and must be a
    tie within rounding (the margin below max|engine - one-shot| there,
    as the float gate holds it); with fp32 pages every stream must equal
    one-shot."""
    import dataclasses
    from repro_torch.launch import serve_batched as sb

    res = {}
    for argv in LAUNCHER_ARGV:
        args = sb.parse_args(argv + ["--device", "cuda"])
        base, params, _ = sb.demo_model(args.arch, "cuda")
        for kv in ("bfloat16", "float32"):
            b = dataclasses.replace(base, kv_cache_dtype=kv)
            cfg, packed, prompts, ecfg = sb.engine_traffic(args, b, params)
            label = f"serve_batched {' '.join(argv)}, {kv} KV pages"
            div, same, total = _divergences(
                torch, card, cfg, packed, prompts, ecfg, args.new_tokens,
                label)
            rids = sorted(i for i, d in div.items() if d is not None)
            for i in rids:
                first, margin, diff = div[i]
                assert margin < diff, \
                    f"{label}, request {i}: divergence at {first} is no " \
                    f"tie (margin {margin} >= difference {diff})"
            log(f"{label}: {same}/{total} compared tokens identical to "
                f"one-shot, divergent requests {rids}, each a tie within "
                "rounding")
            res[(" ".join(argv[3:]) or "defaults", kv)] = rids
            del packed
            if kv == "float32":
                assert not rids, \
                    f"{label}: requests {rids} diverge from one-shot"
    return res


# ----------------------------------------------------------------- phase 8
FAMILIES = ("granite-moe-3b-a800m", "mamba2-780m")
# granite's one-shot prefill dispatches a T-token prompt as one MoE group
# while T <= the group size (256), and asserts divisibility above it (as
# JAX does), so its prompts stay within one group
MOE_PLENS = [53, 117, 211, 250]
# B1/B3 shapes (N, K) the two models add: granite wq/wo, wk/wv and
# lm_head; mamba2 wx/wz, wB/wC, wdt, wo and lm_head
FAMILY_SHAPES = [(1536, 1536), (512, 1536), (49155, 1536), (3072, 1536),
                 (128, 1536), (48, 1536), (1536, 3072), (50280, 1536)]


def _family_setup(torch, arch, recipe="int8", dtype=None,
                  modes=("compressed", "slided"), num_layers=None):
    """``arch`` at its registered width and depth (or ``num_layers``),
    6:8, fused attention,
    random weights from the seed-0 generator: every SSM ``wo`` is drawn
    too (N(0, 1) * d_inner^-0.5; the init's zeros make the block the
    identity).  One draw packed in each of ``modes``; the MoE expert
    stacks are pruned once and shared by the packings.  bf16 activations
    and KV pages as registered, or ``dtype`` for both.  Returns
    ({mode: (cfg, params)}, prompts, ecfg)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.linear import SparsityConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    base = registry.get(arch)
    if dtype:
        base = dataclasses.replace(base, dtype=dtype, kv_cache_dtype=dtype)
    if num_layers:
        base = dataclasses.replace(base, num_layers=num_layers)
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    raw = M.draw_ssm_wo(M.init(base, gen), base, gen)
    packs = {}
    for mode in modes:
        cfg = dataclasses.replace(base, sparsity=SparsityConfig(
            pattern=(6, 8), mode=mode, recipe=recipe, fused_attention=True))
        params = serve_loop.pack_params(raw, cfg)
        for unit, packed in zip(raw.get("units", ()),
                                params.get("units", ())):
            for key, lp in packed.items():
                if "router" in lp.get("ffn", {}):
                    unit[key]["ffn"] = lp["ffn"]  # pruned: reused as is
        packs[mode] = (cfg, params)
    del raw
    torch.cuda.synchronize()

    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        if isinstance(node, list):
            return sum(nbytes(v) for v in node)
        return node.numel() * node.element_size()

    sizes = ", ".join(f"{m} {nbytes(p) / 1e9:.2f} GB" for m, (_, p) in
                      packs.items())
    log(f"init + pack {arch}: {time.time() - t0:.1f} s; {base.num_layers} "
        f"layers, {recipe}, packed weights {sizes} (MoE stacks shared); "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    plens = MOE_PLENS if base.uses_moe else PLENS
    prompts = [torch.randint(0, base.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in plens]
    ecfg = serve_loop.EngineConfig(max_batch=4, page_size=16, num_pages=128,
                                   max_seq_len=max(plens) + NEW_TOKENS,
                                   prefill_chunk=PREFILL_CHUNK)
    return packs, prompts, ecfg


def _interleaved(trace):
    """The rids whose prefill spans several chunks with a decode step
    between the first and the last (scheduler trace)."""
    chunks = {}
    for i, t in enumerate(trace):
        if t.startswith("prefill r"):
            chunks.setdefault(t.split()[1].split("[")[0], []).append(i)
    return [rid for rid, ix in chunks.items() if len(ix) > 1 and any(
        trace[j].startswith("decode") for j in range(ix[0] + 1, ix[-1]))]


def _b2_geometry(torch, gen, h, kvh, hd, pools=("bf16",)):
    """B2 at one head geometry (window off; decode at B = 4 up to 1000
    tokens and a 128-lane prefill chunk) against its split plain version
    at the kernel's split count: fp32 queries within B2_TOL, bf16 queries
    within 2^-7 of max|plain| and launched twice bit-identical, for each
    pool kind of ``pools`` (bf16, int8).  Returns the largest error."""
    from repro_torch.kernels import ref, paged_attention as pa

    ps, num_pages, err = 16, 320, 0.0
    for kind in pools:
        shape = (num_pages, ps, kvh, hd)
        if kind == "bf16":
            pool = {n: torch.randn(shape, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                    for n in ("k", "v")}
        else:
            pool = {n: torch.randint(-127, 128, shape, generator=gen,
                                     device="cuda", dtype=torch.int8)
                    for n in ("k", "v")}
            for n in ("k_scale", "v_scale"):
                pool[n] = torch.rand((num_pages, ps, kvh, 1), generator=gen,
                                     device="cuda") * 0.02 + 1e-3
        for name, kv_len, lanes in (("decode", [1000, 517, 77, 260], 1),
                                    ("prefill", [257], PREFILL_CHUNK)):
            b = len(kv_len)
            maxp = -(-(max(kv_len) + lanes - 1) // ps) + 2
            splits = pa.splits_for(b, kvh, maxp, ps, lanes, h // kvh)
            perm = torch.randperm(num_pages - 1, generator=gen,
                                  device="cuda") + 1
            table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
            used = 0
            for i, n_tok in enumerate(kv_len):
                n = -(-(n_tok + lanes - 1) // ps)
                table[i, :n] = perm[used:used + n].to(torch.int32)
                used += n
            kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            q = torch.randn((b, lanes, h, hd), generator=gen, device="cuda")
            qb = q.to(torch.bfloat16)
            exact = name != "prefill"
            y = pa.paged_attention_cuda(q, pool, table, kvl, None)
            y_ref = ref.flash_paged_split(q, pool, table, kvl, None, splits)
            yb = pa.paged_attention_cuda(qb, pool, table, kvl, None, exact)
            yb2 = pa.paged_attention_cuda(qb, pool, table, kvl, None, exact)
            yb_ref = ref.flash_paged_split(qb, pool, table, kvl, None,
                                           splits)
            e32 = (y - y_ref).abs().max().item()
            e16 = (yb.float() - yb_ref.float()).abs().max().item()
            label = f"B2 hd={hd} H={h} KVH={kvh} {kind} pool {name}"
            assert e32 <= B2_TOL, f"{label} fp32: {e32}"
            assert e16 <= 2 ** -7 * yb_ref.float().abs().max().item(), \
                f"{label} bf16: {e16}"
            assert torch.equal(yb, yb2), f"{label}: two launches differ"
            err = max(err, e32, e16)
            log(f"{label} (S={splits}): fp32 err {e32:.3g}, bf16 err "
                f"{e16:.3g}, launched twice bit-identical")
        del pool
    return err


def _b13_bit_equal(torch, gen, shapes, rows):
    """B1 and B3 (int8) bit-equal to their plain versions at each (N, K)
    of ``shapes`` and each R of ``rows`` (a tuple, or a function of the
    shape giving one).  Returns ({"B1": err, "B3": err}, cases)."""
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided
    from repro_torch.kernels import fused_slide_matmul as fsm, ref, \
        slide_matmul as smm

    err, cases = {"B1": 0.0, "B3": 0.0}, 0
    for mode in ("compressed", "slided"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode=mode, recipe="int8")
        rec, dec = cfg.recipe, cfg.decomposition()
        for m, k in shapes:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            del w
            for r in (rows(m, k) if callable(rows) else rows):
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                if mode == "compressed":
                    c = CompressedSlided(p["values"], p["indices"], k, 6, 8,
                                         2, 4)
                    qx = rec.quantize_act(x)
                    y = smm.compressed_matmul_cuda(
                        qx.q, c.values, c.indices, qx.scale, p["s_w"],
                        n_fam=4, out_dtype=torch.bfloat16)
                    y_ref = ref.compressed_matmul_dequant(
                        qx.q, qx.scale, c, p["s_w"], torch.bfloat16)
                    name = "B1"
                else:
                    y = fsm.fused_slided_matmul_cuda(
                        x, p["sp_values"], p["sp_meta"], p["s_w"], n_fam=4,
                        out_dtype=torch.bfloat16)
                    y_ref = ref.slided_matmul_sparse(
                        x, p["sp_values"], p["sp_meta"], p["s_w"], dec, rec,
                        torch.bfloat16)
                    name = "B3"
                e = (y.float() - y_ref.float()).abs().max().item()
                assert torch.equal(y, y_ref), \
                    f"{name} int8 {m}x{k} R={r}: not bit-equal ({e})"
                err[name] = max(err[name], e)
                cases += 1
                del x, y, y_ref
            del p
            torch.cuda.empty_cache()
    return err, cases


def _family_kernel_shapes(torch):
    """The kernel shapes the two models add, against the plain versions:
    B2 at granite's head_dim 64 with 3 query heads per KV head (bf16
    pool); B1 and B3 (int8, bit-equal) at FAMILY_SHAPES x R in
    {1, 4, prefill_chunk}."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b2 = _b2_geometry(torch, gen, 24, 8, 64)
    err, cases = _b13_bit_equal(torch, gen, FAMILY_SHAPES,
                                (1, 4, PREFILL_CHUNK))
    log(f"B1 and B3 int8 at the families' shapes {FAMILY_SHAPES} x R in "
        f"(1, 4, {PREFILL_CHUNK}): {cases} cases bit-equal to plain")
    return {**err, "B2": b2}


def _family_overlapped(torch, arch, cfg, params, ecfg, prompts, sync_eng,
                       sync_out, sync_launches):
    """The overlapped loop on the same traffic.  Its fast path feeds an
    inactive lane the previous step's id where the synchronous loop feeds
    0; under MoE capacity that lane competes with the real tokens of its
    step (as in JAX, whose loop does the same), and a request whose token
    changed competes in every later decode step it shares.  So a stream
    is held to the synchronous one only where the request never shared a
    decode step with such a lane or with a request exposed to one.  The
    scheduler trace and the launch counts do not depend on token values
    and are held whole."""
    import dataclasses
    from repro_torch.runtime import serve_loop

    eng = serve_loop.ServeEngine(
        params, cfg, dataclasses.replace(ecfg, async_loop=True),
        device="cuda")
    log(f"warmup overlapped {arch}: {eng.warmup():.2f} s")
    steps, fast, sync = [], eng._threaded_decode, eng._decode_batch

    def fast_step(la):
        steps.append((len(la.seqs) < eng.ecfg.max_batch,
                      {s.rid for s in la.seqs}))
        return fast(la)

    def sync_step(decision):
        steps.append((False, {s.rid for s in decision.seqs}))
        return sync(decision)

    eng._threaded_decode, eng._decode_batch = fast_step, sync_step
    try:
        out, launches = _engine_run(eng, prompts, f"{arch} overlapped",
                                    split=False)
    finally:
        del eng._threaded_decode, eng._decode_batch
    exposed = set()
    if cfg.uses_moe:
        for garbage, rids in steps:
            if garbage or rids & exposed:
                exposed |= rids
    mixed = sum(g for g, _ in steps)
    held = [i for i in out if i not in exposed]
    for i in held:
        assert out[i].tokens == sync_out[i].tokens, \
            f"{arch} request {i}: overlapped stream differs from sync"
    differ = sum(out[i].tokens != sync_out[i].tokens for i in exposed)
    assert eng.sched.trace == sync_eng.sched.trace, \
        f"{arch}: overlapped scheduler trace differs from the sync run"
    assert eng.stats.lookahead_steps > 0, f"{arch}: the fast path never fired"
    assert launches == sync_launches, (launches, sync_launches)
    assert eng.captures == _one_each(cfg), eng.captures
    log(f"overlapped {arch}: {eng.stats.lookahead_steps} fast-path steps, "
        f"{mixed} of them with an inactive lane; streams held equal to sync "
        f"for {len(held)} of {len(out)} requests (exposed to lane garbage "
        f"under MoE capacity: {sorted(exposed)}, {differ} of them differ); "
        "trace and launches equal")
    return eng, {i: c.tokens for i, c in out.items()}, mixed


def _moe_logits(torch, arch, cfg, params, ecfg, prompts, eng, out):
    """The MoE model's last-prefill logits gates.  Returns the worst
    readings at the registered capacity factor and at E / k."""
    import dataclasses
    from repro_torch.runtime import serve_loop

    # at the registered capacity a 128-token chunk (with its padding
    # rows) and a whole prompt drop different slots, so a sound reading
    # can exceed another request's planted fault: each request is held to
    # its own two faults
    read = _logits_gate(torch, cfg, params, ecfg, prompts, eng, out,
                        f"{arch} int8", limit=None)
    # at capacity factor E / k, cap = Tg and no expert takes more than Tg
    # tokens of a group, so neither grouping drops a slot: phase 4's limit
    # on every sound reading, and every sound reading below every planted
    # fault's (granite's "dropped" fault reads below that limit, so the
    # limit alone cannot see it)
    cf = cfg.moe_num_experts / cfg.moe_top_k
    nd_cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    nd = serve_loop.ServeEngine(params, nd_cfg, ecfg, device="cuda")
    nd.warmup()
    nd_out, _ = _engine_run(nd, prompts, f"{arch} compressed graphed, "
                            f"capacity factor {cf} (no drops)")
    nd_read = _logits_gate(torch, nd_cfg, params, ecfg, prompts, nd, nd_out,
                           f"{arch} int8, no drops", separate=True)
    return ({k: max(v) for k, v in read.items()},
            {k: max(v) for k, v in nd_read.items()})


def _family_run(torch, card, arch, setup=None):
    """One model of phase 8 (or 9): eager and graphed engines of both
    packings, held to each other; for MoE the logits gates, for SSM the
    interleaved schedule, for an attention-only stack phase 4's logits
    gate; the overlapped loop; a profile of graphed decode steps; and
    eager, graphed and overlapped decode tok/s in turns (slided, a fresh
    engine each turn).  ``setup``: ``_family_setup``'s result, made here
    (registered depth) where not given."""
    import dataclasses
    from repro_torch.runtime import serve_loop

    packs, prompts, ecfg = setup or _family_setup(torch, arch)
    res = {"launches": {}}
    engines = {}
    for mode, (cfg, params) in packs.items():
        eager, eng = _engine_pair(torch, cfg, params, ecfg)
        e_out, e_launches = _engine_run(eager, prompts, f"{arch} {mode} eager")
        out, launches = _engine_run(eng, prompts, f"{arch} {mode} graphed")
        _hold_graphed(torch, eager, e_out, e_launches, eng, out, launches,
                      f"{arch} {mode}")
        mine, other = ("compressed_matmul", "fused_slided_matmul")
        if mode == "slided":
            mine, other = other, mine
        assert launches[mine] > 0 and launches[other] == 0, launches
        assert (launches["paged_attention"] > 0) == \
            ("attn" in cfg.unit_pattern), launches
        res["launches"][mode] = launches
        engines[mode] = (eager, eng, out, launches)
    c_out, s_out = engines["compressed"][2], engines["slided"][2]
    for i, c in s_out.items():
        assert c.tokens == c_out[i].tokens, \
            f"{arch} request {i}: slided stream differs from compressed"
        got = engines["slided"][1].first_logits[i]
        want = engines["compressed"][1].first_logits[i]
        assert torch.equal(got, want), \
            f"{arch} request {i}: slided first logits differ from compressed"
    log(f"{arch} slided == compressed: {len(s_out)} streams and first-token "
        "logits bit-equal")

    cfg, params = packs["compressed"]
    eng = engines["compressed"][1]
    res["nodes"] = _graph_nodes(torch, eng)
    log(f"CUDA graph nodes per step ({arch}, compressed): "
        f"{res['nodes'] or 'not measured'}")
    if cfg.uses_moe:
        res["logits"], res["logits_no_drop"] = _moe_logits(
            torch, arch, cfg, params, ecfg, prompts, eng, c_out)
    elif not cfg.uses_ssm:
        read = _logits_gate(torch, cfg, params, ecfg, prompts, eng, c_out,
                            f"{arch} int8")
        res["logits"] = {k: max(v) for k, v in read.items()}
    if cfg.uses_ssm:
        inter = _interleaved(eng.sched.trace)
        assert inter, f"{arch}: no decode step between two prefill chunks " \
            f"of one request: {eng.sched.trace}"
        log(f"{arch}: a decode step ran between prefill chunks of "
            f"{', '.join(inter)}, whose SSM state survived it (streams "
            "above)")
    del engines["compressed"], eng
    torch.cuda.empty_cache()

    cfg, params = packs["slided"]
    eager, eng, out, launches = engines.pop("slided")
    overlapped, a_out, res["mixed_fast_steps"] = _family_overlapped(
        torch, arch, cfg, params, ecfg, prompts, eng, out, launches)
    res["profile"] = _profile(torch, eng, prompts, 100, f"{arch} graphed")
    del eager, eng, overlapped
    torch.cuda.empty_cache()

    def fresh(async_loop=False, **kw):
        def make():
            e = serve_loop.ServeEngine(
                params, cfg, dataclasses.replace(ecfg, async_loop=async_loop),
                device="cuda", **kw)
            e.warmup()
            return e
        return make

    want = {i: c.tokens for i, c in out.items()}
    res["tok_s"] = _timed_turns(
        torch, {"eager": fresh(_eager=True), "graphed": fresh(),
                "overlapped": fresh(async_loop=True)},
        prompts, want, card, wants={"overlapped": a_out})
    return res


def phase_families(torch, card):
    """Phase 8: granite-moe-3b-a800m (attention + MoE: B1 + B2
    compressed, B3 + B2 slided) and mamba2-780m (SSD: B1 or B3 alone),
    each at full width and depth, int8, bf16, fused attention, batch 4,
    page 16, chunk 128, both packings from one seeded draw; the kernel
    shapes the two add; and the fp32 float gate on mamba2."""
    log("== families: the kernel shapes granite-moe-3b-a800m and "
        "mamba2-780m add, against the plain versions ==")
    out = {"err": _family_kernel_shapes(torch)}
    for arch in FAMILIES:
        log(f"== families: {arch}, full width and depth, 6:8 int8, bf16, "
            "fused attention; compressed and slided, eager, graphed, "
            "overlapped ==")
        out[arch] = _family_run(torch, card, arch)
        torch.cuda.empty_cache()
    log("== families: float gate, mamba2-780m full width and depth, 6:8 "
        "compressed, recipe none, fp32; streams vs one-shot generate ==")
    packs, prompts, ecfg = _family_setup(torch, "mamba2-780m", recipe="none",
                                         dtype="float32",
                                         modes=("compressed",))
    cfg, params = packs["compressed"]
    out["float"] = _float_gate(torch, card, cfg, params, prompts, ecfg)
    del packs, params
    torch.cuda.empty_cache()
    log("== families: serve_batched's granite-moe-3b-a800m engine demo "
        "(fp32 activations) with bf16 and with fp32 KV pages; streams vs "
        "one-shot generate ==")
    out["launcher"] = _launcher_kv_check(torch, card)
    return out


def report_families(fam, card):
    """Phase 8's figures, one line each, beside the card."""
    for arch in FAMILIES:
        r = fam[arch]
        pr, tok = r["profile"], r["tok_s"]
        log(f"{arch} decode tok/s (slided, in turns): eager "
            f"{tok['eager']:.2f}, graphed {tok['graphed']:.2f}, graphed + "
            f"overlapped {tok['overlapped']:.2f}; graphed decode step "
            f"{pr['step_ms']:.3f} ms wall, {pr['device_ms']:.3f} ms device, "
            f"host share {pr['host_share']:.3f}, device idle share "
            f"{pr['idle_share']:.3f}; graph nodes {r['nodes']}; fast-path "
            f"steps with an inactive lane {r['mixed_fast_steps']} ({card})")
        for mode, n in r["launches"].items():
            log(f"{arch} {mode} launches in the graphed run: "
                f"compressed_matmul {n['compressed_matmul']}, "
                f"paged_attention {n['paged_attention']}, "
                f"fused_slided_matmul {n['fused_slided_matmul']}")
        if "logits" in r:
            log(f"{arch} last-prefill logits, worst relative L2: " + ", ".join(
                f"{k} {v:.5f}" for k, v in r["logits"].items()))
            log(f"{arch} last-prefill logits at no drops, worst relative "
                "L2: " + ", ".join(f"{k} {v:.5f}" for k, v in
                                   r["logits_no_drop"].items()))
    log("serve_batched granite-moe-3b-a800m engine demo, requests "
        "diverging from one-shot (each a tie within rounding): " + "; ".join(
            f"{traffic}, {kv} KV pages {rids}"
            for (traffic, kv), rids in fam["launcher"].items()) + f" ({card})")
    f = fam["float"]
    log(f"mamba2-780m float gate: {f['same']}/{f['total']} tokens identical, "
        f"{f['ties']} ties; kernel errors at the families' shapes "
        f"{fam['err']} ({card})")


# ----------------------------------------------------------------- phase 9
# B1/B3 shapes (N, K) the two models add: whisper's attention and MLP
# projections and lm_head; qwen2-vl's wq/wo, wk/wv, gate/up, down, lm_head
WHISPER_SHAPES = [(768, 768), (3072, 768), (768, 3072), (51865, 768)]
QWEN_SHAPES = [(8192, 8192), (1024, 8192), (29568, 8192), (8192, 29568),
               (152064, 8192)]
AUDIO_BATCH, AUDIO_PROMPT = 4, 16
# qwen2-vl-72b's depth on one card: both packings of one draw must fit
# beside the bf16 embedding (PERF.md section 4)
QWEN_LAYERS = 4
VISION_TOKENS, VISION_PROMPT = 256, 320


def _av_kernels(torch):
    """The kernel shapes and epilogue the audio and vision families add,
    against the plain versions: B1 and B3 int8 bit-equal at
    WHISPER_SHAPES and QWEN_SHAPES x R in {1, 4, prefill_chunk}, and at
    R = B x 1500 frames for whisper's K = 768 shapes (the encoder and the
    cross K/V); B1 and B3 with bias + GELU (whisper's fused MLP) within
    2^-7 of max|plain|, phase 2b's tolerance for bias + SiLU; B2 at
    qwen2-vl's 64 query heads over 8 KV heads of 128, bf16 and int8 pools."""
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided
    from repro_torch.kernels import fused_slide_matmul as fsm, ref, \
        slide_matmul as smm

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = AUDIO_BATCH * 1500

    def whisper_rows(m, k):
        return (1, 4, PREFILL_CHUNK) + ((rows,) if k == 768 else ())

    err, n_w = _b13_bit_equal(torch, gen, WHISPER_SHAPES, whisper_rows)
    err_q, n_q = _b13_bit_equal(torch, gen, QWEN_SHAPES,
                                (1, 4, PREFILL_CHUNK))
    err = {k: max(v, err_q[k]) for k, v in err.items()}
    log(f"B1 and B3 int8 bit-equal to plain: {n_w} cases at whisper's "
        f"{WHISPER_SHAPES} (R 1, 4, {PREFILL_CHUNK}; {rows} at K = 768), "
        f"{n_q} at qwen2-vl's {QWEN_SHAPES}")

    m, k = 3072, 768
    w = (torch.randn((m, k), generator=gen, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn((m,), generator=gen, device="cuda")
    for mode in ("compressed", "slided"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode=mode, recipe="int8")
        rec, dec = cfg.recipe, cfg.decomposition()
        p = sl.prepare({"w": w}, cfg)
        for r in (4, PREFILL_CHUNK):
            x = torch.randn((r, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            if mode == "compressed":
                c = CompressedSlided(p["values"], p["indices"], k, 6, 8, 2, 4)
                qx = rec.quantize_act(x)
                y = smm.compressed_matmul_cuda(
                    qx.q, c.values, c.indices, qx.scale, p["s_w"], bias,
                    n_fam=4, out_dtype=torch.bfloat16, activation="gelu")
                y_ref = ref.compressed_matmul_dequant(
                    qx.q, qx.scale, c, p["s_w"], torch.bfloat16, bias,
                    "gelu")
                name = "B1"
            else:
                y = fsm.fused_slided_matmul_cuda(
                    x, p["sp_values"], p["sp_meta"], p["s_w"], bias,
                    n_fam=4, out_dtype=torch.bfloat16, activation="gelu")
                y_ref = ref.slided_matmul_sparse(
                    x, p["sp_values"], p["sp_meta"], p["s_w"], dec, rec,
                    torch.bfloat16, bias=bias, activation="gelu")
                name = "B3"
            e = (y.float() - y_ref.float()).abs().max().item()
            scale = y_ref.float().abs().max().item()
            assert e <= 2 ** -7 * scale, \
                f"{name} int8 + bias + GELU {m}x{k} R={r}: {e} > 2^-7*{scale}"
            err[name] = max(err[name], e)
            log(f"{name} int8 + bias + GELU {m}x{k} R={r}: max abs err "
                f"{e:.3g} (max|plain| {scale:.3g})")
    del w, p
    err["B2"] = _b2_geometry(torch, gen, 64, 8, 128, ("bf16", "int8"))
    torch.cuda.empty_cache()
    return err


def _whisper_decode_check(torch, cfg, params, tokens, audio, limit,
                          label, gated=("position", "frame")):
    """JAX's own cross-check (``tests/test_models_smoke.py``): the first
    decode step's logits against a full prefill over [tokens; next], as
    the relative L2 distance, within ``limit``; two planted faults are
    read in the same run, the decode step's sinusoidal and RoPE position
    one off and its cross-attention without the last encoder frame, and
    those named in ``gated`` must exceed the limit.  Returns the
    readings."""
    from unittest import mock
    from repro_torch.models import attention, encdec, layers
    from repro_torch.models import model as M

    s = tokens.shape[1]
    logits, cache, kv_len = M.prefill(params, cfg, tokens, max_len=s + 4,
                                      extra_embeds=audio)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    full = M.prefill(params, cfg, torch.cat([tokens, nxt[:, None]], 1),
                     max_len=s + 4, extra_embeds=audio)[0]

    def step():  # rewrites the cache's row s: each call sees the same cache
        return M.serve_step(params, cfg, nxt, cache, kv_len)[0]

    sin_at, rope, cross = (layers.sinusoidal_positions_at, attention._rope,
                           encdec._cross_kv)
    read = {"sound": _rel_l2(step(), full)}
    with mock.patch.object(layers, "sinusoidal_positions_at",
                           lambda p, d: sin_at(p + 1, d)), \
            mock.patch.object(attention, "_rope", lambda spec, x, p: rope(
                spec, x, None if p is None else p + 1)):
        read["position"] = _rel_l2(step(), full)
    with mock.patch.object(encdec, "_cross_kv", lambda lp, c, e: tuple(
            t[:, :-1] for t in cross(lp, c, e))):
        read["frame"] = _rel_l2(step(), full)
    log(f"whisper decode vs prefill over [tokens; next] ({label}), "
        f"relative L2 of the logits: sound {read['sound']:.3g}, planted "
        f"faults: position one off {read['position']:.3g}, last encoder "
        f"frame dropped {read['frame']:.3g}; limit {limit}")
    assert read["sound"] <= limit, \
        f"whisper {label}: decode off the prefill by {read['sound']}"
    for fault in gated:
        assert read[fault] > limit, \
            f"whisper {label}: planted fault {fault} ({read[fault]}) " \
            "passes the gate"
    return read


def _profile_calls(torch, fn, n, label):
    """A torch.profiler trace of ``n`` calls of ``fn``: device time a call
    (the union of device activity) and the device operations that took
    the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    assert dev, f"profile {label}: no device activity recorded"
    busy, end, by = 0.0, dev[0][0], {}
    for a, b, name in dev:
        by[name] = by.get(name, 0.0) + b - a
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    device_ms = busy / n / 1e3
    log(f"profile {label}: {n} calls, {len(dev)} device activities, device "
        f"time {device_ms:.3f} ms a call")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"  top device op {label}: {us / n / 1e3:.3f} ms a call  "
            f"{name[:100]}")
    return device_ms


def _whisper(torch, card):
    """whisper-small at full width and depth (12 + 12 layers, d 768),
    6:8 int8, bf16, one seeded draw packed both ways, served one-shot
    through ``generate`` with seeded audio frames; its gates and record."""
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    counters = _counters()
    packs, _, _ = _family_setup(torch, "whisper-small")
    cfg = packs["compressed"][0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    audio = torch.randn((AUDIO_BATCH, cfg.max_source_positions, cfg.d_model),
                        generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (AUDIO_BATCH, AUDIO_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    # linears of a decode step: per decoder layer 4 self-attention, 4
    # cross-attention (wk, wv over the encoder output again) and 2 MLP
    per_step = cfg.num_layers * (4 + 4 + 2) + 1
    res = {"launches": {}, "first": {}, "tokens": {}}
    for mode, (cfg, params) in packs.items():
        mine = "compressed_matmul" if mode == "compressed" \
            else "fused_slided_matmul"
        logits, cache, kv_len = M.prefill(params, cfg, tokens,
                                          max_len=AUDIO_PROMPT + 1,
                                          extra_embeds=audio)
        res["first"][mode] = logits
        nxt = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.reset_counts()
        M.serve_step(params, cfg, nxt, cache, kv_len)
        torch.cuda.synchronize()
        step = {k: mod.launch_count() for k, mod in counters.items()}
        assert step[mine] == per_step, (mode, step)
        assert sum(step.values()) == per_step, (mode, step)
        for mod in counters.values():
            mod.reset_counts()
        toks, stats = serve_loop.generate(params, cfg, tokens, NEW_TOKENS,
                                          extra_embeds=audio)
        launches = {k: mod.launch_count() for k, mod in counters.items()}
        assert launches[mine] > 0 and sum(launches.values()) == \
            launches[mine], (mode, launches)
        res["launches"][mode] = launches[mine]
        res["tokens"][mode] = toks.tolist()
        res[f"prefill_s {mode}"] = stats.prefill_s
        res[f"tok_s {mode}"] = stats.decode_tok_s
        log(f"whisper {mode}: one decode step launches {step[mine]} "
            f"{mine} (reckoned {per_step}); generate {NEW_TOKENS} tokens: "
            f"prefill {stats.prefill_s:.3f} s, decode {stats.decode_tok_s:.2f}"
            f" tok/s, {launches[mine]} launches; sample {toks[0, :8].tolist()}"
            f" ({card})")
    assert res["tokens"]["slided"] == res["tokens"]["compressed"], \
        "whisper: slided stream differs from compressed"
    assert torch.equal(res["first"]["slided"], res["first"]["compressed"]), \
        "whisper: slided first logits differ from compressed"
    log(f"whisper slided == compressed: {AUDIO_BATCH} streams of "
        f"{NEW_TOKENS} tokens and the first logits bit-equal")

    cfg, params = packs["compressed"]
    res["check"] = _whisper_decode_check(torch, cfg, params, tokens, audio,
                                         WHISPER_RL2, "int8", ("position",))
    # the decode step's device time and its wall time, and the device
    # time of its cross K/V projections (24 linears at R = B x 1500) alone
    logits, cache, kv_len = M.prefill(params, cfg, tokens,
                                      max_len=AUDIO_PROMPT + 1,
                                      extra_embeds=audio)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    enc_out = cache["enc_out"]

    def step():
        M.serve_step(params, cfg, nxt, cache, kv_len)

    def cross():
        for lp in params["decoder"]:
            encdec._cross_kv(lp, cfg, enc_out)

    res["device_ms"] = _profile_calls(torch, step, 4, "whisper decode step")
    res["cross_ms"] = _profile_calls(torch, cross, 4, "whisper cross K/V")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) / 4 * 1e3
    log(f"whisper decode step (compressed, eager): {res['step_ms']:.3f} ms "
        f"wall, {res['device_ms']:.3f} ms device, of which the cross K/V "
        f"projections {res['cross_ms']:.3f} ms, a share of "
        f"{res['cross_ms'] / res['device_ms']:.3f} ({card})")
    del packs, params, cache
    torch.cuda.empty_cache()

    log("== audio and vision: whisper-small float cross-check, recipe "
        "none, fp32, compressed ==")
    fpacks, _, _ = _family_setup(torch, "whisper-small", recipe="none",
                                 dtype="float32", modes=("compressed",))
    cfg, params = fpacks["compressed"]
    res["float"] = _whisper_decode_check(torch, cfg, params, tokens, audio,
                                         WHISPER_FLOAT_RL2, "none, fp32")
    del fpacks, params
    torch.cuda.empty_cache()
    return res


def _qwen(torch, card):
    """qwen2-vl-72b at full width, depth QWEN_LAYERS: the engine gates of
    phase 8 (text only, as JAX's engine), one-shot ``generate`` with a
    vision prefix and its decode-vs-prefill check, M-RoPE on the card."""
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    arch = "qwen2-vl-72b"
    setup = _family_setup(torch, arch, num_layers=QWEN_LAYERS)
    res = _family_run(torch, card, arch, setup)
    packs = setup[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = packs["compressed"][0]
    tokens = torch.randint(0, cfg.vocab_size, (4, VISION_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    vision = torch.randn((4, VISION_TOKENS, cfg.d_model), generator=gen,
                         device="cuda")
    streams = {}
    for mode, (cfg, params) in packs.items():
        toks, stats = serve_loop.generate(params, cfg, tokens, NEW_TOKENS,
                                          extra_embeds=vision)
        streams[mode] = toks.tolist()
        res[f"vision tok_s {mode}"] = stats.decode_tok_s
        log(f"qwen2-vl {mode} one-shot generate, vision prefix "
            f"{VISION_TOKENS} of {VISION_PROMPT} tokens: prefill "
            f"{stats.prefill_s:.3f} s, decode {stats.decode_tok_s:.2f} tok/s"
            f" ({card})")
    assert streams["slided"] == streams["compressed"], \
        "qwen2-vl: slided one-shot stream differs from compressed"
    cfg, params = packs["compressed"]
    s = tokens.shape[1]
    logits, cache, kv_len = M.prefill(params, cfg, tokens, max_len=s + 1,
                                      extra_embeds=vision)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    dec = M.serve_step(params, cfg, nxt, cache, kv_len)[0]
    longer = torch.cat([tokens, nxt[:, None]], 1)
    read = {"sound": _rel_l2(dec, M.prefill(params, cfg, longer,
                                            extra_embeds=vision)[0]),
            "no vision": _rel_l2(dec, M.prefill(params, cfg, longer)[0])}
    log(f"qwen2-vl decode vs prefill over [tokens; next] with the vision "
        f"prefix, relative L2 of the logits: sound {read['sound']:.3g}, "
        f"planted fault (vision embeds left out of the prefill) "
        f"{read['no vision']:.3g}; limit {LOGIT_RL2}")
    assert read["sound"] <= LOGIT_RL2, read
    assert read["no vision"] > LOGIT_RL2, read
    res["vision"] = read
    del packs, setup, params, cache
    torch.cuda.empty_cache()

    x = torch.randn((4, 16, 64, 128), generator=gen, device="cuda")
    pos = torch.randint(0, 4096, (3, 4, 16), generator=gen, device="cuda",
                        dtype=torch.int32)
    same = pos[:1].expand(3, -1, -1)
    rope = layers.apply_rope(x, pos[0], cfg.rope_theta)
    assert torch.equal(layers.apply_mrope(x, same, cfg.rope_theta), rope), \
        "M-RoPE with equal streams differs from RoPE on the card"
    assert not torch.equal(layers.apply_mrope(x, pos, cfg.rope_theta), rope)
    log("apply_mrope on the card: three equal streams bit-equal to "
        "apply_rope, distinct streams differ")
    return res


def phase_audio_vision(torch, card):
    """Phase 9: whisper-small (encoder-decoder, one-shot) and qwen2-vl-72b
    (M-RoPE, vision prefix; engine and one-shot), both modes."""
    t0 = time.time()
    log("== audio and vision: the kernel shapes and epilogue whisper-small "
        "and qwen2-vl-72b add, against the plain versions ==")
    out = {"err": _av_kernels(torch)}
    log("== audio and vision: whisper-small 12 + 12 layers d768, 6:8 int8, "
        "bf16; compressed and slided, one-shot generate ==")
    out["whisper"] = _whisper(torch, card)
    log(f"== audio and vision: qwen2-vl-72b full width, {QWEN_LAYERS} "
        "layers, 6:8 int8, bf16, fused attention; compressed and slided, "
        "eager, graphed, overlapped; one-shot with a vision prefix ==")
    out["qwen"] = _qwen(torch, card)
    out["seconds"] = time.time() - t0
    log(f"phase 9 (audio and vision): {out['seconds']:.1f} s")
    return out


def report_audio_vision(av, card):
    """Phase 9's figures, one line each, beside the card."""
    w, q = av["whisper"], av["qwen"]
    log(f"whisper-small one-shot (B={AUDIO_BATCH}, prompt {AUDIO_PROMPT}, "
        f"{NEW_TOKENS} new): prefill s compressed "
        f"{w['prefill_s compressed']:.3f}, slided {w['prefill_s slided']:.3f};"
        f" decode tok/s compressed {w['tok_s compressed']:.2f}, slided "
        f"{w['tok_s slided']:.2f}; decode step {w['step_ms']:.3f} ms wall, "
        f"{w['device_ms']:.3f} ms device, cross K/V {w['cross_ms']:.3f} ms "
        f"(share {w['cross_ms'] / w['device_ms']:.3f}); launches in generate "
        f"{w['launches']} ({card})")
    log("whisper decode vs prefill, relative L2: int8 " + ", ".join(
        f"{k} {v:.5f}" for k, v in w["check"].items()) + "; fp32 none "
        + ", ".join(f"{k} {v:.3g}" for k, v in w["float"].items()))
    pr, tok = q["profile"], q["tok_s"]
    log(f"qwen2-vl-72b ({QWEN_LAYERS} layers) decode tok/s (slided, in "
        f"turns): eager {tok['eager']:.2f}, graphed {tok['graphed']:.2f}, "
        f"graphed + overlapped {tok['overlapped']:.2f}; graphed decode step "
        f"{pr['step_ms']:.3f} ms wall, {pr['device_ms']:.3f} ms device, host "
        f"share {pr['host_share']:.3f}, device idle share "
        f"{pr['idle_share']:.3f}; graph nodes {q['nodes']}; one-shot with "
        f"vision prefix decode tok/s compressed "
        f"{q['vision tok_s compressed']:.2f}, slided "
        f"{q['vision tok_s slided']:.2f} ({card})")
    for mode, n in q["launches"].items():
        log(f"qwen2-vl-72b {mode} launches in the graphed run: "
            f"compressed_matmul {n['compressed_matmul']}, paged_attention "
            f"{n['paged_attention']}, fused_slided_matmul "
            f"{n['fused_slided_matmul']}")
    log("qwen2-vl last-prefill logits, worst relative L2: " + ", ".join(
        f"{k} {v:.5f}" for k, v in q["logits"].items()) + "; vision "
        "decode vs prefill: " + ", ".join(
            f"{k} {v:.5f}" for k, v in q["vision"].items()))
    log(f"kernel errors at the audio and vision shapes {av['err']}; phase "
        f"9 {av['seconds']:.1f} s ({card})")


# ---------------------------------------------------------------- phase 10
# the launcher at full width and depth: its default batch and sequence
# (8 x 256 tokens a step), 30 steps; warmup_cosine's 100-step warmup
# scales the rate by step / 100, so at lr 3e-3 the rate peaks at 8.7e-4
# on step 29, near the peak rates LLM pretraining uses
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 256, 30, 3e-3
PARITY_LR = 1e-2
# (a): card vs CPU params after 3 steps, relative L2; on an H100 80GB HBM3
# the sound card read 7.5e-9 and the planted fault 6.9e-4
PARITY_RL2 = 1e-4
INT8_STEPS, INT8_LR = 15, 3e-3
# (d): remat on vs off read bit-equal on an H100 80GB HBM3; the gate leaves
# room for a reassociation, far below what a wrong recompute would move
REMAT_LOSS_RTOL, REMAT_GRAD_RL2 = 1e-6, 1e-5
TRAIN_TIMEOUT = 900  # seconds, each of the two child processes


def _masked(cfg, **over):
    """``cfg`` with every linear (and expert stack) STE-masked at 6:8."""
    import dataclasses
    from repro_torch.core.linear import SparsityConfig
    return dataclasses.replace(
        cfg, sparsity=SparsityConfig(pattern=(6, 8), mode="masked"), **over)


def _flat(torch, t):
    """Every leaf of a tree, as one float64 vector on the host."""
    from repro_torch import tree
    return torch.cat([x.detach().reshape(-1).to("cpu", torch.float64)
                      for x in tree.leaves(t)])


def _bits(torch, x):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.detach().reshape(-1).view(ints[x.element_size()])


def _train_card_vs_cpu(torch):
    """(a) Three ``steps.train_step`` calls at danube's smoke width, fp32,
    masked 6:8, on the card and on the CPU from the same params and
    batches; then on the card with the STE replaced by a plain prune (no
    gradient at pruned positions), which must fail the parameter gate."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import masks, packer
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = _masked(registry.smoke_config("h2o-danube-3-4b"))
    assert cfg.dtype == "float32"
    opt = adamw.AdamWConfig(lr=PARITY_LR)
    p0 = M.init(cfg, torch.Generator().manual_seed(0))
    pipe = SyntheticLM(cfg, 4, 32, seed=0, host_index=0, host_count=1)

    def run(device):
        p = tree.tree_map(lambda x: x.detach().clone().to(device), p0)
        st = adamw.init(p, opt)
        losses = []
        for s in range(3):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.batch_at(s).items()}
            p, st, m = steps.train_step(cfg, opt, p, st, batch)
            losses.append(float(m["loss"]))
        return losses, _flat(torch, p)

    cpu_l, cpu_p = run("cpu")
    card_l, card_p = run("cuda")
    sound = masks.ste_prune
    masks.ste_prune = packer.prune_to_pattern  # the planted fault
    try:
        fault_l, fault_p = run("cuda")
    finally:
        masks.ste_prune = sound
    rl2 = float((card_p - cpu_p).norm() / cpu_p.norm())
    frl2 = float((fault_p - cpu_p).norm() / cpu_p.norm())
    loss_rel = max(abs(a / b - 1) for a, b in zip(card_l, cpu_l))
    log(f"(a) card vs CPU, 3 steps: losses card {card_l} CPU {cpu_l} "
        f"(worst relative {loss_rel:.3g}); params relative L2 {rl2:.3g} "
        f"(gate {PARITY_RL2}); planted fault (plain prune, no STE) "
        f"{frl2:.3g}, losses {fault_l}")
    assert loss_rel <= 1e-5, (card_l, cpu_l)
    assert rl2 <= PARITY_RL2 < frl2, (rl2, frl2)
    return {"loss_rel": loss_rel, "params_rl2": rl2, "fault_rl2": frl2}


def _full(num_layers=None, remat=True):
    from repro_torch.configs import registry
    over = {"remat": remat}
    if num_layers:
        over["num_layers"] = num_layers
    return _masked(registry.get("h2o-danube-3-4b"), **over)


def _setup(torch, cfg, opt_cfg=None):
    """Seed-0 params and (given ``opt_cfg``) AdamW state on the card, and
    the launcher's synthetic stream (8 x 256)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    pipe = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, host_index=0,
                       host_count=1, device="cuda")
    return params, opt_cfg and adamw.init(params, opt_cfg), pipe


def _train_ste(torch):
    """(c) Full width, depth 2: after two steps (the first at lr 0 under
    warmup), every masked linear's effective weight is 6:8 (its dense
    weight is not), and its gradient is non-zero at the pruned
    positions: gradients stay dense."""
    from repro_torch import tree
    from repro_torch.core import masks
    from repro_torch.core.patterns import Pattern
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = _full(2)
    opt = adamw.AdamWConfig(lr=3e-4)
    params, st, pipe = _setup(torch, cfg, opt)
    for s in range(2):
        params, st, _ = steps.train_step(cfg, opt, params, st,
                                         pipe.device_batch_at(s))
    leaves = steps.trainable(params)
    grads = torch.autograd.grad(
        M.loss_fn(params, cfg, pipe.device_batch_at(2)), leaves)
    pat, linears, worst = Pattern(6, 8), 0, 1.0
    for path, w, g in zip(tree.paths(params), leaves, grads):
        if path[0] == "embed" or path[-1] != "w" or w.dim() != 2:
            continue
        with torch.no_grad():
            keep = masks.magnitude_mask(w, pat)
            eff = masks.ste_prune(w, pat)
            assert int((eff != 0).reshape(-1, 8).sum(-1).max()) <= 6, path
            assert int((w != 0).reshape(-1, 8).sum(-1).max()) == 8, path
            live = float((g[~keep] != 0).to(torch.float32).mean())
        worst = min(worst, live)
        linears += 1
    log(f"(c) STE, full width, 2 layers: {linears} masked linears 6:8 "
        f"after a step, dense weights not; the least share of non-zero "
        f"gradients at pruned positions {worst:.6f}")
    assert linears == 7 * cfg.num_layers + 1, linears
    assert worst >= 0.99, worst
    return {"linears": linears, "pruned_grad_nonzero": worst}


def _train_remat(torch):
    """(d) Full width, depth 4 (2 x 2 remat segments): loss and gradients
    with remat on and off, and the peak memory of each."""
    from repro_torch.models import model as M, transformer
    from repro_torch.runtime import steps

    cfg_on = _full(4)
    assert transformer._remat_split(cfg_on.num_units) == (2, 2)
    params, _, pipe = _setup(torch, cfg_on)
    batch = pipe.device_batch_at(0)
    out = {}
    for remat in (True, False):
        cfg = _full(4, remat=remat)
        leaves = steps.trainable(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()), grads,
                      (torch.cuda.max_memory_allocated() - base) / 1e9)
        del loss, grads
    loss_rel = abs(out[True][0] / out[False][0] - 1)
    worst = max(float((a.float() - b.float()).norm()
                      / max(float(b.float().norm()), 1e-30))
                for a, b in zip(out[True][1], out[False][1]))
    equal = all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                   out[False][1]))
    log(f"(d) remat on vs off, full width, 4 layers: loss {out[True][0]!r} "
        f"vs {out[False][0]!r} (relative {loss_rel:.3g}), worst gradient "
        f"relative L2 {worst:.3g}, bit-equal {equal}; peak memory above "
        f"the params: on {out[True][2]:.3f} GB, off {out[False][2]:.3f} GB")
    assert loss_rel <= REMAT_LOSS_RTOL and worst <= REMAT_GRAD_RL2, \
        (loss_rel, worst)
    return {"loss_rel": loss_rel, "grad_rl2": worst, "bit_equal": equal,
            "peak_gb_on": out[True][2], "peak_gb_off": out[False][2]}


def _train_int8(torch):
    """(e) Full width, depth 2, int8 AdamW moments: 15 steps, finite
    losses, the last three below the first three."""
    import math
    from repro_torch import tree
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = _full(2)
    opt = adamw.AdamWConfig(lr=INT8_LR, state_dtype="int8")
    params, st, pipe = _setup(torch, cfg, opt)
    moment = sum(t.numel() * t.element_size() for t in tree.leaves(
        [st.mu, st.nu, st.mu_scale, st.nu_scale]))
    n = sum(p.numel() for p in tree.leaves(params))
    losses = []
    for s in range(INT8_STEPS):
        params, st, m = steps.train_step(cfg, opt, params, st,
                                         pipe.device_batch_at(s))
        losses.append(float(m["loss"]))
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log(f"(e) int8 moments, full width, 2 layers, {INT8_STEPS} steps at lr "
        f"{INT8_LR}: losses {[round(x, 4) for x in losses]}; first three "
        f"{first:.4f}, last three {last:.4f}; moments {moment / 1e9:.3f} GB "
        f"for {n / 1e9:.3f} B params ({moment / n:.3f} bytes a param; fp32 "
        f"moments 8)")
    assert all(math.isfinite(x) for x in losses), losses
    assert last < first, losses
    return {"losses": losses, "moment_bytes": moment, "params": n}


def _train_checkpoints(torch):
    """(f) Exact resume at smoke width on the card (10 steps against 6
    and a resume to 10), and a save -> restore round trip of full-width
    params and AdamW state at depth 1, bit for bit; all in a temporary
    directory removed afterwards."""
    import os
    import tempfile
    from repro_torch import tree
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps, train_loop

    cfg = _masked(registry.smoke_config("h2o-danube-3-4b"))
    opt = adamw.AdamWConfig(lr=1e-3)

    def tc(path, n):
        return train_loop.TrainConfig(steps=n, ckpt_dir=path, ckpt_every=5,
                                      log_every=100, global_batch=4,
                                      seq_len=32)

    with tempfile.TemporaryDirectory() as tmp:
        full = train_loop.train(cfg, opt, tc(f"{tmp}/a", 10),
                                device="cuda")
        train_loop.train(cfg, opt, tc(f"{tmp}/b", 6), device="cuda")
        assert ckpt.latest_step(f"{tmp}/b") == 6
        res = train_loop.train(cfg, opt, tc(f"{tmp}/b", 10),
                               device="cuda")
    rel = abs(res["losses"][-1] / full["losses"][-1] - 1)
    exact = res["losses"] == full["losses"][6:]
    log(f"(f) resume at smoke width: final loss {full['losses'][-1]!r} "
        f"straight, {res['losses'][-1]!r} resumed at 6 (relative {rel:.3g}; "
        f"steps 7-10 bit-equal {exact})")
    assert res["final_step"] == 10 and rel <= 1e-5, (full, res)

    cfg1 = _full(1)
    params, st, pipe = _setup(torch, cfg1, opt)
    params, st, _ = steps.train_step(cfg1, opt, params, st,
                                     pipe.device_batch_at(0))
    state = {"params": params, "opt": st}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.time()
        path = ckpt.save(tmp, 1, state)
        save_s = time.time() - t0
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        like = tree.tree_map(torch.empty_like, state)
        t0 = time.time()
        got, step, _ = ckpt.restore(tmp, like, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.time() - t0
    assert step == 1 and tree.paths(got) == tree.paths(state)
    for a, b in zip(tree.leaves(state), tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(torch, a), _bits(torch, b))
    n = len(tree.leaves(state))
    log(f"(f) round trip, full width, 1 layer: {n} leaves (bf16 params, "
        f"fp32 moments), {nbytes / 1e9:.3f} GB; save {save_s:.2f} s, "
        f"restore {restore_s:.2f} s; bit-equal")
    return {"resume_rel": rel, "resume_exact": exact, "bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s}


def _train_profile(torch):
    """A torch.profiler trace of one full-width, full-depth training step
    (after one unprofiled step): the top device operations and the shares
    of device time of the STE masks, the AdamW update and the matmuls.
    Not gated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import masks
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = _full()
    opt = adamw.AdamWConfig(lr=3e-4)
    params, st, pipe = _setup(torch, cfg, opt)
    params, st, _ = steps.train_step(cfg, opt, params, st,
                                     pipe.device_batch_at(0))
    batch = pipe.device_batch_at(1)
    torch.cuda.synchronize()
    ste, update = masks.ste_prune, adamw.update

    def ste_traced(*a):
        with record_function("train.ste_masks"):
            return ste(*a)

    def update_traced(*a):
        with record_function("train.adamw"):
            return update(*a)

    masks.ste_prune, adamw.update = ste_traced, update_traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, st, _ = steps.train_step(cfg, opt, params, st, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        masks.ste_prune, adamw.update = ste, update
    share = {"ste_masks": 0.0, "adamw": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.duration
            low = k.name.lower()
            if "train.ste_masks" in names:
                share["ste_masks"] += k.duration
            elif "train.adamw" in names:
                share["adamw"] += k.duration
            elif any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass")):
                share["matmul"] += k.duration
            else:
                share["other"] += k.duration
    total = sum(share.values())
    assert total > 0, "profile: no device time recorded"
    # device time: the union of device activity (kernels and copies)
    dev = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    busy, end = 0.0, dev[0][0]
    for a, b in dev:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    idle = max(0.0, 1 - busy / (wall * 1e6))
    log(f"profile, one training step at full width and depth (traced): "
        f"device time {busy / 1e3:.3f} ms over {wall * 1e3:.3f} ms wall "
        f"(device idle share {idle:.3f}); shares of kernel time: "
        + ", ".join(f"{k} {v / total:.3f}" for k, v in share.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  top device op (training): {us / 1e3:.3f} ms  {name[:100]}")
    return {"device_ms": busy / 1e3, "wall_ms": wall * 1e3,
            "idle_share": idle,
            "shares": {k: v / total for k, v in share.items()}}


def training_checks() -> int:
    """Phase 10's checks (a) and (c)-(f) and the profile, run in a child
    process of chip_smoke (so the full-depth model finds the card empty).
    Prints one ``TRAINING {json}`` line; B1-B5 must launch no time."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.init()
    before = ops.launch_counts()
    out = {}
    for key, fn in (("a", _train_card_vs_cpu), ("c", _train_ste),
                    ("d", _train_remat), ("e", _train_int8),
                    ("f", _train_checkpoints), ("profile", _train_profile)):
        t0 = time.time()
        out[key] = fn(torch)
        torch.cuda.empty_cache()
        log(f"  ({key}) {time.time() - t0:.1f} s")
    assert ops.launch_counts() == before, "a B1-B5 kernel ran in training"
    log("B1-B5 launches in training: 0 (counters unchanged)")
    print("TRAINING " + json.dumps(out), flush=True)
    return 0


def _child(cmd, label, timeout):
    """Run ``cmd`` from the checkout's root; its output, prefixed; fail
    unless it exits 0.  Returns its standard output."""
    import os
    r = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    for line in r.stdout.splitlines():
        log(f"  [{label}] {line}")
    assert r.returncode == 0, f"{label} exited {r.returncode}"
    return r.stdout


def phase_training(torch, card):
    """Phase 10: single-device training (the STE-masked 6:8 launcher at
    full width and depth, in a child process), and the checks (a), (c)-(f)
    and the profile in another (``training_checks``)."""
    import gc
    import math
    import statistics
    t0 = time.time()
    gc.collect()  # engines and graphs of earlier phases in cycles
    torch.cuda.empty_cache()
    log(f"== training: checks (a) card == CPU, (c) STE, (d) remat, (e) int8 "
        f"state, (f) checkpoints, a profiled step; device memory here: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved ==")
    text = _child([sys.executable, "-c",
                   "import sys, chip_smoke; "
                   "sys.exit(chip_smoke.training_checks())"],
                  "training checks", TRAIN_TIMEOUT)
    out = json.loads(next(line for line in text.splitlines()
                          if line.startswith("TRAINING "))[len("TRAINING "):])
    log(f"== training: python -m repro_torch.launch.train --arch "
        f"h2o-danube-3-4b --sparse 6 8 --sparse-mode masked, full width and "
        f"depth, bf16, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} at "
        f"lr {TRAIN_LR} ==")
    text = _child([sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", "h2o-danube-3-4b", "--sparse", "6", "8",
                   "--sparse-mode", "masked", "--global-batch",
                   str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--steps",
                   str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every",
                   "5"], "launch.train", TRAIN_TIMEOUT)
    run = json.loads(next(line for line in reversed(text.splitlines())
                          if line.startswith("[launch.train] {"))
                     [len("[launch.train] "):])
    losses = run["losses"]
    assert len(losses) == TRAIN_STEPS, losses
    assert all(math.isfinite(x) for x in losses), losses
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    assert last < first - 0.1, (first, last, losses)
    out["launcher"] = dict(run, first5=first, last5=last)
    out["seconds"] = time.time() - t0
    log(f"training at full width and depth: losses first five {first:.4f}, "
        f"last five {last:.4f}; median step {run['median_step_ms']:.3f} ms "
        f"after the first, {run['tokens_per_s']:.1f} tokens/s, peak device "
        f"memory {run['peak_device_gb']:.2f} GB ({card})")
    log(f"phase 10 (training): {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 11
TP = 2
TP_FAULT_LAYER = 12            # the layer whose w_down one rank leaves unreduced
TP_RID = 100                   # first rid of the planted-fault runs
# depth of the launcher's tp = 2 vs tp = 1 run, in fp32 (recipe none):
# there tp = 2 moves the logits by fp32 reassociation only (~1e-6; phase
# 7's fp32 engine read 1.5e-5 off one-shot and diverged nowhere), where
# in bf16 int8 a one-ulp difference can flip a near-tie token
TP_LAUNCH_LAYERS = 2
# B1 and B3 shapes (N, K) of one rank's shard at tp = 2: the column-
# parallel wq, wk/wv, gate/up, lm_head, and the row-parallel wo, w_down
TP_SHAPES = [(1920, 3840), (480, 3840), (5120, 3840), (16000, 3840),
             (3840, 1920), (3840, 5120)]
TP_ROW_SHAPES = [(3840, 1920), (3840, 5120)]   # B3 given the act_absmax
# ||tp = 2 - tp = 1|| / ||tp = 1|| of the last-prefill logits.  The ranks
# sum their row-parallel partials in fp32 and round once, but a one-ulp
# bf16 difference (that sum's reassociation, B2's split count at 4 KV
# heads) moves an int8 step in the next linear, and over 24 layers a
# sound tp = 2 engine read 0.0379-0.0412 on the H100; the planted faults
# read 0.0555-0.0668 (rank 1 quantizing its row-parallel projections with
# its local absmax) and 0.0982-0.1085 (one w_down left unreduced).  Every
# kernel and the two-rank sum are deterministic, so the readings repeat;
# the limit sits between, near the geometric mean of 0.0412 and 0.0555
TP_RL2 = 0.048
TP_TIMEOUT = 600


def _tp_kernels(torch, timer):
    """The kernels at one rank's shard shapes: B1 and B3 int8 bit-equal at
    TP_SHAPES x R in {1, 4, prefill_chunk}; B3 given ``act_absmax`` (a
    global absmax above each row's own) bit-equal to its plain version at
    the row-parallel shapes x R in {1, 4, 128}, int8 and w4, and given the
    rows' own absmax bit-equal to B3 without one; B2 at H = 16, KVH = 4
    (hd 120, bf16 and int8 pools) against its split plain version.  The
    act_absmax instance is timed beside the plain version and bf16
    ``torch.matmul`` at R = 4 (the JSON row: one tp = 2 decode step's 24
    wo + 24 w_down calls)."""
    from repro_torch.core import linear as sl, packer, quant
    from repro_torch.kernels import fused_slide_matmul as fsm, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    b2 = _b2_geometry(torch, gen, 16, 4, 120, pools=("bf16", "int8"))
    err, cases = _b13_bit_equal(torch, gen, TP_SHAPES,
                                (1, 4, PREFILL_CHUNK))
    log(f"B1 and B3 int8 at the tp = 2 shard shapes {TP_SHAPES} x R in "
        f"(1, 4, {PREFILL_CHUNK}): {cases} cases bit-equal to plain")
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_s": 0.0,
           "ops_s": 0.0}
    e_aa, n_aa = 0.0, 0
    for recipe in ("int8", "w4"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode="slided", recipe=recipe)
        rec, dec = cfg.recipe, cfg.decomposition()
        for m, k in TP_ROW_SHAPES:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            sv, sm, s_w = p["sp_values"], p["sp_meta"], p["s_w"]
            qw = rec.quantize_weight(packer.prune_to_pattern(w, dec.source))
            w_dense = (qw.q.float() * qw.scale).to(torch.bfloat16)
            del w
            for r in (1, 4, 128):
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                own = quant.absmax(x)
                aa = own * (1 + torch.rand((r, 1), generator=gen,
                                           device="cuda"))

                def b3(a=aa):
                    return fsm.fused_slided_matmul_cuda(
                        x, sv, sm, s_w, n_fam=4, act=rec.act,
                        packed=rec.packed_weights, out_dtype=torch.bfloat16,
                        act_absmax=a)

                def plain():
                    return ref.slided_matmul_sparse(
                        x, sv, sm, s_w, dec, rec, torch.bfloat16,
                        act_absmax=aa)

                n0 = fsm.act_absmax_count()
                y = b3()
                torch.cuda.synchronize()
                assert fsm.act_absmax_count() == n0 + 1
                y_ref = plain()
                e = (y.float() - y_ref.float()).abs().max().item()
                assert torch.equal(y, y_ref), \
                    f"B3 act_absmax {recipe} {m}x{k} R={r}: not bit-equal ({e})"
                none = fsm.fused_slided_matmul_cuda(
                    x, sv, sm, s_w, n_fam=4, act=rec.act,
                    packed=rec.packed_weights, out_dtype=torch.bfloat16)
                assert torch.equal(b3(own), none), \
                    f"B3 given the rows' own absmax != B3 ({m}x{k} R={r})"
                assert not torch.equal(y, none)
                e_aa, n_aa = max(e_aa, e), n_aa + 1
                if recipe == "int8" and r == 4:
                    t_k, t_l = timer.turns(b3, lambda: torch.matmul(
                        x, w_dense.T))
                    t_p = timer(plain, iters=3, warmup=1)
                    nbytes = (sv.numel() + 4 * sm.numel() + 4 * m
                              + r * k * 2 + r * m * 2 + 4 * r)
                    ops = 2 * r * m * k * 0.75
                    row["ms"] += 24 * t_k
                    row["plain_ms"] += 24 * t_p
                    row["library_ms"] += 24 * t_l
                    row["bytes_s"] += 24 * bytes_s(nbytes)
                    row["ops_s"] += 24 * ops_s(ops)
                    log(f"B3 act_absmax int8 {m} {k} {r} | {t_k:.4f} "
                        f"{t_p:.4f} {t_l:.4f} "
                        f"{bound(nbytes, ops, 'int8')[0]:.4f} | {e:.3g}")
            del p, sv, sm, s_w, qw, w_dense
            torch.cuda.empty_cache()
    row["bound_ms"] = max(row["bytes_s"], row["ops_s"]) * 1e3
    row["bound_by"] = "bytes" if row["bytes_s"] >= row["ops_s"] \
        else "operations"
    log(f"B3 given act_absmax: {n_aa} cases (int8, w4 x {TP_ROW_SHAPES} x "
        f"R in (1, 4, 128)) bit-equal to plain, and given the rows' own "
        f"absmax bit-equal to B3 without it; one tp = 2 decode step's 48 "
        f"row-parallel calls: kernel {row['ms']:.3f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bf16 torch.matmul "
        f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    return {"B2": b2, **err, "B3_act_absmax": e_aa, "row": row}


def tp_rank(root: str) -> int:
    """One rank of phase 11 (``phase_tp`` starts two, both on cuda:0, over
    gloo).  Phase 4's seeded full-width, full-depth weights drawn once,
    packed compressed and slided, each packing handed to
    ``ServeEngine(tp=2)``, which keeps this rank's shard.  Per mode:
    phase 5's traffic served eager with every kernel count and the
    collective count set to 0 just before ``run()``; the last-prefill
    logits and each decode step's logits (gathered); then, on the
    compressed engine, the same prompts once more for one token under
    each planted fault.  Writes ``rank{r}.pt`` under ``root``."""
    import dataclasses
    import gc
    import torch
    from repro_torch.core import linear as sl
    from repro_torch.core.linear import SparsityConfig
    from repro_torch.kernels import fused_slide_matmul as fsm
    from repro_torch.runtime import serve_loop
    from repro_torch.sharding import dist as tdist, tp as tpmod

    rank, world = tdist.init("gloo")
    tdist.device_for(None)
    counters = _counters()
    # one draw packed both ways, each packing handed to its engine
    t0 = time.time()
    cfg, params, prompts, ecfg, raw = _engine_setup(torch, "compressed",
                                                    keep_raw=True)
    cfgs = {"compressed": cfg, "slided": dataclasses.replace(
        cfg, sparsity=SparsityConfig(pattern=(6, 8), mode="slided",
                                     recipe="int8", fused_attention=True))}
    ecfg = dataclasses.replace(ecfg, tp=world)
    engines, sizes = {}, {}
    for mode, cfg in cfgs.items():
        if params is None:
            params = serve_loop.pack_params(raw, cfg)
        sizes[mode] = _linear_bytes(params)
        engines[mode] = serve_loop.ServeEngine(params, cfg, ecfg,
                                               device="cuda")
        params = None
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    mem = torch.cuda.memory_allocated()
    log(f"rank {rank}: both engines loaded in {time.time() - t0:.1f} s; "
        f"device memory {mem / 1e9:.2f} GB")
    res = {}
    for mode in ("compressed", "slided"):
        eng, full = engines.pop(mode), sizes[mode]
        shard = _linear_bytes(eng.params)
        heads = sorted({lp["k"].shape[2] for u in eng.cache
                        for lp in u.values() if "k" in lp})
        log(f"rank {rank} {mode}: linears {shard / 1e9:.3f} GB of the whole "
            f"{full / 1e9:.3f} GB ({shard / full:.4f}); pool KV heads "
            f"{heads}")
        eng.warmup()
        rows, per_step = {}, []
        state = {"decoding": [], "steps": 0, "c": 0}

        def on_step(e, k):
            if e.sched.stats.decode_steps > state["steps"]:
                per_step.append(tpmod.collective_count() - state["c"])
            _note_rows(e, rows, state, whole=e._whole)
            state["c"] = tpmod.collective_count()

        for i, p in enumerate(prompts):
            eng.submit(p, NEW_TOKENS, rid=i, arrival=2 * i)
        for mod in counters.values():
            mod.reset_counts()
        tpmod.reset_counts()
        out = eng.run(on_step=on_step)
        launches = {name: mod.launch_count() for name, mod in counters.items()}
        act_absmax = fsm.act_absmax_count()
        eng.kv.check()
        pool = eng.kv.pool
        balanced = pool.num_free + pool.num_cached == ecfg.num_pages
        s = dataclasses.replace(eng.stats)  # before the fault runs
        log(f"rank {rank} {mode} tp=2 eager: {s.steps} steps, "
            f"{s.decode_steps} decode steps, {s.decode_tokens} decode tokens "
            f"in {s.wall_s:.3f} s; {s.decode_tok_s:.2f} tok/s "
            f"({s.decode_tok_s_per_device:.2f} per device); launches "
            f"{launches}, B3 given act_absmax {act_absmax}; collectives per "
            f"decode step {sorted(set(per_step))}")
        first = {i: eng.first_logits[i].cpu() for i in out}
        # the planted faults, on the engine's shards: rank 1 leaves one
        # layer's w_down unreduced (it takes part in the all-reduce and
        # keeps its partial), or quantizes every row-parallel projection
        # with its local absmax (it takes part in the max and keeps its
        # own); rank 0 runs as sound
        target = eng.params["units"][TP_FAULT_LAYER]["layer_0"]["ffn"][
            "w_down"]
        orig_apply, orig_reduce = sl.apply, tpmod.reduce
        orig_max = tpmod.reduce_max

        def keep_partial(y):
            orig_reduce(y)
            return y

        def skip_reduce(p, x, c, activation=None, reduce_out=False):
            if p is target and rank == 1:
                tpmod.reduce = keep_partial
                try:
                    return orig_apply(p, x, c, activation, reduce_out)
                finally:
                    tpmod.reduce = orig_reduce
            return orig_apply(p, x, c, activation, reduce_out)

        def local_absmax(a):
            orig_max(a)
            return a

        faults = {}
        # on the compressed engine only: the slided one is its bit-equal
        # twin at tp = 2 (logged by phase_tp)
        plants = (("skip_reduce", (sl, "apply", skip_reduce)),
                  ("local_absmax", (tpmod, "reduce_max", local_absmax)))
        for f, (fname, (mod, name, patch)) in enumerate(
                plants if mode == "compressed" else ()):
            before = getattr(mod, name)
            setattr(mod, name, patch)
            try:
                base = TP_RID + 10 * f
                for i, p in enumerate(prompts):
                    eng.submit(p, 1, rid=base + i, arrival=2 * i)
                eng.run()
            finally:
                setattr(mod, name, before)
            faults[fname] = {i: eng.first_logits[base + i].cpu()
                             for i in range(len(prompts))}
        eng.kv.check()
        res[mode] = {
            "tokens": {i: c.tokens for i, c in out.items()},
            "ok": all(c.ok and len(c.tokens) == NEW_TOKENS
                      for c in out.values()),
            "first": first if rank == 0 else None,
            "rows": ({i: torch.stack(v).cpu() for i, v in rows.items()}
                     if rank == 0 else None),
            "faults": faults if rank == 0 else None,
            "launches": launches, "act_absmax": act_absmax,
            "per_step": per_step, "full": full, "shard": shard, "mem": mem,
            "heads": heads,
            "balanced": balanced, "tok_s": s.decode_tok_s,
            "tok_s_per_device": s.decode_tok_s_per_device,
            "wall": s.wall_s, "decode_steps": s.decode_steps,
            "captures": eng.captures}
        del eng, out, rows, first, faults, target
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(res, f"{root}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def _tp_divergences(torch, mode, got, ref):
    """tp = 2 streams against tp = 1's: identical, or each first
    divergence a tie within rounding at the tp = 1 logits there (its top-2
    margin below max|tp2 - tp1| of the logits there, phase 7's rule).
    Returns the number of divergent requests."""
    ties = 0
    for i, want in ref["tokens"].items():
        toks = got["tokens"][i]
        first = next((j for j, (a, b) in enumerate(zip(toks, want))
                      if a != b), None)
        if first is None:
            continue
        def at(side, j):
            return side["first"][i] if j == 0 else side["rows"][i][j - 1]
        r1, r2 = at(ref, first).float(), at(got, first).float()
        top2 = torch.topk(r1, 2).values
        margin = (top2[0] - top2[1]).item()
        diff = (r2 - r1).abs().max().item()
        log(f"tp {mode} request {i}: first divergence at {first} (tp=2 "
            f"{toks[first]}, tp=1 {want[first]}): tp=1 top-2 margin "
            f"{margin:.3e}, max|tp2 - tp1| {diff:.3e}")
        assert margin < diff, \
            f"tp {mode} request {i}: divergence at {first} is no tie"
        ties += 1
    return ties


def _tp_launcher_start():
    """Start ``launch/serve.py --engine --tp 2 --dist-backend gloo`` at full
    width and TP_LAUNCH_LAYERS layers, 6:8 compressed, fp32, beside
    ``--tp 1`` and ``--tp 2 --dist-backend nccl``; returns the processes
    (``_tp_launcher_check`` reads them)."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "h2o-danube-3-4b", "--sparse", "6", "8", "--precision", "none",
           "--dtype", "float32", "--engine", "--fused-attention",
           "--layers", str(TP_LAUNCH_LAYERS)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = {"tp1": ["--tp", "1"],
            "tp2": ["--tp", str(TP), "--dist-backend", "gloo"],
            "nccl": ["--tp", str(TP), "--dist-backend", "nccl"]}
    return {k: subprocess.Popen(cmd + a, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k, a in args.items()}


def _tp_launcher_check(torch, procs):
    """The launcher's --tp 2 streams equal --tp 1's; --dist-backend nccl
    on this one card exits nonzero, naming gloo (it does not switch)."""
    got = {k: p.communicate(timeout=TP_TIMEOUT) + (p.returncode,)
           for k, p in procs.items()}
    streams = {}
    for k in ("tp1", "tp2"):
        out, err, rc = got[k]
        for line in out.splitlines():
            log(f"  [serve {k}] {line}")
        assert rc == 0, f"serve {k}: {err[-3000:]}"
        streams[k] = [ln for ln in out.splitlines()
                      if ln.startswith("[launch.serve] streams: ")]
        assert len(streams[k]) == 1, out
    assert streams["tp2"] == streams["tp1"], "launcher tp=2 streams != tp=1"
    out, err, rc = got["nccl"]
    assert rc != 0 and "--dist-backend gloo" in err, err[-2000:]
    log(f"launcher at {TP_LAUNCH_LAYERS} layers, fp32: --tp 2 "
        f"--dist-backend gloo streams == --tp 1; --dist-backend nccl on "
        f"{torch.cuda.device_count()} device(s) refused: "
        f"{err.strip().splitlines()[-1]}")


def _tp_gates(torch, card, ref, ranks, kern):
    """Phase 11's gates on the two ranks' results (``tp_rank``) against
    phases 4 and 5's tp = 1 eager runs (``ref``); returns the phase's
    figures."""
    out = {"kernels": kern}
    for mode in ("compressed", "slided"):
        r0, r1 = ranks[0][mode], ranks[1][mode]
        want = ref[mode]
        assert r0["ok"] and r1["ok"], f"tp {mode}: a request failed"
        assert r0["tokens"] == r1["tokens"], f"tp {mode}: the ranks disagree"
        ties = _tp_divergences(torch, mode, r0, want)
        same = sum(a == b for i, t in want["tokens"].items()
                   for a, b in zip(t, r0["tokens"][i]))
        total = sum(len(t) for t in want["tokens"].values())
        # the logits gate, beside the planted faults
        faults = ranks[0]["compressed"]["faults"]
        read = {"sound": [], "skip_reduce": [], "local_absmax": []}
        for i in want["tokens"]:
            w = want["first"][i].float()
            read["sound"].append(_rel_l2(r0["first"][i], w))
            for f in ("skip_reduce", "local_absmax"):
                read[f].append(_rel_l2(faults[f][i], w))
        worst = {k: max(v) for k, v in read.items()}
        least = {k: min(v) for k, v in read.items()}
        log(f"tp {mode}: {same}/{total} tokens identical to tp = 1, "
            f"{ties} divergent requests (each a tie); last-prefill logits "
            f"vs tp = 1, relative L2: sound worst {worst['sound']:.3e}, "
            f"planted faults (least) skip_reduce "
            f"{least['skip_reduce']:.3e}, local_absmax "
            f"{least['local_absmax']:.3e}; limit {TP_RL2}")
        assert worst["sound"] <= TP_RL2, (mode, read)
        for f in ("skip_reduce", "local_absmax"):
            assert least[f] > TP_RL2, \
                f"tp {mode}: planted fault {f} passes the gate: {read[f]}"
        mine = "compressed_matmul" if mode == "compressed" \
            else "fused_slided_matmul"
        other = "fused_slided_matmul" if mode == "compressed" \
            else "compressed_matmul"
        for r, rk in enumerate((r0, r1)):
            la = rk["launches"]
            assert la[mine] > 0 and la["paged_attention"] > 0, (r, la)
            assert la[other] == 0, (r, la)
            if mode == "slided":
                # every wo and w_down: 48 of a decode step's 169 linears
                assert rk["act_absmax"] > 0, (r, rk["act_absmax"])
                assert rk["act_absmax"] * sum(STEP_COUNTS.values()) == \
                    48 * la[mine], (r, rk["act_absmax"], la)
            else:
                assert rk["act_absmax"] == 0, (r, rk)
            assert 0.45 < rk["shard"] / rk["full"] < 0.55, (r, rk["shard"])
            assert rk["heads"] == [4], rk["heads"]
            assert rk["balanced"], f"rank {r} {mode}: pages do not balance"
            assert set(rk["captures"].values()) == {0}, rk["captures"]
            assert r0["per_step"] == rk["per_step"]
        out[mode] = {"tok_s": r0["tok_s"], "launches": r0["launches"],
                     "act_absmax": r0["act_absmax"],
                     "per_step": sorted(set(r0["per_step"])),
                     "mem": [rk["mem"] for rk in (r0, r1)],
                     "shard": r0["shard"], "full": r0["full"],
                     "read": worst, "least": least, "ties": ties}
        log(f"tp {mode}: tp = 2 eager decode {r0['tok_s']:.2f} tok/s "
            f"({r0['tok_s_per_device']:.2f} per device) vs tp = 1 eager "
            f"{want['eager_tok_s']:.2f} tok/s; collectives per decode step "
            f"{sorted(set(r0['per_step']))} (+1 gathering the logits rows "
            f"here); device memory with both engines loaded "
            f"{r0['mem'] / 1e9:.2f} / {r1['mem'] / 1e9:.2f} GB (linears "
            f"{r0['shard'] / 1e9:.3f} of "
            f"{r0['full'] / 1e9:.3f} GB); launches {r0['launches']}, B3 "
            f"given act_absmax {r0['act_absmax']} ({card})")
    c, s = ranks[0]["compressed"], ranks[0]["slided"]
    same = c["tokens"] == s["tokens"] and all(
        torch.equal(s["first"][i], v) for i, v in c["first"].items())
    log(f"tp = 2 slided == compressed (streams and first logits bit for "
        f"bit): {same}")
    return out


def phase_tp(torch, card, ref, timer):
    """Phase 11: tensor-parallel serving on the card.  The kernels at the
    shard shapes (``_tp_kernels``); then two gloo ranks sharing cuda:0
    (``tp_rank``) serve phase 5's traffic with phase 4's weights at
    tp = 2, compressed and slided, eager; their streams must agree, equal
    phases 4 and 5's tp = 1 eager streams (or diverge only at a tie), and
    their last-prefill logits pass TP_RL2 against tp = 1's beside two
    planted faults that must not; B1 (compressed), B3 with its act_absmax
    instance (slided) and B2 must launch in run(); each rank's linears
    are half of tp = 1's, its pools hold 4 KV heads and its pages
    balance.  Then the launcher's check (``_tp_launcher_start``)."""
    import gc
    import os
    import tempfile
    from repro_torch.sharding import dist as tdist

    t0 = time.time()
    log("== tensor parallelism: the kernels at one rank's shard shapes ==")
    kern = _tp_kernels(torch, timer)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== tensor parallelism: h2o-danube-3-4b 24L d3840 at tp = 2, two "
        f"gloo ranks on one card, 6:8 compressed and slided int8, eager; "
        f"device memory here {torch.cuda.memory_allocated() / 1e9:.2f} GB ==")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as root:
        texts = tdist.launch(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.tp_rank(sys.argv[1]))", root], TP,
            env=env, cwd=ROOT, timeout=TP_TIMEOUT)
        for r, text in enumerate(texts):
            for line in text.splitlines():
                log(f"  [rank {r}] {line}")
        ranks = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
                 for r in range(TP)]
    out = _tp_gates(torch, card, ref, ranks, kern)
    # after the ranks, so nothing else shares the card while they are timed
    launcher = _tp_launcher_start()
    try:
        _tp_launcher_check(torch, launcher)
    finally:
        for proc in launcher.values():  # stopped on any failure above
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.time() - t0
    log(f"phase 11 (tensor parallelism): {out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------- phase 12
# (a) h2o-danube-3-4b at full width, depth cut to MESH_LAYERS, STE-masked
# 6:8, bf16, AdamW with int8 moments (a 2.2 GB checkpoint for (d), not
# the 5.6 GB fp32 moments would make), the launcher's 8 x 256 tokens,
# MESH_STEPS steps, over (data 2, model 2): four gloo ranks on the card
MESH_LAYERS, MESH_STEPS, MESH_LR = 2, 3, 3e-3
MESH_RANKS, MESH_SHAPE = 4, (2, 2)
MESH_WARM = 100                # the direct step's counter: rate scale 1
# (a) gates, sharded vs single device in bf16: a sound step differs by
# the rounding of half-batch bf16 gradients summed in fp32, a planted
# fault by a whole gradient.  On an H100 80GB HBM3 (700 W) the sound run
# read: losses 2.9e-5 relative (the -1 batch's 8.8e-8), params after
# three steps 3.2e-4 (worst leaf), gradients 0.0106 (worst leaf); the
# faults' gradients 0.493 (one rank skips the data-parallel sum) and
# 0.317 (mean of the local means).  The gradient gate sits near the
# geometric mean of 0.0106 and 0.317
MESH_LOSS_RTOL = 1e-3          # each of the three losses, and the -1 batch's
MESH_PARAM_RL2 = 3e-3          # worst leaf after three steps
MESH_GRAD_RL2 = 5e-2           # worst leaf of the -1 batch's gradients
# (b) GPipe at fp32 (TF32 off) vs the sequential run of the same blocks
# on the whole batch (read 2.2e-6 and 5.7e-6 on the H100)
GPIPE_OUT_RL2, GPIPE_GRAD_RL2 = 1e-5, 1e-4
GPIPE_STAGES, GPIPE_MICRO, GPIPE_MB = 4, 4, 2
COMP_SHAPE = (10240, 3840)     # (c) one w_gate / w_up gradient leaf
MESH_TIMEOUT = 600


def _mesh_setup(setup):
    """The phase's config, global batch, sequence and compression shape:
    full width on the card; ``setup["smoke"]`` shrinks them for a
    rehearsal on CPU ranks."""
    from repro_torch.configs import registry
    if setup.get("smoke"):
        return (_masked(registry.smoke_config("h2o-danube-3-4b")), 8, 32,
                (64, 96))
    return _full(MESH_LAYERS), TRAIN_BATCH, TRAIN_SEQ, COMP_SHAPE


def _mesh_opt():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=MESH_LR, state_dtype="int8")


def _minus_one_batch(torch, cfg, b, s, device):
    """A global batch whose -1 labels fall unevenly on the two data
    slices (rows 0-3, 4-7): all of row 0, most of row 1, three of row 5."""
    from repro_torch.data.pipeline import SyntheticLM
    nb = SyntheticLM(cfg, b, s, seed=0, host_index=0,
                     host_count=1).batch_at(7)
    batch = {k: torch.from_numpy(v.copy()).to(device) for k, v in nb.items()}
    batch["labels"][0] = -1
    batch["labels"][1, s // 8:] = -1
    batch["labels"][5, :3] = -1
    return batch


def _mesh_reference(torch, setup, root):
    """The single-device side of (a), in this process (no process group,
    so the pipeline builds the global batch): ``train_loop.train`` for
    MESH_STEPS steps from seed 0, and the -1 batch's loss and gradients
    at the seed-0 init.  Saved for rank 0 to compare with."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.runtime import steps, train_loop
    cfg, b, s, _ = _mesh_setup(setup)
    dev = torch.device(setup["device"])
    t0 = time.time()
    run = train_loop.train(cfg, _mesh_opt(), train_loop.TrainConfig(
        steps=MESH_STEPS, global_batch=b, seq_len=s, seed=0, log_every=0),
        device=dev)
    ref = {"losses": run["losses"], "step_s": run["step_seconds"],
           "params": [x.detach().cpu() for x in tree.leaves(run["params"])]}
    del run
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = steps.trainable(params)
    loss = M.loss_fn(params, cfg, _minus_one_batch(torch, cfg, b, s, dev))
    ref["grads"] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    ref["loss_m1"] = float(loss.detach())
    torch.save(ref, f"{root}/ref.pt")
    log(f"(a) single device, {MESH_STEPS} steps: losses "
        f"{[round(x, 5) for x in ref['losses']]}, step s "
        f"{[round(x, 3) for x in ref['step_s']]}; the -1 batch's loss "
        f"{ref['loss_m1']:.5f}; {time.time() - t0:.1f} s")


def _replica(mesh, spec) -> float:
    """1.0 on the one rank that counts a piece of ``spec`` (coordinate 0
    on every axis the piece is replicated over), else 0.0."""
    from repro_torch.sharding import rules
    sharded = {a for d in spec for a in rules.axes_of(d)}
    return float(all(mesh.coord(a) == 0 for a in mesh.axis_names
                      if a not in sharded))


def _mesh_rl2(torch, pieces, specs, mesh, wholes):
    """The worst leaf's relative L2 between the whole leaves whose pieces
    this rank holds and whole references (host tensors), with no gather:
    each rank sums over its piece against the same cut of the reference
    (one replica of each piece counting), then one all-reduce."""
    from repro_torch.sharding import rules
    sums = []
    for x, sp, w in zip(pieces, specs, wholes):
        ref = rules.cut(w, sp, mesh).to(mesh.device, torch.float64)
        diff = x.detach().to(torch.float64) - ref
        sums.append(torch.stack([(diff * diff).sum(), (ref * ref).sum()])
                    * _replica(mesh, sp))
    tot = mesh.all_reduce(torch.stack(sums), mesh.axis_names, "sum")
    return float((tot[:, 0] / tot[:, 1]).sqrt().max())


FP_PRIME = 2 ** 31 - 1


def _fingerprints(torch, pieces, specs, mesh):
    """An exact checksum of each whole leaf from this rank's pieces, the
    same on any mesh: the sum over the leaf's elements of bits x (2 x flat
    index + 1) modulo the prime 2^31 - 1 (products and sums stay inside
    int64), one replica of each piece counting, summed over the ranks.
    One element that differs always changes it."""
    from repro_torch.sharding import rules
    out = []
    for x, sp in zip(pieces, specs):
        whole = rules.global_shape(x.shape, sp, mesh)
        idx = torch.zeros((), dtype=torch.int64, device=x.device)
        stride = 1
        for d in reversed(range(x.dim())):
            ar = torch.arange(x.shape[d], dtype=torch.int64, device=x.device)
            ar = (ar + rules.offset(sp, d, whole[d], mesh)) * stride
            idx = idx + ar.view((-1,) + (1,) * (x.dim() - 1 - d))
            stride *= whole[d]
        bits = _bits(torch, x).view(x.shape).to(torch.int64) % FP_PRIME
        w = (2 * idx + 1) % FP_PRIME
        out.append((bits * w % FP_PRIME).sum() * int(_replica(mesh, sp)))
    tot = mesh.all_reduce(torch.stack(out), mesh.axis_names, "sum")
    return [int(v) % FP_PRIME for v in tot.tolist()]


def _mesh_direct(torch, cfg, mesh, params, lay, batch, ref, fault):
    """One sharded step's loss and gradients on the -1 batch, sound or
    under a planted fault: one rank skips the data-parallel gradient sum
    (its collectives still run), or the loss is the mean of the local
    means.  Read against the single device's on every rank (the
    gradients' sums all-reduced, no gather)."""
    from repro_torch.runtime import steps
    from repro_torch.sharding import rules
    orig_rg, orig_w = steps.reduce_grad, steps.loss_weight
    if fault == "skip_dp_sum":
        def faulty(g, spec, m):
            out = orig_rg(g, spec, m)
            if m.rank == 1:
                return rules.cut(g.float(), spec, m) * m.axis_size("data")
            return out
        steps.reduce_grad = faulty
    elif fault == "mean_of_means":
        steps.loss_weight = lambda count, total: torch.tensor(
            1.0 / mesh.axis_size("data"), device=mesh.device)
    try:
        local = {k: rules.cut(v, rules.batch_spec(v, mesh), mesh)
                 for k, v in batch.items()}
        loss, grads = steps.sharded_grads(cfg, params, local, lay)
    finally:
        steps.reduce_grad, steps.loss_weight = orig_rg, orig_w
    return {"loss_rel": abs(float(loss) - ref["loss_m1"]) / abs(
        ref["loss_m1"]), "grad_rl2": _mesh_rl2(torch, grads, lay.params,
                                               mesh, ref["grads"])}


def _mesh_train(torch, setup, root, dev):
    """(a) ``train(mesh=...)`` over (data 2, model 2) beside the single
    device's run; the direct step on the -1 batch and its two planted
    faults.  Every rank returns the readings (all-reduced) and its own
    bytes."""
    import math
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.runtime import train_loop
    from repro_torch.sharding import ctx, rules
    cfg, b, s, _ = _mesh_setup(setup)
    mesh = ctx.Mesh(MESH_SHAPE, ("data", "model"), device=dev)
    marks = [(0, 0)]
    ctx.reset_counts()
    run = train_loop.train(cfg, _mesh_opt(), train_loop.TrainConfig(
        steps=MESH_STEPS, global_batch=b, seq_len=s, seed=0, log_every=1,
        ckpt_dir=f"{root}/ckpt", ckpt_every=MESH_STEPS), mesh=mesh,
        hooks={"on_step": lambda st, l: marks.append(
            (ctx.collective_count(), ctx.wire_bytes()))})
    lay = run["layout"]
    state = {"opt": run["opt_state"], "params": run["params"]}
    out = {"resident": rules.resident_bytes(state),
           "logical": sum(math.prod(rules.global_shape(x.shape, sp, mesh))
                          * x.element_size() for x, sp in
                          zip(tree.leaves(state), lay.state)),
           "losses": run["losses"], "step_s": run["step_seconds"],
           "collectives": [q[0] - p[0] for p, q in zip(marks, marks[1:])],
           "wire": [q[1] - p[1] for p, q in zip(marks, marks[1:])]}
    log(f"rank {mesh.rank}: params + AdamW state {out['resident'] / 1e9:.4f}"
        f" GB resident of the logical {out['logical'] / 1e9:.4f} GB "
        f"({out['resident'] / out['logical']:.4f}); step s "
        f"{[round(x, 3) for x in out['step_s']]}; collectives a step "
        f"{out['collectives']}, bytes handed to them "
        f"{[round(x / 1e9, 4) for x in out['wire']]} GB (the last step's "
        f"with the checkpoint's gathers)")
    out["fingerprints"] = _fingerprints(torch, tree.leaves(state),
                                        lay.state, mesh)
    # every rank reads the single device's results (mapped, each cutting
    # its pieces' share)
    ref = torch.load(f"{root}/ref.pt", mmap=True)
    out["param_rl2"] = _mesh_rl2(torch, tree.leaves(run["params"]),
                                 lay.params, mesh, ref["params"])
    out["ref_losses"], out["ref_step_s"] = ref["losses"], ref["step_s"]
    del run, state
    params0 = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    params, _, lay0 = train_loop._sharded_init(params0, _mesh_opt(), mesh)
    del params0
    batch = _minus_one_batch(torch, cfg, b, s, dev)
    out["direct"] = {f or "sound": _mesh_direct(torch, cfg, mesh, params,
                                                lay0, batch, ref, f)
                     for f in (None, "skip_dp_sum", "mean_of_means")}
    return out


def _mesh_gpipe(torch, setup, dev):
    """(b) ``gpipe_apply`` over (stage 4): one danube block a stage, fp32,
    GPIPE_MICRO microbatches of GPIPE_MB x S tokens, loss mean(out^2);
    rank 0 runs the four blocks in sequence on the whole batch and holds
    the output and every stage's gradients against it."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.models import model as M, transformer
    from repro_torch.runtime import pipeline
    from repro_torch.sharding import ctx
    cfg, _, s, _ = _mesh_setup(setup)
    cfg = dataclasses.replace(cfg, num_layers=GPIPE_STAGES, dtype="float32")
    mesh = ctx.Mesh((GPIPE_STAGES,), ("stage",), device=dev)
    units = M.init(cfg, torch.Generator(device=dev).manual_seed(1))["units"]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((GPIPE_MICRO * GPIPE_MB, s, cfg.d_model), generator=gen,
                    device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]

    def stage_fn(p, h):
        return transformer._unit(cfg, p, h, pos.expand(h.shape[0], s))

    stage = mesh.coord("stage")
    piece = tree.tree_map(lambda a: a[None].clone().requires_grad_(True),
                          units[stage])
    torch.cuda.synchronize() if dev.type == "cuda" else None
    t0 = time.time()
    out = pipeline.gpipe_apply(stage_fn, piece, x, mesh=mesh, axis="stage",
                               microbatches=GPIPE_MICRO)
    grads = torch.autograd.grad((out ** 2).mean(), tree.leaves(piece))
    torch.cuda.synchronize() if dev.type == "cuda" else None
    seconds = time.time() - t0
    whole = [mesh.all_gather(g, "stage", 0) for g in grads]
    if mesh.rank != 0:
        return None
    leaves = [tree.leaves(u) for u in units]
    for u in leaves:
        for p in u:
            p.requires_grad_(True)
    h = x
    for u in units:
        h = stage_fn(u, h)
    ref = torch.autograd.grad((h ** 2).mean(), [p for u in leaves for p in u])
    n = len(leaves[0])
    grad_rl2 = max(_rel_l2(whole[i][st], ref[st * n + i])
                   for st in range(GPIPE_STAGES) for i in range(n))
    res = {"out_rl2": _rel_l2(out.detach(), h.detach()),
           "grad_rl2": grad_rl2, "seconds": seconds,
           "bubble": pipeline.bubble_fraction(GPIPE_STAGES, GPIPE_MICRO)}
    log(f"(b) GPipe, {GPIPE_STAGES} stages x one block, {GPIPE_MICRO} "
        f"microbatches of {GPIPE_MB} x {s}, fp32: output rel. L2 "
        f"{res['out_rl2']:.3g} (gate {GPIPE_OUT_RL2}), worst gradient leaf "
        f"{grad_rl2:.3g} (gate {GPIPE_GRAD_RL2}) vs the sequential run; "
        f"forward + backward {seconds:.3f} s; bubble fraction "
        f"{res['bubble']:.4f}")
    assert res["out_rl2"] <= GPIPE_OUT_RL2, res
    assert grad_rl2 <= GPIPE_GRAD_RL2, res
    return res


def _mesh_compression(torch, setup, dev):
    """(c) ``compressed_crosspod_mean`` over (pod 2, data 2) of one
    gradient leaf, a different draw on each pod: every rank recomputes
    both pods' quantization itself and holds the mean (bit for bit) and
    its residual; the mean within JAX's test bound of the exact mean."""
    from repro_torch.runtime import compression
    from repro_torch.sharding import ctx
    _, _, _, shape = _mesh_setup(setup)
    mesh = ctx.Mesh((2, 2), ("pod", "data"), device=dev)

    def draw(pod):
        gen = torch.Generator(device=dev).manual_seed(100 + pod)
        return torch.randn(shape, generator=gen, device=dev)

    g = draw(mesh.coord("pod"))
    ctx.reset_counts()
    torch.cuda.synchronize() if dev.type == "cuda" else None
    t0 = time.time()
    mean, err = compression.compressed_crosspod_mean(g, torch.zeros_like(g),
                                                     mesh)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    seconds, wire = time.time() - t0, ctx.wire_bytes()
    deq = []
    for pod in range(2):
        q, sc = compression._quant_block(draw(pod))
        deq.append(compression._dequant_block(q, sc, shape))
    want = (deq[0] + deq[1]) / 2
    exact = (draw(0) + draw(1)) / 2
    rms = float(((mean - exact) ** 2).mean().sqrt() / exact.std())
    assert torch.equal(mean, want), "the pods' mean is not the local one"
    assert torch.equal(err, g - deq[mesh.coord("pod")]), "residual"
    assert rms < 0.05, rms
    res = {"wire_bytes": wire, "fp32_bytes": g.numel() * 4,
           "seconds": seconds, "rms_vs_exact": rms}
    if mesh.rank == 0:
        log(f"(c) cross-pod int8 mean of a {list(shape)} fp32 leaf over "
            f"(pod 2, data 2): {wire} bytes on the wire a rank (int8 "
            f"blocks + fp32 scales; fp32 would be {res['fp32_bytes']}), "
            f"{seconds:.3f} s; == the local recomputation bit for bit; "
            f"rms vs the exact mean / its std {rms:.4g}")
    return res


def mesh_rank(root: str, setup_json: str) -> int:
    """One of phase 12's four ranks (``phase_mesh`` starts them, all on
    cuda:0, over gloo): (a) ``_mesh_train``, (b) ``_mesh_gpipe``, (c)
    ``_mesh_compression``; B1-B5 must launch no time.  Rank 0 checks
    (a)'s gates and writes ``mesh.json`` under ``root``."""
    import gc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sharding import dist as tdist
    setup = json.loads(setup_json)
    rank, _ = tdist.init("gloo")
    dev = tdist.device_for(None if setup["device"] == "cuda"
                           else setup["device"])
    before = ops.launch_counts()
    t0 = time.time()
    out = {"train": _mesh_train(torch, setup, root, dev)}
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    out["gpipe"] = _mesh_gpipe(torch, setup, dev)
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    out["compression"] = _mesh_compression(torch, setup, dev)
    assert ops.launch_counts() == before, "a B1-B5 kernel ran in phase 12"
    out["seconds"] = time.time() - t0
    # every rank's bytes and collectives, which phase 13's dry run of
    # this configuration must equal rank for rank
    with open(f"{root}/counts{rank}.json", "w") as f:
        json.dump({k: out["train"][k] for k in
                   ("resident", "collectives", "wire")}, f)
    if rank != 0:
        return 0
    a = out["train"]
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(a["losses"], a["ref_losses"]))
    d = a["direct"]
    log(f"(a) train(mesh=(data 2, model 2)) vs single device: losses "
        f"{[round(x, 5) for x in a['losses']]} vs "
        f"{[round(x, 5) for x in a['ref_losses']]} (worst relative "
        f"{loss_rel:.3g}, gate {MESH_LOSS_RTOL}); params after "
        f"{MESH_STEPS} steps, worst leaf rel. L2 {a['param_rl2']:.3g} (gate "
        f"{MESH_PARAM_RL2}); the -1 batch's step: loss relative "
        f"{d['sound']['loss_rel']:.3g}, gradients worst leaf "
        f"{d['sound']['grad_rl2']:.3g} (gate {MESH_GRAD_RL2}); planted "
        f"faults, gradients / loss: skip the data-parallel sum "
        f"{d['skip_dp_sum']['grad_rl2']:.3g} / "
        f"{d['skip_dp_sum']['loss_rel']:.3g}, mean of local means "
        f"{d['mean_of_means']['grad_rl2']:.3g} / "
        f"{d['mean_of_means']['loss_rel']:.3g}")
    assert loss_rel <= MESH_LOSS_RTOL, (a["losses"], a["ref_losses"])
    assert a["param_rl2"] <= MESH_PARAM_RL2, a["param_rl2"]
    assert d["sound"]["loss_rel"] <= MESH_LOSS_RTOL, d["sound"]
    assert d["sound"]["grad_rl2"] <= MESH_GRAD_RL2, d["sound"]
    # each planted fault must fail the comparison (its gradients; the
    # mean of means moves the loss too, but near init every row's loss is
    # near ln V, so that reading alone would be weak)
    assert d["skip_dp_sum"]["grad_rl2"] > MESH_GRAD_RL2, d
    assert d["mean_of_means"]["grad_rl2"] > MESH_GRAD_RL2, d
    with open(f"{root}/mesh.json", "w") as f:
        json.dump(out, f)
    return 0


def mesh_restore_rank(root: str, setup_json: str) -> int:
    """(d) One of two ranks: restore (a)'s checkpoint onto
    ``elastic_mesh`` over two ranks (data 1, model 2), through
    ``checkpointer.restore`` given the mesh and through a host restore +
    ``elastic.reshard``; every leaf's fingerprint must be (a)'s final
    state's.  Rank 0 writes ``restore.json``."""
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.models import model as M
    from repro_torch.runtime import elastic, train_loop
    from repro_torch.sharding import dist as tdist, rules
    setup = json.loads(setup_json)
    rank, _ = tdist.init("gloo")
    dev = tdist.device_for(None if setup["device"] == "cuda"
                           else setup["device"])
    cfg, _, _, _ = _mesh_setup(setup)
    t0 = time.time()
    mesh = elastic.elastic_mesh(prefer_model=2, device=dev)
    whole = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    params, opt_state, lay = train_loop._sharded_init(whole, _mesh_opt(),
                                                      mesh)
    del whole
    state, step, _ = ckpt.restore(f"{root}/ckpt",
                                  {"params": params, "opt": opt_state},
                                  specs=lay.state, mesh=mesh)
    # the elastic path: whole host arrays, then this rank's pieces
    like = tree.unflatten(state, [
        torch.empty(rules.global_shape(x.shape, sp, mesh), dtype=x.dtype,
                    device="meta")
        for x, sp in zip(tree.leaves(state), lay.state)])
    host = ckpt.restore(f"{root}/ckpt", like, device="cpu")[0]
    resharded = elastic.reshard(host["params"], mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(resharded), tree.leaves(state["params"]))), \
        "elastic.reshard != restore onto the mesh"
    del host, resharded
    prints = _fingerprints(torch, tree.leaves(state), lay.state, mesh)
    seconds = time.time() - t0
    if rank == 0:
        with open(f"{root}/restore.json", "w") as f:
            json.dump({"fingerprints": prints, "step": step,
                       "shape": mesh.shape, "seconds": seconds}, f)
    return 0


def phase_mesh(torch, card, setup=None):
    """Phase 12: multi-device training.  The single device's side of (a)
    here (``_mesh_reference``); four gloo ranks sharing the card
    (``mesh_rank``: (a) train over (data 2, model 2) beside two planted
    faults, (b) GPipe over 4 stages, (c) the cross-pod int8 mean); then
    two ranks restore (a)'s checkpoint (``mesh_restore_rank``, (d)), its
    leaves bit-equal to (a)'s final state."""
    import gc
    import os
    import tempfile
    from repro_torch.sharding import dist as tdist
    setup = setup or {"device": "cuda"}
    t0 = time.time()
    gc.collect()
    if setup["device"] == "cuda":
        torch.cuda.empty_cache()
    log(f"== multi-device training: h2o-danube-3-4b d3840 at "
        f"{MESH_LAYERS} layers, masked 6:8, bf16, int8 AdamW moments, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {MESH_RANKS} gloo ranks on "
        f"one card ==")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    arg = json.dumps(setup)
    with tempfile.TemporaryDirectory() as root:
        _mesh_reference(torch, setup, root)
        gc.collect()
        if setup["device"] == "cuda":
            torch.cuda.empty_cache()
        for fn, n in (("mesh_rank", MESH_RANKS),
                      ("mesh_restore_rank", 2)):
            t1 = time.time()
            texts = tdist.launch(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 f"sys.exit(chip_smoke.{fn}(sys.argv[1], sys.argv[2]))",
                 root, arg], n, env=env, cwd=ROOT, timeout=MESH_TIMEOUT)
            for r, text in enumerate(texts):
                for line in text.splitlines():
                    log(f"  [{fn} {r}] {line}")
            log(f"  {fn} x {n}: {time.time() - t1:.1f} s")
        with open(f"{root}/mesh.json") as f:
            out = json.load(f)
        with open(f"{root}/restore.json") as f:
            out["restore"] = json.load(f)
        out["ranks"] = []
        for r in range(MESH_RANKS):
            with open(f"{root}/counts{r}.json") as f:
                out["ranks"].append(json.load(f))
    a, d = out["train"], out["restore"]
    assert d["step"] == MESH_STEPS and d["shape"] == {"data": 1, "model": 2}
    assert d["fingerprints"] == a["fingerprints"], \
        "restore onto 2 ranks != (a)'s state"
    log(f"(d) (a)'s checkpoint restored onto (data 1, model 2): "
        f"{len(d['fingerprints'])} leaves' exact checksums equal (a)'s final "
        f"state's, and "
        f"elastic.reshard of the host arrays == restore onto the mesh; "
        f"{d['seconds']:.1f} s")
    out["seconds"] = time.time() - t0
    log(f"phase 12 (multi-device training): {out['seconds']:.1f} s ({card})")
    return out


def report_mesh(mesh, card):
    a, b, c = mesh["train"], mesh["gpipe"], mesh["compression"]
    d = a["direct"]
    log(f"multi-device training (phase 12): rank 0 holds "
        f"{a['resident'] / 1e9:.4f} GB of params + AdamW state of the "
        f"logical {a['logical'] / 1e9:.4f} GB; step s "
        f"{[round(x, 3) for x in a['step_s']]} (single device "
        f"{[round(x, 3) for x in a['ref_step_s']]}); collectives a step "
        f"{a['collectives']}, GB handed to them "
        f"{[round(x / 1e9, 4) for x in a['wire']]}; gradients vs one device "
        f"{d['sound']['grad_rl2']:.3g}, faults "
        f"{d['skip_dp_sum']['grad_rl2']:.3g} / "
        f"{d['mean_of_means']['grad_rl2']:.3g}; GPipe fwd + bwd "
        f"{b['seconds']:.3f} s; int8 cross-pod bytes {c['wire_bytes']} "
        f"in {c['seconds']:.3f} s; phase 12 {mesh['seconds']:.1f} s ({card})")


# ---------------------------------------------------------------- phase 13
TUNE_RS = (4, PREFILL_CHUNK)   # the decode step's rows and a prefill chunk
DRY_PEAK_RTOL = 0.2            # the dry run's peak vs phase 10's measured
DRY_TIMEOUT = 600
PHASE13_S = 90                 # the phase's budget on the card
# the tuner's cache file, read back in a child process
READ_TILES = ("import dataclasses, json, sys; "
              "from repro_torch.kernels import autotune; "
              "print('TILES ' + json.dumps({k: (lambda t: t and "
              "dataclasses.asdict(t))(autotune.lookup(k)) "
              "for k in json.loads(sys.argv[1])}))")


def dry_cell(kind: str, setup_json: str = '{"device": "cuda"}') -> int:
    """One of phase 13's dry runs, in a child process (fake tensors, no
    device memory), printed as ``DRY <json>``: ``launcher`` is phase 10's
    ``launch.train`` configuration on one device, ``mesh`` phase 12's on
    a dry (data 2, model 2) mesh as each of its ranks, ``production``
    h2o-danube-3-4b train_4k on 16x16 (``setup["smoke"]``: the smoke
    configurations, for a rehearsal on the CPU)."""
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw
    setup = json.loads(setup_json)
    device = None if setup["device"] == "cuda" else setup["device"]
    t0 = time.time()
    cfg, b, s, _ = _mesh_setup(setup)
    if kind == "launcher":
        if not setup.get("smoke"):
            cfg = _full()
        rec = dryrun.train_step_dry(cfg, adamw.AdamWConfig(lr=TRAIN_LR), b,
                                    s, device=device)
        out = {k: rec[k] for k in ("peak_bytes", "resident_bytes")}
    elif kind == "mesh":
        out = [{k: rec[k] for k in ("resident_bytes", "collective_count",
                                    "wire_bytes", "peak_bytes")}
               for rec in (dryrun.train_step_dry(
                   cfg, _mesh_opt(), b, s,
                   dict(zip(("data", "model"), MESH_SHAPE)), rank=r,
                   device=device) for r in range(MESH_RANKS))]
    else:
        out = dryrun.run_cell("h2o-danube-3-4b", "train_4k", False,
                              verbose=False)
    print("DRY " + json.dumps({"seconds": time.time() - t0, "out": out}),
          flush=True)
    return 0


def _dry_start(kinds, setup):
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    return {kind: subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         "chip_smoke.dry_cell(sys.argv[1], sys.argv[2]))", kind,
         json.dumps(setup)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for kind in kinds}


def _dry_collect(procs):
    out = {}
    for kind, proc in procs.items():
        text, _ = proc.communicate(timeout=DRY_TIMEOUT)
        assert proc.returncode == 0, f"dry run {kind}:\n{text[-4000:]}"
        out[kind] = json.loads(next(
            line for line in text.splitlines()
            if line.startswith("DRY "))[4:])
    return out


def dry_vs_mesh(dry, ranks):
    """Phase 12's configuration, dry, against what its ranks counted: a
    rank's resident bytes equal; its collectives and the bytes handed to
    them equal the first step's and, with the loop's preemption check (a
    4-byte flag all-reduced over both axes: 2 collectives, 8 bytes), the
    second step's."""
    assert len(dry) == len(ranks) == MESH_RANKS
    for r, (d, m) in enumerate(zip(dry, ranks)):
        assert d["resident_bytes"] == m["resident"], (r, d, m)
        assert d["collective_count"] == m["collectives"][0], (r, d, m)
        assert d["collective_count"] + 2 == m["collectives"][1], (r, d, m)
        assert d["wire_bytes"] == m["wire"][0], (r, d, m)
        assert d["wire_bytes"] + 8 == m["wire"][1], (r, d, m)
    log(f"dry run of phase 12's configuration on a dry (data 2, model 2) "
        f"mesh, rank for rank: resident bytes "
        f"{[d['resident_bytes'] for d in dry]}, collectives a step "
        f"{[d['collective_count'] for d in dry]}, bytes handed to them "
        f"{[d['wire_bytes'] for d in dry]}, each equal to what phase 12's "
        f"ranks counted (steps 1 and 2, the loop's preemption check apart)")


def _tuned_entry(torch, timer, autotune, label, call, kern, plain, exact):
    """Tune one call (``call(tune)`` through ``kernels.ops``), then hold
    the winner's output to the heuristic's and to the plain version (bit
    for bit where ``exact``, else within 2^-7 of max|plain|) and time the
    two in turns.  Returns the printed row."""
    keys = set(autotune._MEM)
    call(True)
    (key,) = set(autotune._MEM) - keys
    entry, win = autotune._MEM[key], autotune.lookup(key)
    knob = win.splits if win.splits is not None else win.br
    y_w, y_h, y_p = kern(knob), kern(None), plain(knob)
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(y_w, y_h) and torch.equal(y_w, y_p), \
            f"{label}: the tuned split's output differs"
    else:
        scale = y_p.float().abs().max().item()
        for y in (y_w, y_h):
            err = (y.float() - y_p.float()).abs().max().item()
            assert err <= 2 ** -7 * scale, (label, err, scale)
    assert torch.equal(call(False), y_w), f"{label}: ops != the winner"
    assert entry["efficiency"] <= 1.0, (label, entry)
    t_w, t_h = timer.rounds([lambda: kern(knob), lambda: kern(None)])
    log(f"{label} | {knob} | {entry['us']:.2f} | {1e3 * t_w:.2f} "
        f"{1e3 * t_h:.2f} | {entry['roofline_us']:.2f} "
        f"{entry['efficiency']:.4f} | {entry['why']}")
    return {"label": label, "winner": knob, "us": entry["us"],
            "turns_us": [1e3 * t_w, 1e3 * t_h],
            "roofline_us": entry["roofline_us"],
            "efficiency": entry["efficiency"]}


def _tune_kernels(torch, timer):
    """B1 and B3 (int8) at danube's five linear shapes x TUNE_RS, B2 at
    phase 3's decode geometry, each tuned through ``kernels.ops`` as the
    engine calls it (bf16 activations and outputs); B2's verify rows at
    the tuned split bit-equal to decode calls."""
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import fused_slide_matmul as fsm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import slide_matmul as smm

    log("tuned entry | winner | tuned us | winner us heuristic us (in "
        "turns, L2 flushed) | roofline_us efficiency | why")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, keep = [], None
    for name, mode in (("B1", "compressed"), ("B3", "slided")):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode=mode, recipe="int8")
        rec, dec = cfg.recipe, cfg.decomposition()
        for m, k in SHAPES:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            for r in TUNE_RS:
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                if name == "B1":
                    c = CompressedSlided(p["values"], p["indices"], k, 6, 8,
                                         2, 4)
                    qx = rec.quantize_act(x)

                    def call(tune, x=x, c=c, p=p):
                        return ops.compressed_matmul(
                            x, c, s_w=p["s_w"], recipe=rec, tune=tune)

                    def kern(splits, qx=qx, c=c, p=p):
                        return smm.compressed_matmul_cuda(
                            qx.q, c.values, c.indices, qx.scale, p["s_w"],
                            n_fam=4, out_dtype=torch.bfloat16, splits=splits)

                    def plain(_, qx=qx, c=c, p=p):
                        return ref.compressed_matmul_dequant(
                            qx.q, qx.scale, c, p["s_w"], torch.bfloat16)
                else:
                    def call(tune, x=x, p=p):
                        return ops.slided_matmul_quant(
                            x, p["sp_values"], p["sp_meta"], p["s_w"], dec,
                            recipe=rec, out_dtype=torch.bfloat16, tune=tune)

                    def kern(splits, x=x, p=p):
                        return fsm.fused_slided_matmul_cuda(
                            x, p["sp_values"], p["sp_meta"], p["s_w"],
                            n_fam=4, out_dtype=torch.bfloat16, splits=splits)

                    def plain(_, x=x, p=p):
                        return ref.slided_matmul_sparse(
                            x, p["sp_values"], p["sp_meta"], p["s_w"], dec,
                            rec, torch.bfloat16)
                rows.append(_tuned_entry(torch, timer, autotune,
                                         f"{name} {m}x{k} R={r}", call, kern,
                                         plain, True))
            if name == "B3" and (m, k) == SHAPES[0]:
                keep = (p, dec, rec)
            del w, p

    # B2 at phase 3's decode geometry, the table allocated for 3 more
    # tokens a row (the verify lanes)
    h, kvh, hd, ps, num_pages = 32, 8, 120, 16, 320
    kv_len, b = [1000, 517, 77, 260], 4
    maxp = -(-(max(kv_len) + 3) // ps) + 2
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
    used = 0
    for i, n_tok in enumerate(kv_len):
        n = -(-(n_tok + 3) // ps)
        table[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    pool = {n_: torch.randn((num_pages, ps, kvh, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            for n_ in ("k", "v")}
    q = torch.randn((b, 1, h, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    heur = pa.splits_for(b, kvh, maxp, ps, 1, h // kvh)
    rows.append(_tuned_entry(
        torch, timer, autotune, f"B2 decode B={b} maxp={maxp}",
        lambda tune: ops.paged_attention(q, pool, table, kvl, tune=tune),
        lambda s: pa.paged_attention_cuda(q, pool, table, kvl, None,
                                          splits=s),
        lambda s: ref.flash_paged_split(q, pool, table, kvl, None,
                                        s or heur), False))
    q4 = torch.randn((b, 4, h, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    yv = ops.paged_attention(q4, pool, table, kvl)
    for lane in range(4):
        yd = ops.paged_attention(q4[:, lane:lane + 1].contiguous(), pool,
                                 table, kvl + lane)
        assert torch.equal(yv[:, lane:lane + 1], yd), \
            f"B2 verify lane {lane} != a decode call at the tuned split"
    log(f"B2 at the tuned split ({rows[-1]['winner']}; heuristic {heur}): "
        f"each of a verify call's 4 lanes bit-equal to a decode call at "
        f"kv_len + lane")
    return rows, keep


def _capture_tunes_nothing(torch, autotune, ops, keep):
    """A call that asks to tune an untuned shape inside a CUDA graph
    capture: no candidate is timed, nothing recorded, and the replay
    equals the eager call (the heuristic's split)."""
    p, dec, rec = keep
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((64, SHAPES[0][1]), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def call(tune):
        return ops.slided_matmul_quant(x, p["sp_values"], p["sp_meta"],
                                       p["s_w"], dec, recipe=rec,
                                       out_dtype=torch.bfloat16, tune=tune)
    want = call(False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(False)
    torch.cuda.current_stream().wait_stream(side)
    timed, keys = autotune._COUNTS["timed"], set(autotune._MEM)
    graph = torch.cuda.CUDAGraph()
    with ops.recorded_launches():
        with torch.cuda.graph(graph):
            got = call(True)
    graph.replay()
    torch.cuda.synchronize()
    assert autotune._COUNTS["timed"] == timed, "a capture timed candidates"
    assert set(autotune._MEM) == keys, "a capture recorded an entry"
    assert torch.equal(got, want)
    log("capture: a tune=True call of an untuned shape (B3 3840x3840 R=64) "
        "inside a CUDA graph capture timed nothing and recorded nothing; "
        "the replay equals the eager call")


def phase_tuning(torch, card, want, training, mesh):
    """Phase 13: the cost model's bounds, the autotuner on the card and
    the dry run held against phases 10 and 12 (the module docstring)."""
    import dataclasses
    import os
    import tempfile
    from repro_torch.kernels import autotune, ops, roofline
    from repro_torch.launch import analysis
    t0 = time.time()
    log("== phase 13: the cost model, the autotuner and the dry run ==")
    dry = _dry_start(("production", "launcher", "mesh"), {"device": "cuda"})
    tmp = tempfile.mkdtemp(prefix="autotune_")
    saved = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = f"{tmp}/autotune.json"
    autotune.clear()
    autotune._DISK_LOADED = False
    try:
        # (a) bounds: the published peaks are the constants this script
        # divided by before the module, so every bound keeps its digits
        pub = {k: roofline.peaks(k) for k in ("bfloat16", "int8")}
        assert pub == {"bfloat16": roofline.Peaks(3350.0, 989e3),
                       "int8": roofline.Peaks(3350.0, 1979e3)}, pub
        assert BOUNDS["checked"] > 0
        meas = roofline.measure_peaks()
        log(f"peaks ({card}): published H100 SXM {pub['int8'].bw_gbps:.0f} "
            f"GB/s, bf16 {pub['bfloat16'].gflops / 1e3:.0f} TFLOP/s, int8 "
            f"{pub['int8'].gflops / 1e3:.0f} TOP/s; measured here "
            f"(measure_peaks: 1 GiB copy, bf16 8192^3 matmul) "
            f"{meas.bw_gbps:.1f} GB/s, bf16 {meas.gflops / 1e3:.1f} TFLOP/s; "
            f"{BOUNDS['checked']} bounds of phases 2, 2b, 3 and 11 from "
            f"roofline, each equal to its printed digit")

        # (b) the autotuner: phase 5's slided weights and prompts drawn
        # again (seed 0), the heuristic engine captured before any entry
        # exists, then the tuning
        cfg, params, prompts, ecfg = _engine_setup(torch, "slided")
        base = _feature_engine(torch, cfg, params, ecfg)
        timer = Timer(torch)
        rows, keep = _tune_kernels(torch, timer)
        keys = sorted(autotune._MEM)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        child = subprocess.Popen([sys.executable, "-c", READ_TILES,
                                  json.dumps(keys)], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        _capture_tunes_nothing(torch, autotune, ops, keep)
        del timer, keep
        tuned = _feature_engine(torch, cfg, params, ecfg)
        reqs = [(i, p, 2 * i) for i, p in enumerate(prompts)]
        out, launches, _ = _serve_reqs(tuned, reqs)
        assert _tokens(out) == want, "the tuned engine's streams differ"
        spec = _feature_engine(torch, cfg, params, ecfg, speculate=3,
                               draft_source="random")
        s_out, s_launches, _ = _serve_reqs(spec, reqs)
        assert _tokens(s_out) == want, "the tuned verify engine differs"
        assert spec.stats.verify_steps > 0, spec.stats
        log(f"tuned engine (slided, graphed): {len(out)} streams equal to "
            f"phase 5's, one capture a step {tuned.captures}, launches "
            f"{launches}; with speculate=3 (random drafts) "
            f"{spec.stats.verify_steps} verify steps, streams equal too, "
            f"captures {spec.captures}")
        del spec
        tok = _timed_turns(torch, {"heuristic": base, "tuned": tuned},
                           prompts, want, card)
        text, _ = child.communicate(timeout=120)
        assert child.returncode == 0, text[-3000:]
        got = json.loads(next(line for line in text.splitlines()
                              if line.startswith("TILES "))[6:])
        assert got == {k: dataclasses.asdict(autotune.lookup(k))
                       for k in keys}, got
        log(f"the cache file read in a child process: {len(got)} entries, "
            f"each the same TileConfig")
        del base, tuned, params
        torch.cuda.empty_cache()

        # (c) the dry run against what the card measured in this call
        res = _dry_collect(dry)
        peak = training["launcher"]["peak_device_gb"] * 1e9
        pred = res["launcher"]["out"]["peak_bytes"]
        err = (pred - peak) / peak
        log(f"dry run of phase 10's configuration (one device, "
            f"{res['launcher']['seconds']:.1f} s): peak "
            f"{pred / 1e9:.3f} GB predicted, {peak / 1e9:.3f} GB "
            f"max_memory_allocated measured ({err:+.4f}, gate "
            f"{DRY_PEAK_RTOL}); resident "
            f"{res['launcher']['out']['resident_bytes'] / 1e9:.3f} GB")
        assert abs(err) <= DRY_PEAK_RTOL, (pred, peak)
        dry_vs_mesh(res["mesh"]["out"], mesh["ranks"])
        prod = res["production"]["out"]
        assert prod["status"] == "ok", prod
        from repro_torch.configs import registry, shapes
        glob = analysis.model_flops_estimate(
            registry.get("h2o-danube-3-4b"), shapes.SHAPES["train_4k"])
        log(f"dry run, h2o-danube-3-4b train_4k on 16x16 as rank 0 "
            f"({res['production']['seconds']:.1f} s): resident "
            f"{prod['resident_bytes'] / 1e9:.4f} GB, peak "
            f"{prod['peak_bytes'] / 1e9:.3f} GB "
            f"({'fits' if prod['fits'] else 'does not fit'} in 80 GB), "
            f"FLOPs a rank {prod['flops_per_rank']:.4e} = "
            f"{prod['flops_per_rank'] / (glob / prod['chips']):.3f} x the "
            f"model's 6ND / chips, collectives {prod['collective_count']}, "
            f"dominant term {prod['roofline']['dominant']}")
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if saved is None:
            os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_AUTOTUNE_CACHE"] = saved
        autotune.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.time() - t0
    log(f"phase 13 (cost model, autotuner, dry run): {seconds:.1f} s "
        f"(budget {PHASE13_S} s; {card})")
    assert seconds <= PHASE13_S, seconds
    return {"rows": rows, "tok_s": tok, "seconds": seconds,
            "dry": res, "peak_err": err}


# ---------------------------------------------------------------- phase 14
QUICK_TOL = 1e-4      # fp32, K = 1024, |y| < 8: max |compressed - dense|,
                      # max |slided - dense|, and B1's float instance vs
                      # its plain version (fp32 FMAs summed in another
                      # order; a few ulps of 8 = 4.8e-7 each)
QUICK_INT8_REL = 0.05  # the w8a8 mean relative error (JAX's CPU run 0.0306)
QUICK_BYTES = (1048576, 884736)  # bf16 dense -> values + 2-bit metadata
SWEEP_S = 50          # the sweep's five regimes on the card, its probe aside
SWEEP_PROBE = 12      # steps of the probe that times one (6:8) regime
SWEEP_BATCH, SWEEP_SEQ = 8, 128   # examples/sparsity_sweep.py's defaults
# examples/sparsity_sweep.py --steps 150 --precision int8 (JAX) on a CPU,
# as PERF.md quotes it: final loss and int8 eval loss per regime
JAX_SWEEP = {"dense": (5.7140, 5.6596), "10:12": (5.7132, 5.6589),
             "6:8": (5.7153, 5.6662), "4:6": (5.7143, 5.6624),
             "2:4": (5.7139, 5.6623)}
TINY_STEPS = 20       # train_tiny_lm: N steps, then a rerun to 2N
TINY_TIMEOUT = 300
PHASE14_S = 90        # the phase's budget on the card
_TINY_LOSS = re.compile(r"\[tiny-lm\] loss (\S+) -> (\S+) over (\d+) steps")


def _tiny_lm_chain(ckpt_dir: str) -> list[str]:
    """``python -m repro_torch.launch.train_tiny_lm`` to TINY_STEPS, then
    rerun to twice that from its checkpoint (6:8 masked, int8 moments, on
    the card); each run's output (a failed run raises)."""
    import os
    outs = []
    for steps in (TINY_STEPS, 2 * TINY_STEPS):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train_tiny_lm",
             "--steps", str(steps), "--ckpt-dir", ckpt_dir, "--int8-opt",
             "--sparse", "6", "8"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=TINY_TIMEOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        outs.append(r.stdout)
        assert r.returncode == 0, \
            f"train_tiny_lm --steps {steps} exited {r.returncode}:\n" \
            f"{r.stdout[-3000:]}"
    return outs


def _quickstart_on_card(torch, card):
    """(a) ``quickstart.run`` on the card: B1 (fp32 instance) and B3
    launched, each held against its plain version, the figures gated."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import quickstart
    before = ops.launch_counts()
    q = quickstart.run(*quickstart.draw("cuda"), "cuda")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    n = {k: after[k]["launches"] - before[k]["launches"]
         for k in ("compressed_matmul", "fused_slided_matmul")}
    assert n["compressed_matmul"] >= 1 and n["fused_slided_matmul"] >= 1, n
    plain3 = ref.slided_matmul_quant(q["x"], q["ws_q"], q["s_w"], q["dec"],
                                     "int8", torch.float32)
    assert torch.equal(q["y_int8"], plain3), \
        "quickstart: B3 differs from its plain version"
    plain1 = ref.compressed_matmul_fp(q["x"], q["c"], torch.float32)
    b1_err = (q["y_compressed"] - plain1).abs().max().item()
    assert b1_err <= QUICK_TOL, f"quickstart: B1 vs plain {b1_err}"
    assert q["compressed_err"] <= QUICK_TOL, q["compressed_err"]
    assert q["slided_err"] <= QUICK_TOL, q["slided_err"]
    assert (q["dense_bytes"], q["compressed_bytes"]) == QUICK_BYTES
    assert q["int8_rel_err"] <= QUICK_INT8_REL, q["int8_rel_err"]
    log(f"quickstart on the card: launches B1 {n['compressed_matmul']} "
        f"(fp32 instance, R = 64), B3 {n['fused_slided_matmul']} (int8, "
        f"R = 64); B3 == plain bit for bit, B1 vs plain {b1_err:.3e} (gate "
        f"{QUICK_TOL}); max |slided - dense| {q['slided_err']:.3e}, max "
        f"|compressed - dense| {q['compressed_err']:.3e}; storage "
        f"{q['dense_bytes']} B -> {q['compressed_bytes']} B; int8 mean rel "
        f"err {q['int8_rel_err']:.4f} (gate {QUICK_INT8_REL}; {card})")
    return {"launches": n, "b1_err": b1_err,
            **{k: q[k] for k in ("slided_err", "compressed_err",
                                 "int8_rel_err")}}


def _sweep_on_card(torch, card):
    """(b) the sparsity sweep at int8, its steps sized from a timed probe
    of one regime so the five regimes take about SWEEP_S seconds."""
    import argparse
    import statistics
    from repro_torch.launch import sparsity_sweep as sw
    probe = sw.train_regime(sw.regime_config(sw.base_config(), (6, 8)),
                            SWEEP_PROBE, SWEEP_BATCH, SWEEP_SEQ, "cuda")
    step_s = statistics.median(probe["step_seconds"][2:])
    steps = max(10, int(SWEEP_S / (len(sw.REGIMES) * step_s)))
    log(f"sweep probe (6:8, {SWEEP_PROBE} steps of {SWEEP_BATCH} x "
        f"{SWEEP_SEQ}): median step {step_s * 1e3:.3f} ms -> {steps} steps "
        f"a regime for ~{SWEEP_S} s ({card})")
    t0 = time.time()
    res = sw.sweep(argparse.Namespace(steps=steps, batch=SWEEP_BATCH,
                                      seq=SWEEP_SEQ, precision="int8"),
                   "cuda")
    seconds = time.time() - t0
    k = max(1, steps // 10)
    for name, (losses, final, qloss) in res.items():
        assert len(losses) == steps and all(
            math.isfinite(v) for v in losses + [qloss]), (name, losses)
        first, last = statistics.mean(losses[:k]), statistics.mean(
            losses[-k:])
        assert last < first, (name, first, last)
    log(f"sweep ({steps} steps a regime, {seconds:.1f} s; JAX's run: "
        f"{len(JAX_SWEEP)} regimes x 150 steps on a CPU)")
    log("pattern  final-loss  int8-eval-loss | JAX final  JAX int8-eval")
    for name, (_, final, qloss) in res.items():
        jf, jq = JAX_SWEEP[name]
        log(f"{name:>7}  {final:.4f}  {qloss:.4f} | {jf:.4f}  {jq:.4f}")
    final = {name: r[1] for name, r in res.items()}
    log(f"Figure 2's ordering (a finding, not a gate): dense <= 6:8 "
        f"{final['dense'] <= final['6:8']}, 6:8 < 2:4 "
        f"{final['6:8'] < final['2:4']}, dense < 2:4 "
        f"{final['dense'] < final['2:4']} (final losses over the last "
        f"{k} steps; {card})")
    return {"steps": steps, "probe_step_ms": step_s * 1e3,
            "seconds": seconds,
            "regimes": {n: {"final": r[1], "int8_eval": r[2],
                            "first": statistics.mean(r[0][:k])}
                        for n, r in res.items()}}


def _tiny_lm_check(outs, card):
    """(c) the tiny LM's two runs: the second resumed at TINY_STEPS, the
    loss fell."""
    runs = []
    for label, text in zip(("first", "resumed"), outs):
        for line in text.splitlines():
            log(f"  [train_tiny_lm {label}] {line}")
        m = _TINY_LOSS.search(text)
        assert m, text[-2000:]
        runs.append((float(m.group(1)), float(m.group(2)), int(m.group(3))))
    assert f"[train] resumed from step {TINY_STEPS}" in outs[1], outs[1]
    (a0, a1, n0), (_, b1, n1) = runs
    assert (n0, n1) == (TINY_STEPS, 2 * TINY_STEPS), runs
    assert a1 < a0 and b1 < a0, runs
    step = re.search(r"median step (\S+) ms", outs[1])
    size = re.search(r"(\S+M) params", outs[0])
    log(f"tiny LM ({size.group(1)} params, 6:8 masked, int8 moments, 8 x "
        f"256): loss "
        f"{a0:.4f} -> {a1:.4f} in {n0} steps, resumed from step {n0} to "
        f"{b1:.4f} at step {n1}; median step "
        f"{step.group(1) if step else 'not measured'} ms ({card})")
    return {"runs": runs, "step_ms": float(step.group(1)) if step else None}


def phase_library(torch, card):
    """Phase 14: the library API and the examples (the module docstring).
    The children (the quickstart as a command, the tiny LM's two runs)
    run beside the in-process sweep."""
    import concurrent.futures
    import os
    import tempfile
    t0 = time.time()
    log("== phase 14: the library API and the examples ==")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    quick = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.quickstart"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        try:
            tiny = pool.submit(_tiny_lm_chain, ckpt_dir)
            out = {"quickstart": _quickstart_on_card(torch, card)}
            out["sweep"] = _sweep_on_card(torch, card)
            text, _ = quick.communicate(timeout=TINY_TIMEOUT)
            for line in text.splitlines():
                log(f"  [quickstart] {line}")
            assert quick.returncode == 0, \
                f"python -m repro_torch.launch.quickstart exited " \
                f"{quick.returncode}"
            out["tiny_lm"] = _tiny_lm_check(tiny.result(), card)
        finally:
            if quick.poll() is None:
                quick.kill()
                quick.wait()
            pool.shutdown(wait=True)
    out["seconds"] = time.time() - t0
    log(f"phase 14 (library API and examples): {out['seconds']:.1f} s "
        f"(budget {PHASE14_S} s; {card})")
    assert out["seconds"] <= PHASE14_S, out["seconds"]
    return out


TRACE_STEPS = 5       # small_train_trace: steps timed, then steps traced


def small_train_trace() -> dict:
    """Where a small model's training step goes (not a phase of
    ``main``): the sweep's 6:8 model (SWEEP_BATCH x SWEEP_SEQ, fp32
    moments) and the tiny LM (6:8 masked, int8 moments, 8 x 256), each
    alone on the card as its launcher trains it (``steps.train_step``,
    the loss read back).  After two warm-up steps, TRACE_STEPS steps are
    timed without the profiler (median wall), then TRACE_STEPS more are
    traced: device time a step (the union of device activity), device
    operations a step, and the device idle share against the untraced
    wall time.  Not gated:

        python3 -c "import chip_smoke as c; c.small_train_trace()"
    """
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import sparsity_sweep as sw
    from repro_torch.launch import train_tiny_lm as tl
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    card = card_line()
    cases = {"sweep": (sw.regime_config(sw.base_config(), (6, 8)),
                       adamw.AdamWConfig(lr=3e-3), SWEEP_BATCH, SWEEP_SEQ),
             "tiny LM": (tl.hundred_m_config("h2o-danube-3-4b", (6, 8)),
                         adamw.AdamWConfig(lr=3e-3, state_dtype="int8"),
                         8, 256)}
    out = {}
    for label, (cfg, opt, batch, seq) in cases.items():
        params = M.init(cfg, torch.Generator(device="cuda").manual_seed(0))
        st = adamw.init(params, opt)
        pipe = SyntheticLM(cfg, batch, seq, seed=0, device="cuda")
        it = iter(range(2 + 2 * TRACE_STEPS))

        def step():
            nonlocal params, st
            params, st, m = steps.train_step(cfg, opt, params, st,
                                             pipe.device_batch_at(next(it)))
            float(m["loss"])
        for _ in range(2):
            step()
        walls = []
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACE_STEPS):
                step()
            traced = (time.perf_counter() - t0) / TRACE_STEPS
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation)
        assert dev, f"trace {label}: no device activity recorded"
        busy, end, by = 0.0, dev[0][0], {}
        for a, b, name in dev:
            by[name] = by.get(name, 0.0) + b - a
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        device_ms = busy / TRACE_STEPS / 1e3
        ops_a_step = len(dev) / TRACE_STEPS
        idle = max(0.0, 1 - device_ms / (wall * 1e3))
        log(f"trace, one {label} training step ({M.param_count(params)} "
            f"params, {batch} x {seq}): wall {wall * 1e3:.3f} ms untraced "
            f"(steps {', '.join(f'{w * 1e3:.3f}' for w in walls)}), "
            f"{traced * 1e3:.3f} ms traced; device time {device_ms:.3f} ms "
            f"in {ops_a_step:.0f} device operations; device idle share "
            f"{idle:.3f} ({card})")
        for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  top device op ({label}): {us / TRACE_STEPS / 1e3:.3f} "
                f"ms a step  {name[:90]}")
        out[label] = {"wall_ms": wall * 1e3, "traced_ms": traced * 1e3,
                      "device_ms": device_ms, "device_ops": ops_a_step,
                      "idle_share": idle}
        del params, st
        torch.cuda.empty_cache()
    print("TRACE " + json.dumps(out), flush=True)
    return out


def host_step(other_ops: str, num_layers: int = 4, steps: int = 20,
              rounds: int = 10) -> int:
    """The host's cost of the kernel wrappers, for comparing two versions
    of ``kernels/ops.py`` in turns in one process (not a phase of
    ``main``): this tree's module and ``other_ops`` (another tree's
    ``ops.py``, loaded in its place; its helpers are this tree's) take
    turns, ``rounds`` times each, running h2o-danube-3-4b's eager decode
    step (full width, ``num_layers`` layers, each sparse mode, B = 4;
    ``steps`` steps a turn) and single calls of B1, B3 and B2
    (``_host_calls``):

        python3 -c "import chip_smoke as c; c.host_step(
            '<tree>/src/repro_torch/kernels/ops.py')"

    Prints ``HOST <json>``: for each module, the median µs to enqueue a
    step (the host's work: no synchronize inside a step) and to finish
    it, the kernel launches a step, and the µs of one call."""
    import importlib.util
    import inspect
    import types
    import numpy as np
    import torch
    import repro_torch.kernels  # noqa: F401
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve_loop
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._ops_other", other_ops)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)

    def thin(mod):
        # the module with each wrapper the engine calls behind one more
        # frame, which drops ``tune`` where ``mod``'s wrapper lacks it:
        # both versions pay the same frame
        ns = types.ModuleType(mod.__name__)
        ns.__dict__.update(vars(mod))
        for f in ("compressed_matmul", "slided_matmul_quant",
                  "paged_attention"):
            fn = getattr(mod, f)
            if "tune" in inspect.signature(fn).parameters:
                setattr(ns, f, lambda *a, _fn=fn, **kw: _fn(*a, **kw))
            else:
                setattr(ns, f, lambda *a, _fn=fn, tune=False, **kw:
                        _fn(*a, **kw))
        return ns
    mods = {"this": thin(ops), "other": thin(other)}

    def use(mod):
        # every reference to the module (deferred imports read the
        # package's attribute) now names ``mod``
        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").startswith("repro_torch"):
                for k, v in list(vars(m).items()):
                    if v is ops or any(v is x for x in mods.values()):
                        setattr(m, k, mod)

    out = {"other": other_ops}
    try:
        for mode in ("compressed", "slided"):
            cfg, params, _, ecfg = _engine_setup(torch, mode,
                                                 num_layers=num_layers)
            eng = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda",
                                         _eager=True)
            eng.warmup()
            b = ecfg.max_batch
            ptab, zero = eng.kv.page_table_array(), np.zeros(b)
            got = {n: {"enq": [], "done": [], "launches": 0} for n in mods}
            for r in range(rounds):
                for name in (("this", "other") if r % 2 == 0
                             else ("other", "this")):
                    use(mods[name])
                    for _ in range(3):
                        eng._decode(zero, ptab, zero, zero)
                    torch.cuda.synchronize()
                    before = ops.launch_counts()
                    for _ in range(steps):
                        t0 = time.perf_counter()
                        eng._decode(zero, ptab, zero, zero)
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        got[name]["enq"].append(t1 - t0)
                        got[name]["done"].append(time.perf_counter() - t0)
                    after = ops.launch_counts()
                    got[name]["launches"] = sum(
                        after[k]["launches"] - before[k]["launches"]
                        for k in after) / steps
            out[mode] = {n: {"enqueue_us": 1e6 * float(np.median(g["enq"])),
                             "step_us": 1e6 * float(np.median(g["done"])),
                             "launches": g["launches"]}
                         for n, g in got.items()}
            del eng, params
            torch.cuda.empty_cache()
        calls = {n: [] for n in mods}
        for r in range(rounds):
            for name in (("this", "other") if r % 2 == 0
                         else ("other", "this")):
                use(mods[name])
                calls[name].append(_host_calls(torch, mods[name]))
        out["call_us"] = {n: {k: float(np.median([c[k] for c in cs]))
                              for k in cs[0]} for n, cs in calls.items()}
    finally:
        use(ops)
    print("HOST " + json.dumps(out), flush=True)
    return 0


def _host_calls(torch, ops, batches=3, calls=200):
    """The host µs of one ``ops`` call, each of B1 and B3 (R = 4, int8)
    and B2 (B = 4, danube's heads): the least over ``batches`` of
    ``calls`` calls enqueued back to back.  The shapes are small, so the
    device keeps up with the host and the loop reads the host's time."""
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided
    gen = torch.Generator(device="cuda").manual_seed(15)
    k = 256
    x = torch.randn((4, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, k), generator=gen, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    cfg1 = sl.SparsityConfig(pattern=(6, 8), mode="compressed", recipe="int8")
    cfg3 = sl.SparsityConfig(pattern=(6, 8), mode="slided", recipe="int8")
    p1, p3 = sl.prepare({"w": w}, cfg1), sl.prepare({"w": w}, cfg3)
    c = CompressedSlided(p1["values"], p1["indices"], k, 6, 8, 2, 4)
    dec = cfg3.decomposition()
    b, h, kvh, hd, ps, maxp = 4, 32, 8, 120, 16, 4
    pool = {n: torch.randn((17, ps, kvh, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
            for n in ("k", "v")}
    table = torch.randint(1, 17, (b, maxp), generator=gen, device="cuda",
                          dtype=torch.int32)
    kvl = torch.tensor([40, 21, 9, 60], dtype=torch.int32, device="cuda")
    q = torch.randn((b, 1, h, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    fns = {"B1": lambda: ops.compressed_matmul(x, c, s_w=p1["s_w"],
                                               recipe="int8"),
           "B3": lambda: ops.slided_matmul_quant(
               x, p3["sp_values"], p3["sp_meta"], p3["s_w"], dec,
               recipe="int8"),
           "B2": lambda: ops.paged_attention(q, pool, table, kvl)}
    got = {}
    for name, fn in fns.items():
        best = float("inf")
        for _ in range(batches + 1):  # the first batch warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
        got[name] = 1e6 * best
    return got


def main() -> int:
    import gc
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    libs = _build.build(verbose=True)
    log(f"build: {time.time() - t0:.1f} s -> "
        f"{', '.join(p.name for p in libs.values())}")
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        text = logf.read_text() if logf.exists() else ""
        regs = [int(w) for line in text.splitlines() if "Used" in line
                for a, w in zip(line.split(), line.split()[1:])
                if a == "Used"]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        log(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {len(spills)} with spills")
        # every instance's registers, shared memory and spills as ptxas
        # reports them; B4 and B5 must not spill
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name} {entry[:90]}: {line.strip()}")
        if name in ("fused_quant_slide", "quant_matmul"):
            assert not spills, f"{name} spills: {spills}"
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        # the tensor-core instances exist: mma.sync in the SASS of B1 (IMMA,
        # int8 prefill) and B2 (HMMA, bf16 prefill chunk), mma.sp in B3's
        # int8/w4 instances (the sparse IMMA form, IMMA.SP), and in B5's
        # prefill instances wgmma (IGMMA, int8) and f16 mma.sync (HMMA,
        # e4m3 operands)
        for name in ("compressed_matmul", "paged_attention",
                     "fused_slided_matmul", "quant_matmul"):
            sass = subprocess.run([cuobjdump, "-sass", str(libs[name])],
                                  capture_output=True, text=True,
                                  timeout=120).stdout
            sparse, igmma = sass.count("IMMA.SP"), sass.count("IGMMA")
            log(f"SASS {name}: {sass.count('HMMA')} HMMA, "
                f"{sass.count('IMMA')} IMMA ({sparse} of them sparse, "
                f"IMMA.SP), {igmma} IGMMA instructions")
            if name == "fused_slided_matmul":
                assert sparse > 0, "B3 has no sparse IMMA instruction"
                assert sass.count("IMMA") == sparse, "B3 has dense IMMA"
            if name == "quant_matmul":
                assert igmma > 0, "B5 has no wgmma (IGMMA) instruction"
                assert sass.count("HMMA") > 0, "B5 has no f16 mma (HMMA)"
    else:
        log("SASS: cuobjdump not found, tensor-core instructions not counted")

    timer = Timer(torch)
    b1_err, b1 = phase_b1(torch, timer)
    sl_err, sl = phase_slided_kernels(torch, timer)
    b2_err, b2 = phase_b2(torch, timer)
    del timer
    torch.cuda.empty_cache()
    launches, compressed = phase_engine(torch, card)
    torch.cuda.empty_cache()
    slided_launches, slided = phase_slided_engine(torch, card, compressed)
    torch.cuda.empty_cache()
    # both packings (5.76 + 3.61 GB of linears) serve the features phase
    packs = {"compressed": compressed.pop("pack"),
             "slided": slided.pop("pack")}
    features = phase_features(torch, card, packs, compressed["prompts"],
                              compressed["ecfg"], slided["tokens"])
    del packs
    torch.cuda.empty_cache()
    phase_float_gate(torch, card)
    torch.cuda.empty_cache()
    families = phase_families(torch, card)
    torch.cuda.empty_cache()
    audio_vision = phase_audio_vision(torch, card)
    training = phase_training(torch, card)
    ref = {mode: {"tokens": d["tokens"], "first": d["first_logits"],
                  "rows": d["rows"], "eager_tok_s": d["eager_tok_s"]}
           for mode, d in (("compressed", compressed), ("slided", slided))}
    gc.collect()  # engines and graphs of earlier phases in cycles
    torch.cuda.empty_cache()
    tp = phase_tp(torch, card, ref, Timer(torch))
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    tuning = phase_tuning(torch, card, slided["tokens"], training, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    library = phase_library(torch, card)
    prof, tok_s = slided["profile"], slided["tok_s"]
    for label, pr in prof.items():
        log(f"slided decode step, {label}: {pr['step_ms']:.3f} ms, host "
            f"share {pr['host_share']:.3f}, device idle share "
            f"{pr['idle_share']:.3f} ({card})")
    log(f"slided engine decode tok/s: eager {tok_s['eager']:.2f}, graphed "
        f"{tok_s['graphed']:.2f}, graphed + overlapped "
        f"{tok_s['overlapped']:.2f} ({card})")
    for mode in ("compressed", "slided"):
        rate, tok = features[f"spec {mode}"]
        hit, pre = features[f"prefix {mode}"]
        log(f"features {mode}: decode tok/s spec-off {tok['spec-off']:.2f}, "
            f"spec-on (K=3) {tok['spec-on']:.2f}, acceptance rate "
            f"{rate:.4f}; prefill s prefix-off {pre[False]:.4f}, prefix-on "
            f"{pre[True]:.4f}, hit rate {hit:.4f} ({card})")
    log(f"CUDA graph nodes per step: "
        f"{features['nodes'] or 'not measured'} ({card})")
    report_families(families, card)
    report_audio_vision(audio_vision, card)
    pr = training["profile"]
    log(f"training step (full width and depth, traced): device "
        f"{pr['device_ms']:.3f} ms of {pr['wall_ms']:.3f} ms wall, idle "
        f"share {pr['idle_share']:.3f}; kernel time shares " + ", ".join(
            f"{k} {v:.3f}" for k, v in pr["shares"].items())
        + f"; phase 10 {training['seconds']:.1f} s ({card})")
    for mode in ("compressed", "slided"):
        t = tp[mode]
        log(f"tp = 2 {mode}: eager decode {t['tok_s']:.2f} tok/s vs tp = 1 "
            f"eager {ref[mode]['eager_tok_s']:.2f}; collectives per decode "
            f"step {t['per_step']}; device memory per rank after load "
            f"{', '.join(f'{m / 1e9:.2f}' for m in t['mem'])} GB (linears "
            f"{t['shard'] / 1e9:.3f} of {t['full'] / 1e9:.3f} GB); logits vs "
            f"tp = 1 worst {t['read']['sound']:.3e}, planted faults least "
            f"{t['least']['skip_reduce']:.3e} / "
            f"{t['least']['local_absmax']:.3e}; launches {t['launches']}, "
            f"B3 given act_absmax {t['act_absmax']}; phase 11 "
            f"{tp['seconds']:.1f} s ({card})")

    report_mesh(mesh, card)
    eff = [r["efficiency"] for r in tuning["rows"]]
    log(f"autotuner (phase 13): {len(eff)} entries tuned, efficiency "
        f"{min(eff):.4f}-{max(eff):.4f}; graphed slided decode tok/s in "
        f"turns: heuristic {tuning['tok_s']['heuristic']:.2f}, tuned "
        f"{tuning['tok_s']['tuned']:.2f} (phase 5's graphed "
        f"{tok_s['graphed']:.2f}); dry peak vs phase 10 "
        f"{tuning['peak_err']:+.4f}; phase 13 {tuning['seconds']:.1f} s "
        f"({card})")
    sw, tl = library["sweep"], library["tiny_lm"]
    log(f"library and examples (phase 14): quickstart launches "
        f"{library['quickstart']['launches']}; sweep {sw['steps']} steps a "
        f"regime, final / int8 eval losses " + ", ".join(
            f"{n} {r['final']:.4f} / {r['int8_eval']:.4f}"
            for n, r in sw["regimes"].items())
        + f"; tiny LM median step {tl['step_ms']} ms; phase 14 "
        f"{library['seconds']:.1f} s ({card})")

    quick = library["quickstart"]["launches"]

    def entry(name, source, replaces, n, err, st):
        # phase 12's ranks assert that no kernel launched in training;
        # phase 14's quickstart launches B1 and B3
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": n,
                "mesh_training_launches": 0,
                "quickstart_launches": quick.get(name, 0),
                "max_abs_err": err,
                "ms": st["ms"], "kernel_ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                "bound_by": st["bound_by"], "library_ms": st["library_ms"]}

    kernels = [
        entry("compressed_matmul", "compressed_matmul.cu",
              "src/repro/kernels/slide_matmul.py:155",
              launches["compressed_matmul"], b1_err, b1),
        entry("paged_attention", "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:202",
              launches["paged_attention"], b2_err, b2),
        # B3 runs on the slided engine's path; B4 and B5 on neither
        # engine's (the two-kernel pipeline and the dense baseline)
        entry("fused_slided_matmul", "fused_slided_matmul.cu",
              "src/repro/kernels/fused_slide_matmul.py:136",
              slided_launches["fused_slided_matmul"], sl_err["B3"],
              sl["B3"]),
        entry("fused_quant_slide", "fused_quant_slide.cu",
              "src/repro/kernels/fused_quant_slide.py:81",
              slided_launches["fused_quant_slide"], sl_err["B4"], sl["B4"]),
        entry("quant_matmul", "quant_matmul.cu",
              "src/repro/kernels/quant_matmul.py:46",
              slided_launches["quant_matmul"], sl_err["B5"], sl["B5"]),
        # B3 given the rows' absmax: phase 11's slided tp = 2 run, one
        # rank's launches; times per tp = 2 decode step's 48 row-parallel
        # calls at the shard shapes
        entry("fused_slided_matmul[act_absmax]", "fused_slided_matmul.cu",
              "src/repro/kernels/fused_slide_matmul.py:136",
              tp["slided"]["act_absmax"], tp["kernels"]["B3_act_absmax"],
              tp["kernels"]["row"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
