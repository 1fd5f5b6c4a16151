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
   16): decode B=4 up to ~1000 tokens, a 128-lane prefill chunk, and the
   split edges (rows of 1, 15, 16, 17 tokens beside one of ~4000), window
   off and 300, bf16 and int8 pools, fp32 queries and the main path's
   bf16 queries (tolerances below), each bf16 call launched twice and
   held bit-identical; kernel and SDPA timed in turns;
4. the engine: full 24-layer h2o-danube-3-4b, 6:8 compressed, int8
   recipe, bf16 activations and KV pages, fused paged attention, serving
   4 staggered requests, once eager and once with each step captured as
   a CUDA graph in ``warmup``; one prefill chunk and one decode step of
   each must dispatch under ``set_sync_debug_mode("error")`` (no host
   synchronization on the step path); the graphed engine must hold one
   capture per step and give the eager run's streams, first-token logits
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
6. the float gate: the engine at recipe "none" with fp32 activations and
   KV pages (full width, depth cut to FLOAT_LAYERS), graphed, against
   one-shot ``generate``: identical streams, or each first divergence a
   tie within rounding (one-shot top-2 margin below max|engine -
   one-shot| of the logits there);
7. a ``kernels`` JSON line, the card line, and the final result line.

It imports neither JAX nor the JAX package, and prints every table it
measures on standard output.
"""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # dense tensor-core peaks
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


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
                    step["bytes_s"] += n * nbytes / HBM_BYTES_S
                    step["ops_s"] += n * ops / PEAK_OPS["int8"]
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
            st["bytes_s"] += n * nbytes / HBM_BYTES_S
            st["ops_s"] += n * ops / PEAK_OPS["int8"]
            st["dense_bytes_s"] += n * (dense_bytes or 0) / HBM_BYTES_S

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
    cases = [("decode", [1000, 517, 77, 260], 1, True),
             ("prefill", [257], PREFILL_CHUNK, True),
             ("edges", [1, 15, 16, 17, 3999], 1, False)]
    for name, kv_len, lanes, timed in cases:
        b = len(kv_len)
        maxp = -(-(max(kv_len) + lanes - 1) // ps) + 2
        splits = pa.splits_for(b, kvh, maxp, ps, lanes, h // kvh)
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
                y = pa.paged_attention_cuda(q, pool, table, kvl, window)
                y_ref = ref.flash_paged_split(q, pool, table, kvl, window,
                                              splits)
                yb = pa.paged_attention_cuda(qb, pool, table, kvl, window)
                yb2 = pa.paged_attention_cuda(qb, pool, table, kvl, window)
                yb_ref = ref.flash_paged_split(qb, pool, table, kvl, window,
                                               splits)
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
                                                    window),
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
                if name == "decode" and pool_kind == "bf16" and window is None:
                    main = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                            "bound_ms": b_ms, "bound_by": b_by}
        del pool
    torch.cuda.empty_cache()
    # per decode step: the model's 24 attention layers at this shape
    step = {k_: (24 * v if k_.endswith("ms") else v) for k_, v in main.items()}
    log(f"B2 per decode step (24 layers, B=4, bf16 pool): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    return max_err, step


# ----------------------------------------------------------------- phase 4
PLENS, NEW_TOKENS = [53, 117, 211, 298], 32
FLOAT_LAYERS = 8               # depth of the float-recipe gate's model
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


def _engine_setup(torch, mode, recipe="int8", dtype=None, num_layers=None):
    """h2o-danube-3-4b at full width, 6:8 in ``mode``, fused attention,
    packed from the seed-0 init (bf16 activations and KV pages as
    registered, or ``dtype`` for both; the registered 24 layers, or
    ``num_layers``); the 4 staggered prompts drawn from the same
    generator.  Returns (cfg, params, prompts, ecfg)."""
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
    params = serve_loop.pack_params(M.init(cfg, gen), cfg)
    torch.cuda.synchronize()
    packed = sum(t.numel() * t.element_size()
                 for u in params["units"] for lp in u.values()
                 for blk in ("mixer", "ffn") for lin in lp[blk].values()
                 for t in lin.values()) + sum(
        t.numel() * t.element_size() for t in params["lm_head"].values())
    log(f"init + pack: {time.time() - t0:.1f} s; {cfg.num_layers} layers, "
        f"{mode} {recipe} linears {packed / 1e9:.2f} GB; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in PLENS]
    ecfg = serve_loop.EngineConfig(max_batch=4, page_size=16, num_pages=128,
                                   max_seq_len=max(PLENS) + NEW_TOKENS,
                                   prefill_chunk=PREFILL_CHUNK)
    return cfg, params, prompts, ecfg


def _sync_free(torch, eng, label):
    """One prefill chunk and one decode step of ``eng`` dispatched under
    ``torch.cuda.set_sync_debug_mode("error")``, their outputs' copy to the
    host queued too: any host synchronization on the step path raises.
    The dummy inputs write only the spare page."""
    import numpy as np
    ec = eng.ecfg
    ptab = eng.kv.page_table_array()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._prefill(np.zeros((1, ec.prefill_chunk)), ptab[:1], 0, 0)
        eng._decode(np.zeros(ec.max_batch), ptab, np.zeros(ec.max_batch),
                    np.zeros(ec.max_batch))
        eng._to_host(eng._steps["decode"].out[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"sync check {label}: a prefill chunk and a decode step ran under "
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
    weights, both warmed up and put through the sync check."""
    from repro_torch.runtime import serve_loop
    eager = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda",
                                   _eager=True)
    log(f"warmup eager: {eager.warmup():.2f} s")
    graphed = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
    log(f"warmup graphed (eager pass + capture): {graphed.warmup():.2f} s; "
        f"captures {graphed.captures}")
    assert eager.captures == {"prefill": 0, "decode": 0}, eager.captures
    assert graphed.captures == {"prefill": 1, "decode": 1}, graphed.captures
    _sync_free(torch, eager, "eager")
    _sync_free(torch, graphed, "graphed")
    return eager, graphed


def _engine_run(eng, prompts, label, split=True):
    """Serve the prompts with every kernel count set to 0 just before
    ``run()``; returns (completions, launches read just after).  With
    ``split`` each step ends in a synchronize, so the run's wall time
    splits into prefill and decode steps (a step that advanced the
    scheduler's decode count is a decode step)."""
    import torch
    counters = _counters()
    for i, p in enumerate(prompts):
        eng.submit(p, NEW_TOKENS, rid=i, arrival=2 * i)
    marks = []

    def on_step(e, k):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), e.sched.stats.decode_steps))

    for mod in counters.values():
        mod.reset_counts()
    t_prev, d_prev = time.perf_counter(), 0
    out = eng.run(on_step=on_step if split else None)
    launches = {name: mod.launch_count() for name, mod in counters.items()}
    s = eng.stats
    if split:
        part = {"prefill": 0.0, "decode": 0.0}
        for t, d in marks:
            part["decode" if d > d_prev else "prefill"] += t - t_prev
            t_prev, d_prev = t, d
        how = (f" (prefill steps {part['prefill']:.3f} s, decode steps "
               f"{part['decode']:.3f} s)")
    else:
        how = " (no per-step synchronize)"
    log(f"run {label}: {s.steps} steps, {s.decode_steps} decode steps, "
        f"{s.decode_tokens} decode tokens in {s.wall_s:.3f} s{how}; "
        f"{s.decode_tok_s:.2f} tok/s; launches {launches}")
    assert sorted(out) == list(range(len(prompts)))
    assert all(c.ok and len(c.tokens) == NEW_TOKENS for c in out.values())
    eng.kv.check()
    return out, launches


def _hold_graphed(torch, eager, e_out, e_launches, graphed, g_out,
                  g_launches, label):
    """The graphed run equals the eager run of the same engine: streams,
    first-token logits bit for bit, and every kernel's launch count."""
    assert graphed.captures == {"prefill": 1, "decode": 1}, graphed.captures
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


def phase_engine(torch, card):
    from repro_torch.kernels import ops as kops, slide_matmul as smm
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    log("== engine: h2o-danube-3-4b 24L d3840, 6:8 compressed int8, bf16, "
        "fused attention; eager, then each step a CUDA graph ==")
    _sync_check_bites(torch)
    cfg, params, prompts, ecfg = _engine_setup(torch, "compressed")
    eager, eng = _engine_pair(torch, cfg, params, ecfg)
    e_out, e_launches = _engine_run(eager, prompts, "eager")
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
    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

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
    assert bad.captures == {"prefill": 1, "decode": 1}, bad.captures

    same, total = 0, 0
    read = {"sound": [], "short": [], "dropped": []}
    for i, p in enumerate(prompts):
        tok = torch.tensor([p], dtype=torch.int32, device="cuda")
        ref = M.prefill(params, cfg, tok)[0][0].float()
        got = eng.first_logits[i].float()
        read["sound"].append(rel_l2(got, ref))
        read["short"].append(rel_l2(bad.first_logits[i].float(), ref))
        read["dropped"].append(rel_l2(
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
    log(f"identical tokens vs one-shot generate (int8): {same}/{total} "
        f"({same / total:.3f})")
    worst = {k: max(v) for k, v in read.items()}
    log(f"last-prefill logits, worst relative L2: sound {worst['sound']:.5f}"
        f", planted faults short {worst['short']:.5f} and dropped "
        f"{worst['dropped']:.5f}; limit {LOGIT_RL2}")
    assert worst["sound"] <= LOGIT_RL2, \
        f"engine logits off by {worst['sound']} > {LOGIT_RL2}"
    for fault in ("short", "dropped"):
        assert worst[fault] > LOGIT_RL2, \
            f"planted fault {fault} ({worst[fault]}) passes the gate"
    result = {"tokens": {i: c.tokens for i, c in out.items()},
              "first_logits": {i: v.cpu() for i, v in eng.first_logits.items()},
              "tok_s": s.decode_tok_s}
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


def _timed_turns(torch, engines, prompts, want, card):
    """Decode tok/s of each engine (decode tokens over its run's wall
    time, prefill included) on the chip_smoke traffic, the engines in
    turns (in order, then in reverse), each run's streams held to
    ``want``."""
    import statistics
    got = {label: [] for label in engines}
    order = list(engines) + list(reversed(engines))
    for turn, label in enumerate(order):
        eng = engines[label]
        clock, rid0 = eng.sched.clock, 1000 * (turn + 1)
        d0 = eng.sched.stats.decode_tokens
        for i, p in enumerate(prompts):
            eng.submit(p, NEW_TOKENS, rid=rid0 + i, arrival=clock + 2 * i)
        out = eng.run()
        for i in range(len(prompts)):
            assert out[rid0 + i].tokens == want[i], (label, i)
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
    e_out, e_launches = _engine_run(eager, prompts, "eager")
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
    assert overlapped.captures == {"prefill": 1, "decode": 1}
    log(f"overlapped == sync: {len(a_out)} streams and the scheduler trace "
        f"({len(eng.sched.trace)} entries) equal, launches equal")

    prof = {label: _profile(torch, e, prompts, 100, label)
            for label, e in (("eager", eager), ("graphed", eng))}
    want = {i: c.tokens for i, c in out.items()}
    tok = _timed_turns(torch, {"eager": eager, "graphed": eng,
                               "overlapped": overlapped}, prompts, want, card)
    return launches, {"profile": prof, "tok_s": tok}


# ----------------------------------------------------------------- phase 6
def phase_float_gate(torch, card):
    """The north star's argmax-identity contract on the card: the engine
    at recipe "none" with fp32 activations and KV pages (B1's float
    instance, B2 with fp32 queries), graphed, against one-shot
    ``generate`` on the same weights and prompts.  Streams must be
    identical; where one diverges, the first divergent position may pass
    only as a tie within rounding: the one-shot logits' top-2 margin there
    below max|engine - one-shot| of the logits there."""
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    log(f"== float gate: h2o-danube-3-4b full width cut to {FLOAT_LAYERS} of "
        f"24 layers, 6:8 compressed, recipe none, fp32 activations and KV "
        "pages, fused attention, graphed; streams vs one-shot generate ==")
    cfg, params, prompts, ecfg = _engine_setup(
        torch, "compressed", recipe="none", dtype="float32",
        num_layers=FLOAT_LAYERS)
    eng = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
    log(f"warmup graphed: {eng.warmup():.2f} s")
    # the logits each decode step sampled from, per request: the decode
    # step's static output row of each slot that decoded in it
    rows = {i: [] for i in range(len(prompts))}
    state = {"decoding": [], "steps": 0}

    def on_step(e, k):
        if e.sched.stats.decode_steps > state["steps"]:
            logits = e._steps["decode"].out[1]
            for rid, slot in state["decoding"]:
                rows[rid].append(logits[slot].clone())
            state["steps"] = e.sched.stats.decode_steps
        state["decoding"] = [(s.rid, s.slot) for s in e.sched.running
                             if not s.prefilling and not s.done]

    for i, p in enumerate(prompts):
        eng.submit(p, NEW_TOKENS, rid=i, arrival=2 * i)
    out = eng.run(on_step=on_step)
    assert all(c.ok and len(c.tokens) == NEW_TOKENS for c in out.values())
    eng.kv.check()
    log(f"run float: {eng.stats.decode_steps} decode steps in "
        f"{eng.stats.wall_s:.3f} s; {eng.stats.decode_tok_s:.2f} tok/s on "
        f"{card}")
    same, total, ties = 0, 0, 0
    for i, p in enumerate(prompts):
        tok = torch.tensor([p], dtype=torch.int32, device="cuda")
        want, _ = serve_loop.generate(params, cfg, tok, NEW_TOKENS)
        want = want[0].tolist()
        got = out[i].tokens
        engine_logits = [eng.first_logits[i]] + rows[i]
        assert len(engine_logits) == NEW_TOKENS, len(engine_logits)
        first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is None:
            same += NEW_TOKENS
            total += NEW_TOKENS
            log(f"request {i}: prompt {len(p)}; {NEW_TOKENS}/{NEW_TOKENS} "
                "tokens identical to one-shot")
            continue
        # the one-shot logits at the first divergent position, by the loop
        # generate runs (its tokens held to generate's up to there)
        logits, cache, kv_len = M.prefill(params, cfg, tok,
                                          max_len=len(p) + NEW_TOKENS)
        for j in range(first):
            t = torch.argmax(logits, -1).to(torch.int32)
            assert int(t[0]) == want[j]
            logits, cache, kv_len = M.serve_step(params, cfg, t, cache,
                                                 kv_len)
        ref = logits[0].float()
        top2 = torch.topk(ref, 2).values
        margin = (top2[0] - top2[1]).item()
        diff = (engine_logits[first].float() - ref).abs().max().item()
        same += first
        total += first + 1
        ties += 1
        log(f"request {i}: prompt {len(p)}; first divergence at position "
            f"{first} (engine {got[first]}, one-shot {want[first]}): "
            f"one-shot top-2 margin {margin:.3e}, max|engine - one-shot| "
            f"{diff:.3e}")
        assert margin < diff, \
            f"request {i}: divergence at {first} is no tie (margin {margin}" \
            f" >= difference {diff})"
    log(f"float gate: {same}/{total} compared tokens identical to one-shot "
        f"generate, {ties} divergences, each a tie within rounding")
    return {"same": same, "total": total, "ties": ties}


def main() -> int:
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
    torch.cuda.empty_cache()  # both packings are ~5.8 GB: free the first
    slided_launches, slided = phase_slided_engine(torch, card, compressed)
    torch.cuda.empty_cache()
    phase_float_gate(torch, card)
    prof, tok_s = slided["profile"], slided["tok_s"]
    for label, pr in prof.items():
        log(f"slided decode step, {label}: {pr['step_ms']:.3f} ms, host "
            f"share {pr['host_share']:.3f}, device idle share "
            f"{pr['idle_share']:.3f} ({card})")
    log(f"slided engine decode tok/s: eager {tok_s['eager']:.2f}, graphed "
        f"{tok_s['graphed']:.2f}, graphed + overlapped "
        f"{tok_s['overlapped']:.2f} ({card})")

    def entry(name, source, replaces, n, err, st):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
