"""Analytic roofline cost model of the port's kernels (port of
``repro.kernels.roofline``).

Every kernel has a closed-form device-memory byte and operation count as
a function of its operand shapes and the precision recipe.  This module
is the one source of those formulas and of the card's peak rates:

* ``chip_smoke.py`` prices every kernel it times with ``peaks(kind)`` and
  ``roofline_us``, and
* the split-count autotuner (``autotune.py``) prices each entry it
  records (``roofline_us``, ``efficiency``) and prunes candidates by
  ``tile_traffic``.

Modeling conventions (JAX's):

* Bytes are *minimal* traffic: each operand read once, each output
  written once.  Quantized operands count at their stored width: 1 byte
  for int8/e4m3, 0.5 bytes for nibble-packed 'w4'; the lifted
  activations of the single-pass fused GEMM count zero bytes.
* FLOPs are multiply-adds counted twice; relayout work (quantize, lift,
  decompress) is counted at a few operations per element.

Where the port departs: JAX prices activations and outputs at fp32, and
its kernels read and write fp32 there.  The port's kernels read bf16
activations and write bf16 outputs on the main path, so every function
takes the operand widths it would otherwise hard-code as keyword
arguments (``x_itemsize``, ``out_itemsize``, ``q_itemsize``,
``float_itemsize``), JAX's values the defaults, and ``op_cost`` reads
the activation and output dtypes from its key params (``xdt=``,
``odt=``).  Called with JAX's arguments every function returns JAX's
value.

``peaks(kind)`` on a CUDA device gives NVIDIA's published H100 SXM rates
(the compute peak by the operand type of the op; JAX calibrates the host
instead), on the CPU JAX's numpy calibration; ``REPRO_PEAK_BW_GBPS`` /
``REPRO_PEAK_GFLOPS`` override either.  ``measure_peaks()`` calibrates
the card (a device-to-device copy and a bf16 matmul, CUDA events) and is
never the default there.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time


@dataclasses.dataclass(frozen=True)
class Cost:
    """Analytic cost of one kernel call: minimal device bytes + FLOPs."""

    bytes: float
    flops: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.bytes + other.bytes, self.flops + other.flops)


# itemsize (bytes per element) by precision-axis or dtype name
_ITEMSIZE = {
    "int8": 1.0, "uint8": 1.0, "fp8": 1.0, "float8_e4m3fn": 1.0,
    "w4": 0.5, "int4": 0.5,
    "bfloat16": 2.0, "float16": 2.0,
    "float32": 4.0, "int32": 4.0,
}


_NAMES: dict = {}


def dtype_name(dtype) -> str:
    """'bfloat16' for ``torch.bfloat16`` (JAX's dtype names, the keys of
    ``itemsize``); other values as ``str``."""
    name = _NAMES.get(dtype)
    if name is None:
        name = _NAMES[dtype] = str(dtype).removeprefix("torch.")
    return name


def itemsize(name, default: float = 4.0) -> float:
    """Bytes per element for a recipe axis ('fp8', 'w4') or dtype name."""
    return _ITEMSIZE.get(dtype_name(name), default)


def _resolve(recipe):
    from repro_torch.core import precision  # deferred: core imports first
    return precision.resolve(recipe)


def lifted_k(k: int, n_fam: int) -> int:
    """gamma*K: the lifted contraction width of the (2N-2):2N family."""
    return (k // (2 * n_fam)) * (n_fam - 1) * 4


def compressed_k(k: int, n_fam: int) -> int:
    """Compressed slot count: K * (2N-2)/2N values (+ as many 2-bit ids,
    stored as int8 here)."""
    return (k // (2 * n_fam)) * (2 * n_fam - 2)


def sparse24_bytes(m: int, gk: int, packed: bool = False) -> int:
    """Bytes of B3's 2:4 operand of Phi(W) [m, gamma*K]
    (``fused_slide_matmul.sparse_operand``): two int8 values (nibbles for
    'w4') and a 4-bit metadata nibble per window of 4, in 16-row tiles and
    64-column k-steps, metadata padded to whole 4-step stages."""
    mt, ks = -(-m // 16), -(-gk // 64)
    values = mt * (-(-ks // 2) if packed else ks) * 512
    return values + mt * -(-ks // 4) * 512


# ------------------------------------------------------------ kernel costs
def dense_gemm(rows: int, k: int, m: int, x_itemsize: float = 4.0,
               w_itemsize: float = 4.0, out_itemsize: float = 4.0) -> Cost:
    """Plain dense GEMM y[R, M] = x[R, K] @ w[M, K]^T."""
    return Cost(rows * k * x_itemsize + k * m * w_itemsize
                + rows * m * out_itemsize, 2.0 * rows * k * m)


def fused_quant_slide(rows: int, k: int, n_fam: int, recipe="int8", *,
                      x_itemsize: float = 4.0) -> Cost:
    """Alg. 1 fused quantize+lift: read X, write Psi(q) + scales."""
    rec = _resolve(recipe)
    gk = lifted_k(k, n_fam)
    ab = itemsize(rec.act or "float32")
    # quantize = absmax + scale + clip/round + cast: ~4 ops/elt, plus
    # the lift relayout touching every lifted slot once
    return Cost(rows * k * x_itemsize + rows * gk * ab + rows * 4.0,
                4.0 * rows * k + rows * gk)


def quant_matmul(rows: int, k: int, m: int, x_itemsize: float = 1.0,
                 w_itemsize: float = 1.0, *,
                 out_itemsize: float = 4.0) -> Cost:
    """Dense quantized GEMM on pre-quantized operands (+ scales, dequant)."""
    return Cost(rows * k * x_itemsize + rows * 4.0
                + k * m * w_itemsize + m * 4.0 + rows * m * out_itemsize,
                2.0 * rows * k * m)


def fused_slided_matmul(rows: int, k: int, m: int, n_fam: int,
                        recipe="int8", *, x_itemsize: float = 4.0,
                        out_itemsize: float = 4.0) -> Cost:
    """Single-pass fused GEMM: quant+lift in the prologue; the lifted
    gamma*K activations never reach device memory (the paper's §4.2
    saving)."""
    rec = _resolve(recipe)
    gk = lifted_k(k, n_fam)
    wb = itemsize(rec.weight or "float32")
    return Cost(rows * k * x_itemsize + m * gk * wb + m * 4.0
                + rows * m * out_itemsize,
                2.0 * rows * gk * m + 4.0 * rows * k)


def two_kernel(rows: int, k: int, m: int, n_fam: int, recipe="int8", *,
               x_itemsize: float = 4.0, out_itemsize: float = 4.0) -> Cost:
    """fused_quant_slide -> quant_matmul: the baseline the single-pass
    kernel beats by exactly one round trip of the lifted activations."""
    rec = _resolve(recipe)
    gk = lifted_k(k, n_fam)
    return (fused_quant_slide(rows, k, n_fam, rec, x_itemsize=x_itemsize)
            + quant_matmul(rows, gk, m, itemsize(rec.act or "float32"),
                           itemsize(rec.weight or "float32"),
                           out_itemsize=out_itemsize))


def compressed_matmul(rows: int, k: int, m: int, n_fam: int,
                      recipe=None, *, float_itemsize: float = 4.0,
                      out_itemsize: float = 4.0) -> Cost:
    """Decompress-once compressed GEMM: weights stream at density bytes
    (values + int8 position ids), dense FLOPs in the original K layout.
    ``float_itemsize``: x and the values on the float path (recipe None)."""
    kc = compressed_k(k, n_fam)
    if recipe is None:
        xb, wb = float_itemsize, float_itemsize  # float path
    else:
        rec = _resolve(recipe)
        xb = itemsize(rec.act or "float32")
        wb = itemsize(rec.weight or "float32")
    return Cost(rows * k * xb + rows * 4.0 + m * kc * (wb + 1.0) + m * 4.0
                + rows * m * out_itemsize,
                2.0 * rows * k * m + 8.0 * m * kc)


def pool_gather(batch: int, table_tokens: int, kv_heads: int, head_dim: int,
                kv_itemsize: float = 4.0, scales: bool = False,
                out_itemsize: float = 4.0) -> Cost:
    """The rearrange tax of ``models.attention._pool_gather``: read K+V
    for EVERY page-table slot at stored width (+ fp32 scale rows when the
    pool is int8) and write the dequantized contiguous copy at compute
    width.  ``table_tokens`` is maxp * page_size, pool capacity per
    sequence, not valid tokens.  Locked to the gather counter
    (``attention.gather_bytes``) in tests/test_torch_roofline.py."""
    elems = batch * table_tokens * kv_heads * head_dim
    by = 2.0 * elems * (kv_itemsize + out_itemsize)
    fl = 0.0
    if scales:
        by += 2.0 * batch * table_tokens * kv_heads * 4.0
        fl = 2.0 * elems  # dequant multiply + cast per element
    return Cost(by, fl)


def paged_attention_decode(batch: int, kv_len: int, kv_heads: int,
                           head_dim: int, q_heads: int | None = None,
                           kv_itemsize: float = 4.0,
                           gather_tokens: int | None = None,
                           gather_scales: bool = False, *,
                           q_itemsize: float = 4.0) -> Cost:
    """One decode step of paged attention: the K/V pages of every active
    sequence stream once; q in and out at ``q_itemsize``.

    With ``gather_tokens`` (the per-sequence table capacity maxp * page_
    size) this prices the gather path instead: the gathered copy at the
    query width (``pool_gather``), then attention over every table slot."""
    q_heads = q_heads or kv_heads
    if gather_tokens is not None:
        return (pool_gather(batch, gather_tokens, kv_heads, head_dim,
                            kv_itemsize, gather_scales, q_itemsize)
                + paged_attention_decode(batch, gather_tokens, kv_heads,
                                         head_dim, q_heads, q_itemsize,
                                         q_itemsize=q_itemsize))
    kv_bytes = 2.0 * batch * kv_len * kv_heads * head_dim * kv_itemsize
    return Cost(kv_bytes + batch * q_heads * head_dim * q_itemsize * 2.0,
                4.0 * batch * q_heads * kv_len * head_dim)


def paged_attention_verify(batch: int, kv_len: int, lanes: int,
                           kv_heads: int, head_dim: int,
                           q_heads: int | None = None,
                           kv_itemsize: float = 4.0,
                           gather_tokens: int | None = None,
                           gather_scales: bool = False, *,
                           q_itemsize: float = 4.0) -> Cost:
    """One speculative verify step: the K/V pages stream once as in a
    decode step, plus ``lanes = K+1`` query rows' q/out traffic and
    attention FLOPs.  At lanes == 1 this is ``paged_attention_decode``."""
    q_heads = q_heads or kv_heads
    if gather_tokens is not None:
        return (pool_gather(batch, gather_tokens, kv_heads, head_dim,
                            kv_itemsize, gather_scales, q_itemsize)
                + paged_attention_verify(batch, gather_tokens, lanes,
                                         kv_heads, head_dim, q_heads,
                                         q_itemsize, q_itemsize=q_itemsize))
    kv_bytes = 2.0 * batch * kv_len * kv_heads * head_dim * kv_itemsize
    return Cost(kv_bytes
                + lanes * batch * q_heads * head_dim * q_itemsize * 2.0,
                lanes * 4.0 * batch * q_heads * kv_len * head_dim)


def cow_copy(pairs: int, page_size: int, kv_heads: int, head_dim: int,
             layers: int, kv_itemsize: float = 4.0) -> Cost:
    """Copy-on-write page forks: each pair reads + writes one K and one V
    page per attention layer."""
    per_pair = 2.0 * page_size * kv_heads * head_dim * kv_itemsize * layers
    return Cost(2.0 * pairs * per_pair, 0.0)


# ----------------------------------------------------------------- peaks
@dataclasses.dataclass(frozen=True)
class Peaks:
    """Peak rates ``roofline_us`` divides a cost by."""

    bw_gbps: float
    gflops: float


# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at its 700 W limit:
# device memory 3.35 TB/s; tensor cores 989 TFLOP/s bf16/fp16, 1,979
# fp8 and int8 TOP/s, 495 TF32; 67 TFLOP/s fp32 outside them
H100_BW_GBPS = 3350.0
H100_GFLOPS = {"bfloat16": 989e3, "float16": 989e3, "int8": 1979e3,
               "fp8": 1979e3, "float8_e4m3fn": 1979e3, "tf32": 495e3,
               "float32": 67e3}

_PEAKS: dict = {}


def peak_kind(name) -> str:
    """The published peak's key for an operand type: 'int8', 'fp8', a
    dtype name; bf16's for None or an unknown name."""
    name = dtype_name(name) if name is not None else "bfloat16"
    return name if name in H100_GFLOPS else "bfloat16"


def _on_card() -> bool:
    import torch
    return torch.cuda.is_available()


def measure_peaks() -> Peaks:
    """Calibrate the executing machine: on a CUDA device a best-of
    device-to-device copy of 1 GiB (bandwidth) and a bf16 8192^3
    ``torch.matmul`` (FLOPs), timed with CUDA events; on the CPU JAX's
    numpy calibration (a streaming copy and a BLAS matmul)."""
    if _on_card():
        return _measure_card()
    import numpy as np
    src = np.ones(8 * 1024 * 1024, np.float32)  # 32 MB
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    bw = 2.0 * src.nbytes / best / 1e9  # read + write

    n = 384
    a = np.ones((n, n), np.float32)
    b = np.ones((n, n), np.float32)
    a @ b  # warm BLAS threads
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    gf = 2.0 * n ** 3 / best / 1e9
    return Peaks(bw_gbps=bw, gflops=gf)


def _measure_card() -> Peaks:
    import torch

    def best_ms(fn, reps=5):
        fn()
        best = float("inf")
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    src = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    bw = 2.0 * src.numel() / (best_ms(lambda: dst.copy_(src)) * 1e-3) / 1e9
    del src, dst
    n = 8192
    a = torch.randn((n, n), dtype=torch.bfloat16, device="cuda")
    b = torch.randn((n, n), dtype=torch.bfloat16, device="cuda")
    gf = 2.0 * n ** 3 / (best_ms(lambda: torch.matmul(a, b)) * 1e-3) / 1e9
    return Peaks(bw_gbps=bw, gflops=gf)


def peaks(kind=None, refresh: bool = False) -> Peaks:
    """Peak rates for ops on operands of type ``kind`` ('int8', 'fp8',
    'bfloat16', ...; None: bf16).  On a CUDA device the H100's published
    rates (the compute peak by ``kind``), on the CPU the cached numpy
    calibration (``kind`` ignored); ``REPRO_PEAK_BW_GBPS`` /
    ``REPRO_PEAK_GFLOPS`` pin either rate."""
    key = peak_kind(kind)
    if refresh:
        _PEAKS.clear()
    if key not in _PEAKS:
        env_bw = os.environ.get("REPRO_PEAK_BW_GBPS")
        env_gf = os.environ.get("REPRO_PEAK_GFLOPS")
        if env_bw and env_gf:
            _PEAKS[key] = Peaks(float(env_bw), float(env_gf))
        else:
            if _on_card():
                base = Peaks(H100_BW_GBPS, H100_GFLOPS[key])
            else:
                if "host" not in _PEAKS:
                    _PEAKS["host"] = measure_peaks()
                base = _PEAKS["host"]
            _PEAKS[key] = Peaks(float(env_bw) if env_bw else base.bw_gbps,
                                float(env_gf) if env_gf else base.gflops)
    return _PEAKS[key]


def roofline_us(cost: Cost, p: Peaks | None = None) -> float:
    """max(bytes/peak_bw, flops/peak_flops) in microseconds: the no-
    overhead floor for one call of the modeled kernel."""
    p = p or peaks()
    return max(cost.bytes / (p.bw_gbps * 1e9),
               cost.flops / (p.gflops * 1e9)) * 1e6


def bound_by(cost: Cost, p: Peaks | None = None) -> str:
    """'bytes' or 'operations': the term ``roofline_us`` takes."""
    p = p or peaks()
    return ("bytes" if cost.bytes / (p.bw_gbps * 1e9)
            >= cost.flops / (p.gflops * 1e9) else "operations")


def efficiency(cost: Cost, measured_us: float, p: Peaks | None = None) -> float:
    """roofline_us / measured_us in (0, 1]: 1.0 = at the bound; values
    > 1 flag a broken model or a mis-measured kernel."""
    if measured_us <= 0:
        return 0.0
    return roofline_us(cost, p) / measured_us


# ------------------------------------------------- autotune integration
def _pattern_n(params) -> int | None:
    pat = params.get("pattern")
    if not pat:
        return None
    try:
        _, l = str(pat).split(":")
        return int(l) // 2
    except ValueError:
        return None


def op_cost(op: str, rows: int, m: int, k: int, **params) -> Cost | None:
    """Analytic :class:`Cost` for an autotune op key, or None when the op
    (or its parameters) are not modeled.  ``params`` are the autotune
    cache-key components (pattern / adt / wdt / dtype...); ``xdt`` and
    ``odt`` name the activation and output dtypes where the kernel reads
    or writes other than fp32 (the port's bf16), ``wfmt="2:4"`` B3's
    weights as the port's 2:4 operand (``sparse24_bytes``) and its
    products as ``mma.sp``'s, the non-zero ones."""
    n = _pattern_n(params)
    adt, wdt = params.get("adt"), params.get("wdt")
    xb = itemsize(params.get("xdt"))
    ob = itemsize(params.get("odt"))
    if op == "fused_quant_slide" and n:
        return fused_quant_slide(rows, k, n,
                                 "fp8" if str(adt) == "fp8" else "int8",
                                 x_itemsize=xb)
    if op == "quant_matmul":
        return quant_matmul(rows, k, m, itemsize(adt), itemsize(wdt),
                            out_itemsize=ob)
    if op == "compressed_matmul" and n:
        kc = compressed_k(k, n)
        return Cost(rows * k * itemsize(adt) + rows * 4.0
                    + m * kc * (itemsize(wdt) + 1.0) + m * 4.0
                    + rows * m * ob, 2.0 * rows * k * m + 8.0 * m * kc)
    if op == "fused_slided_matmul" and n:
        gk = lifted_k(k, n)
        # JAX's kernel streams Phi(W) whole and multiplies every slot;
        # the port's reads its 2:4 operand and runs mma.sp, which does
        # the two non-zero products of each window of 4 (half the dense
        # count at the dense peak = the dense count at mma.sp's rate)
        if params.get("wfmt") == "2:4":
            wb = sparse24_bytes(m, gk, str(wdt) == "w4")
            products = rows * (gk // 2) * m
        else:
            wb, products = m * gk * itemsize(wdt), rows * gk * m
        return Cost(rows * k * xb + wb + m * 4.0
                    + rows * m * ob, 2.0 * products + 4.0 * rows * k)
    if op == "paged_attention":
        # key convention: rows = batch * lanes, m = kv_heads * head_dim,
        # k = the tokens a sequence reads.  The key and the dry run pass
        # the table's capacity, the static shape (an upper bound of the
        # traffic); a tuned entry's bound passes the mean tokens its
        # timed call read (``autotune``'s ``priced_k``).
        kvh, hd = params.get("kvh"), params.get("hd")
        lanes = int(params.get("lanes") or 1)
        if kvh and hd:
            return paged_attention_verify(
                max(1, rows // lanes), k, lanes, int(kvh), int(hd),
                int(params.get("qh") or kvh), itemsize(adt), q_itemsize=xb)
    return None


def tile_traffic(op: str, rows: int, m: int, k: int,
                 br: int | None, bm: int | None, *,
                 splits: int | None = None, **params) -> float | None:
    """Modeled traffic (bytes) of one call at a candidate tiling: the
    quantity autotune prunes on.  JAX's (br, bm) tile models, and the
    port's split counts of the reduction (``splits``: B1's K, B3's
    gamma*K), whose every split past the first writes and re-reads one
    int32 [R, M] partial.  None for unknown ops or unspecified
    (kernel-default) tiles."""
    adt, wdt = params.get("adt"), params.get("wdt")
    n = _pattern_n(params)
    out = rows * m * 4.0
    if splits and op in ("compressed_matmul", "fused_slided_matmul") and n:
        base = op_cost(op, rows, m, k, **params)
        partials = 2.0 * splits * rows * m * 4.0 if splits > 1 else 0.0
        return base.bytes + partials
    if op == "quant_matmul" and br and bm:
        # grid (R, M, K): x re-read per M tile, w re-read per R tile
        return (rows * k * itemsize(adt) * math.ceil(m / bm)
                + m * k * itemsize(wdt) * math.ceil(rows / br) + out)
    if op == "compressed_matmul" and n and bm:
        # grid (M, R) R-innermost: weights decompressed once per M tile,
        # x re-read per M tile
        kc = compressed_k(k, n)
        return (rows * k * itemsize(adt) * math.ceil(m / bm)
                + m * kc * (itemsize(wdt) + 1.0) + out)
    if op == "fused_slided_matmul" and n and br:
        # grid (R, M) M-innermost: x read once per R tile (same block
        # across M steps), w re-read per R tile
        gk = lifted_k(k, n)
        return (rows * k * 4.0
                + m * gk * itemsize(wdt) * math.ceil(rows / br) + out)
    if op == "paged_attention" and br:
        # K/V pages stream once regardless of the split count (br = S
        # splits); each extra split writes + re-reads one more
        # unnormalized (acc, m, l) partial per cell
        kvh, hd = params.get("kvh"), params.get("hd")
        lanes = int(params.get("lanes") or 1)
        qh = int(params.get("qh") or kvh or 0)
        if kvh and hd:
            batch = max(1, rows // lanes)
            kv = 2.0 * batch * k * int(kvh) * int(hd) * itemsize(adt)
            partials = 2.0 * br * batch * qh * lanes * (int(hd) + 2) * 4.0
            return kv + partials + batch * qh * lanes * int(hd) * 4.0 * 2.0
    return None
