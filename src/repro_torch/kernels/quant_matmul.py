"""Wrapper of the CUDA dense quantized matmul (``csrc/quant_matmul.cu``).

The port of ``repro.kernels.quant_matmul.quant_matmul_pallas``:
``y[R, M] = act((q_x @ q_w^T) * s_x * s_w + bias)`` over int8 or e4m3
operands.  Rows at or below ``DECODE_MAX_R`` take the decode instance
(a warp per weight row), more rows a tensor-core instance (``wgmma`` for
int8 x int8, f16 ``mma.sync`` with an e4m3 operand).  The contraction
splits by :func:`splits_for` into shares of :func:`share_for` bytes,
summed in split order (plain mirror: ``ref.quant_matmul_split``): by a
second kernel, or for the int8 prefill instance within a cluster.
``launch_count`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DECODE_MAX_R = 16   # R at or below: the decode instance (csrc DECODE_MAX_R)
DEC_WARPS = 8       # decode: weight rows per block (csrc DEC_WARPS)
DEC_SMEM = 64 * 1024  # decode: most bytes of x a block stages (csrc DEC_SMEM)
MIN_SHARE = 4096    # decode: contraction bytes a split keeps at least
PREFILL_TILE = 128  # prefill: activation and weight rows a block (csrc WG_BR)
PREFILL_BK = 128    # prefill: contraction bytes a stage (csrc WG_BK)
MIN_SPLIT_STAGES = 4  # prefill: stages a split keeps at least
MAX_CLUSTER = 8     # prefill: a tile's splits form one cluster (csrc)
SMS = 132           # streaming multiprocessors of the H100 SXM
_ACT = {None: 0, "silu": 1, "gelu": 2}
_QTYPES = (torch.int8, torch.float8_e4m3fn)
_COUNTS = {"launches": 0}


def launch_count() -> int:
    return _COUNTS["launches"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0


@functools.cache
def _fn():
    fn = _build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def decode_rows(rows: int) -> int:
    """Activation rows the decode instance holds for ``rows`` (its RB)."""
    return 4 if rows <= 4 else 8 if rows <= 8 else 16


def _prefill_tiles(rows: int, m: int) -> int:
    return _ceil(m, PREFILL_TILE) * _ceil(rows, PREFILL_TILE)


def prefill_stages(rows: int, m: int) -> int:
    """Ring depth of the int8 prefill instance: 4 where the tiles fit one
    block an SM (the deepest ring for a streamed weight), 3 where they
    do not (two blocks an SM, so one's prologue and epilogue run under
    the other's main loop)."""
    return 4 if _prefill_tiles(rows, m) <= SMS else 3


def share_for(rows: int, k: int, splits: int) -> int:
    """Contraction bytes of each of ``splits`` shares: a multiple of 16
    at decode (the lanes' pieces), of PREFILL_BK at prefill (whole
    stages)."""
    unit = 16 if rows <= DECODE_MAX_R else PREFILL_BK
    return _ceil(_ceil(k, splits), unit) * unit


@functools.lru_cache(maxsize=None)
def splits_for(rows: int, m: int, k: int) -> int:
    """Splits of the contraction, a pure function of the shapes.

    Decode: enough blocks for one per SM where the M / DEC_WARPS row
    blocks are fewer and each share keeps MIN_SHARE bytes (below that a
    reduce launch costs more than the split saves), and at least as many
    as keep each share of x, RB rows of it, within DEC_SMEM.  Prefill:
    as many as keep the tiles' blocks within one wave of one block an SM
    (at most MAX_CLUSTER, each keeping MIN_SPLIT_STAGES stages); none
    where the tiles alone fill the card, since the cluster's reduction
    then costs more than the split saves.  No split count leaves a share
    empty."""
    if rows <= DECODE_MAX_R:
        blocks = _ceil(m, DEC_WARPS)
        want = min(_ceil(SMS, blocks), max(1, k // MIN_SHARE))
        fit = _ceil(k, DEC_SMEM // decode_rows(rows))
        s = max(want, fit)
    else:
        s = max(1, min(SMS // _prefill_tiles(rows, m), MAX_CLUSTER,
                       _ceil(k, PREFILL_BK) // MIN_SPLIT_STAGES))
    return _ceil(k, share_for(rows, k, s))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quant_matmul_cuda: {msg}")


def _padded(t: torch.Tensor, k: int) -> torch.Tensor:
    """t [rows, K] bytes with K zero-padded to ``k`` columns, in a new
    16-byte aligned allocation (zeros add nothing to either sum)."""
    p = torch.zeros((t.shape[0], k), dtype=torch.uint8, device=t.device)
    p[:, :t.shape[1]] = t.view(torch.uint8)
    return p.view(t.dtype)


def quant_matmul_cuda(q_x: torch.Tensor, s_x: torch.Tensor,
                      q_w: torch.Tensor, s_w: torch.Tensor,
                      bias: torch.Tensor | None = None, *,
                      out_dtype: torch.dtype = torch.float32,
                      activation: str | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    q_x: [R, K] int8 | float8_e4m3fn; s_x: [R, 1] fp32; q_w: [M, K] int8 |
    float8_e4m3fn; s_w: [M, 1] fp32; bias: [M] fp32 or None.  out_dtype:
    bf16 or f32.  Above DECODE_MAX_R rows the tensor-core instances read
    16-byte aligned rows: where K % 16 != 0 (or a row is misaligned) the
    wrapper first copies both operands into zero-padded ones, R*K + M*K
    bytes read and R*Kp + M*Kp written per call (Kp = K rounded up to
    16); no shape of the model's linears needs it."""
    _need(q_x.is_cuda, "q_x must be a CUDA tensor (CPU tensors take the "
          "plain version in kernels.ref)")
    _need(q_x.dtype in _QTYPES and q_w.dtype in _QTYPES,
          f"operands must be int8 or float8_e4m3fn, got {q_x.dtype} x "
          f"{q_w.dtype}")
    _need(out_dtype in (torch.bfloat16, torch.float32),
          f"unsupported out_dtype {out_dtype}")
    _need(activation in _ACT, f"unsupported activation {activation!r}")
    _need(q_x.dim() == 2 and q_w.dim() == 2
          and q_x.shape[1] == q_w.shape[1],
          f"shapes {tuple(q_x.shape)} x {tuple(q_w.shape)} do not contract")
    rows, k = q_x.shape
    m = q_w.shape[0]
    _need(s_x.shape == (rows, 1) and s_w.shape == (m, 1)
          and s_x.dtype == s_w.dtype == torch.float32,
          "s_x [R, 1] and s_w [M, 1] must be fp32")
    if bias is not None:
        _need(bias.shape == (m,) and bias.dtype == torch.float32,
              "bias must be fp32 [M]")
    for t in (t for t in (q_x, s_x, q_w, s_w, bias) if t is not None):
        _need(t.device == q_x.device, "all operands on one device")
        _need(t.is_contiguous(), "operands must be contiguous")

    if rows > DECODE_MAX_R and (k % 16 or q_x.data_ptr() % 16
                                or q_w.data_ptr() % 16):
        k = _ceil(k, 16) * 16
        q_x, q_w = _padded(q_x, k), _padded(q_w, k)
    splits = splits_for(rows, m, k)
    ints = q_x.dtype == q_w.dtype == torch.int8
    out = torch.empty((rows, m), dtype=out_dtype, device=q_x.device)
    # partial sums in device memory, but for the int8 prefill instance,
    # whose splits sum in a cluster
    part = (torch.empty((splits, rows, m),
                        dtype=torch.int32 if ints else torch.float32,
                        device=q_x.device)
            if splits > 1 and (rows <= DECODE_MAX_R or not ints) else None)
    err = _fn()(q_x.data_ptr(), s_x.data_ptr(), q_w.data_ptr(),
                s_w.data_ptr(), bias.data_ptr() if bias is not None else None,
                out.data_ptr(), part.data_ptr() if part is not None else None,
                rows, m, k, int(q_x.dtype == torch.float8_e4m3fn),
                int(q_w.dtype == torch.float8_e4m3fn),
                int(out_dtype == torch.bfloat16), _ACT[activation], splits,
                share_for(rows, k, splits), prefill_stages(rows, m),
                torch.cuda.current_stream(q_x.device).cuda_stream)
    _build.check(err, "quant_matmul_launch")
    _COUNTS["launches"] += 1
    return out
