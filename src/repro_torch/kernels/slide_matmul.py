"""Wrapper of the CUDA compressed-weight matmul (``csrc/compressed_matmul.cu``).

The port of ``repro.kernels.slide_matmul.compressed_matmul_pallas``:
``y[R, M] = act((x @ decompress(values, indices)^T) (* s_x * s_w) (+ bias))``
with the slide undone during decompression.  ``launch_count`` counts the
wrapper's launches (a CUDA graph replay adds those its capture recorded,
``ops.recorded_launches``).  ``decompress_count`` is the analog of the Pallas
kernel's decompression counter: weight tiles decompressed into shared
memory per call.  The int8/w4 decode instance (R <= DECODE_MAX_R) builds
no tile (0); the int8/w4 prefill instance decompresses each (PF_BM x
stage) tile once per PF_BR activation rows; the float path (e4m3, bf16,
f32) decompresses each (BM x BK_MAX) tile once per row block.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DECODE_MAX_R = 16  # int8/w4: R at or below runs the decode instance (csrc)
PF_BM = 64         # prefill: weight rows per block (csrc PF_BM)
PF_BR = 128        # prefill: activation rows per block (csrc PF_BR)
MIN_SPLIT_STAGES = 4  # prefill: K stages a split of K keeps at least
SMS = 132          # streaming multiprocessors of the H100 SXM
BM = 64            # float path: weight rows per block (csrc BM)
BK_MAX = 64        # float path: dense K per stage (csrc BK_MAX)
_XMODE = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.bfloat16: 2,
          torch.float32: 3}
_ACT = {None: 0, "silu": 1, "gelu": 2}
_COUNTS = {"launches": 0, "decompress": 0}


def launch_count() -> int:
    return _COUNTS["launches"]


def decompress_count() -> int:
    return _COUNTS["decompress"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0
    _COUNTS["decompress"] = 0


@functools.cache
def _fn():
    fn = _build.load("compressed_matmul").compressed_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def prefill_stage(n_fam: int) -> int:
    """Dense K columns per stage of the prefill instance (csrc PfTile::BK):
    whole window groups and a multiple of the mma's k = 32."""
    return 96 if n_fam == 3 else 64


def prefill_splits(rows: int, m: int, k: int, n_fam: int) -> int:
    """Splits of K for the int8/w4 prefill instance, a pure function of the
    shapes: enough blocks for one per SM where the (M / PF_BM) x (R / PF_BR)
    tiles alone are fewer, each split keeping MIN_SPLIT_STAGES stages."""
    tiles = -(-m // PF_BM) * -(-rows // PF_BR)
    stages = -(-k // prefill_stage(n_fam))
    return max(1, min(-(-SMS // tiles), stages // MIN_SPLIT_STAGES))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"compressed_matmul_cuda: {msg}")


def compressed_matmul_cuda(x: torch.Tensor, values: torch.Tensor,
                           indices: torch.Tensor, s_x: torch.Tensor | None,
                           s_w: torch.Tensor | None,
                           bias: torch.Tensor | None = None, *, n_fam: int,
                           packed: bool = False,
                           out_dtype: torch.dtype = torch.float32,
                           activation: str | None = None,
                           splits: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    x: [R, K] int8 | float8_e4m3fn (quantized recipes, s_x [R, 1] and
    s_w [M, 1] fp32 required) or bf16 | f32 (float path, values of the same
    dtype, scales ignored).  values: [M, 0.75K]-style slots ([M, slots/2]
    uint8/int8 bytes when ``packed``); indices: [M, slots] int8.  bias:
    [M] fp32 or None.  out_dtype: bf16 or f32.  ``splits``: the int8/w4
    prefill instance's split count of K (None: ``prefill_splits``; the
    other instances take 1)."""
    _need(x.is_cuda, "x must be a CUDA tensor (CPU tensors take the plain "
          "version in kernels.ref)")
    _need(n_fam in (2, 3, 4), f"n_fam={n_fam} not in (2, 3, 4)")
    _need(x.dtype in _XMODE, f"unsupported activation dtype {x.dtype}")
    _need(out_dtype in (torch.bfloat16, torch.float32),
          f"unsupported out_dtype {out_dtype}")
    _need(activation in _ACT, f"unsupported activation {activation!r}")
    rows, k = x.shape
    m, slots = indices.shape
    l = 2 * n_fam
    _need(k % l == 0, f"K={k} not a multiple of L={l}")
    _need(slots == k // l * (l - 2), f"indices width {slots} != "
          f"{k // l * (l - 2)} slots for K={k}")
    quantized = x.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized:
        _need(values.dtype in (torch.int8, torch.uint8),
              f"quantized values must be int8 bytes, got {values.dtype}")
        _need(values.shape == (m, slots // 2 if packed else slots),
              f"values shape {tuple(values.shape)} for packed={packed}")
        _need(s_x is not None and s_w is not None, "s_x and s_w required")
        _need(s_x.shape == (rows, 1) and s_w.shape == (m, 1)
              and s_x.dtype == s_w.dtype == torch.float32,
              "s_x [R, 1] and s_w [M, 1] must be fp32")
    else:
        _need(not packed, "the float path takes no packed values")
        _need(values.dtype == x.dtype and values.shape == (m, slots),
              f"float values must be {x.dtype} [M, slots]")
    _need(indices.dtype == torch.int8, "indices must be int8")
    if bias is not None:
        _need(bias.shape == (m,) and bias.dtype == torch.float32,
              "bias must be fp32 [M]")
    operands = [x, values, indices, bias] + ([s_x, s_w] if quantized else [])
    for t in (t for t in operands if t is not None):
        _need(t.device == x.device, "all operands on one device")
        _need(t.is_contiguous(), "operands must be contiguous")

    integer = x.dtype == torch.int8
    if not (integer and rows > DECODE_MAX_R):
        splits = 1
    elif splits is None:
        splits = prefill_splits(rows, m, k, n_fam)
    _need(splits >= 1, f"splits={splits} < 1")
    out = torch.empty((rows, m), dtype=out_dtype, device=x.device)
    part = (torch.empty((splits, rows, m), dtype=torch.int32, device=x.device)
            if splits > 1 else None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _fn()(ptr(x), ptr(values), ptr(indices),
                ptr(s_x) if quantized else None,
                ptr(s_w) if quantized else None, ptr(bias), ptr(out),
                ptr(part), rows, m, k, n_fam, _XMODE[x.dtype], int(packed),
                int(out_dtype == torch.bfloat16), _ACT[activation], splits,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "compressed_matmul_launch")
    _COUNTS["launches"] += 1
    _COUNTS["decompress"] += decompressed_tiles(rows, m, k, n_fam, integer)
    return out


def decompressed_tiles(rows: int, m: int, k: int, n_fam: int,
                       integer: bool) -> int:
    """Weight tiles one call decompresses into shared memory."""
    groups = k // (2 * n_fam)
    if integer:
        if rows <= DECODE_MAX_R:
            return 0
        per_stage = prefill_stage(n_fam) // (2 * n_fam)
        return -(-m // PF_BM) * -(-groups // per_stage) * -(-rows // PF_BR)
    br = 64 if rows > 16 else 16
    per_stage = BK_MAX // (2 * n_fam)
    return -(-m // BM) * -(-rows // br) * -(-groups // per_stage)
