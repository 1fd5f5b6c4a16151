"""Wrapper of the CUDA fused slided matmul (``csrc/fused_slided_matmul.cu``).

The port of ``repro.kernels.fused_slide_matmul.fused_slided_matmul_pallas``:
``y[R, M] = act((Psi(q(x)) @ Phi(W)^T) * s_x * s_w + bias)`` in one
kernel, the per-token quantization and the lift in its prologue.  The
kernel reads Phi(W) as the 2:4 operand of Hopper's sparse tensor cores
(``mma.sp`` m16n8k64): per window of 4 lifted columns its two kept values
and their two 2-bit positions, laid out in the instruction's fragment
order by :func:`sparse_operand` (inverse: :func:`dense_from_operand`).
``launch_count`` counts the kernel's launches (a CUDA graph replay adds
those its capture recorded, ``ops.recorded_launches``), and
``_COUNTS["act_absmax"]`` those of them given the rows' absmax
(``act_absmax``: a tensor-parallel run's global one), which skip the
kernel's own absmax pass.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import packer

from . import _build

_ACT = {None: 0, "silu": 1, "gelu": 2}
_COUNTS = {"launches": 0, "act_absmax": 0}

KSTEP = 64          # lifted columns of one mma.sp (k64): 16 windows
STAGE_KS = 4        # k-steps per kernel stage: one 16-byte metadata load
TILE_M = 16         # weight rows of one A fragment
DECODE_MAX_R = 8    # R at or below: the decode instance (one n8 tile)
# weight rows x activation rows of a block of the decode and prefill
# instances (csrc/fused_slided_matmul.cu::launch_int)
DECODE_BLOCK = (128, 8)
PREFILL_BLOCK = (256, 64)
MIN_SPLIT_STAGES = 2  # stages each split of gamma*K keeps at least
DEC_MAX_STAGES = 32   # decode: stages a split lifts into shared memory
_SMS = 132          # H100 SXM streaming multiprocessors
_DEFAULT_META = 0x44444444  # every window's pair (0, 1)


def launch_count() -> int:
    return _COUNTS["launches"]


def act_absmax_count() -> int:
    return _COUNTS["act_absmax"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0
    _COUNTS["act_absmax"] = 0


def lifted_width(k: int, n_fam: int) -> int:
    """gamma*K of the (2N-2):2N -> 2:4 lift: N-1 windows of 4 per group."""
    return k // (2 * n_fam) * (n_fam - 1) * 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def sparse_operand(w_slided: torch.Tensor, packed: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phi(W) -> the kernel's 2:4 operand ``(values, meta)``.

    w_slided: [M, gamma*K] int8, or [M, gamma*K/2] nibble bytes when
    ``packed`` ('w4').  Every window of 4 columns holds at most 2
    non-zeros.  Each window keeps two slots at increasing positions
    ``p0 < p1`` (its non-zeros, then the lowest zero positions; swapping
    moves only a zero, so Phi(W) is unchanged), which is the order
    ``mma.sp::ordered_metadata`` requires.  M pads to 16 rows and gamma*K
    to 64 columns with zero values and the pair (0, 1).

    Fragment order (the PTX ISA's m16n8k64 .s8 layouts, confirmed on the
    card): for row tile ``mt`` (16 rows) and k-step ``ks`` (64 lifted
    columns, 32 kept values a row), lane ``L = 4g + t`` holds the 16
    bytes ``j, b`` (register j, byte b) of row ``g + 8 (j & 1)``, kept
    value ``4t + b + 16 (j >> 1)``; its metadata word holds, in nibble
    ``i``, ``p0 | p1 << 2`` of row ``g + 8 (t & 1)``, window
    ``8 (t >> 1) + i``.

    values: int8 [Mt, KS, 32, 16] (lane L's A fragment of (mt, ks) is 16
    contiguous bytes), or for 'w4' [Mt, ceil(KS/2), 32, 16] with the two
    k-steps of a pair nibble-packed into 8 bytes each.  meta: int32
    [Mt, ceil(KS/4), 32, 4], word q of lane L the metadata of k-step
    ``4 kq + q``.  A lane loads each with 16-byte loads."""
    ws = packer.unpack_nibbles(w_slided) if packed else w_slided
    if ws.dim() != 2 or ws.dtype != torch.int8:
        raise ValueError(f"Phi(W) must be 2-D int8, got {tuple(ws.shape)} "
                         f"{ws.dtype}")
    m, gk = ws.shape
    if gk % 4:
        raise ValueError(f"gamma*K={gk} is not a multiple of the window 4")
    mt, ks = _ceil(m, TILE_M), _ceil(gk, KSTEP)
    w = torch.nn.functional.pad(ws, (0, ks * KSTEP - gk, 0, mt * TILE_M - m))
    wv = w.reshape(mt * TILE_M, ks * 16, 4)
    nz = wv != 0
    if bool((nz.sum(-1) > 2).any()):
        raise ValueError("Phi(W) has a window with more than 2 non-zeros")
    # non-zeros first (position order), then zeros; keep two, sorted
    key = (torch.arange(4, dtype=torch.int32, device=ws.device)
           + 4 * (~nz).to(torch.int32))
    pos = torch.sort(torch.argsort(key, dim=-1)[..., :2], dim=-1).values
    vals = torch.take_along_dim(wv, pos, dim=-1)       # [Mp, W, 2]
    # values: [mt, h, g, ks, q, t, b] -> [mt, ks, g, t, q, h, b]
    a = vals.reshape(mt, 2, 8, ks, 2, 4, 4).permute(0, 3, 2, 5, 4, 1, 6)
    a = a.reshape(mt, ks, 32, 16)
    if packed:
        if ks % 2:
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
        a = packer.pack_nibbles(a).reshape(mt, -1, 2, 32, 8)
        a = a.permute(0, 1, 3, 2, 4).reshape(mt, -1, 32, 16)
    # metadata: [mt, h, g, ks, th, i] -> [mt, ks, g, th, h, i], t = 2th + h
    nib = (pos[..., 0] | (pos[..., 1] << 2)).to(torch.int64)
    nib = nib.reshape(mt, 2, 8, ks, 2, 8).permute(0, 3, 2, 4, 1, 5)
    shifts = 4 * torch.arange(8, dtype=torch.int64, device=ws.device)
    words = (nib.reshape(mt, ks, 32, 8) << shifts).sum(-1)
    kq = _ceil(ks, STAGE_KS)
    words = torch.nn.functional.pad(words, (0, 0, 0, kq * STAGE_KS - ks),
                                    value=_DEFAULT_META)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    meta = words.to(torch.int32).reshape(mt, kq, STAGE_KS, 32)
    return a.contiguous(), meta.permute(0, 1, 3, 2).contiguous()


def dense_from_operand(values: torch.Tensor, meta: torch.Tensor, m: int,
                       gk: int, packed: bool = False) -> torch.Tensor:
    """Exact inverse of :func:`sparse_operand`: Phi(W) [M, gamma*K] int8,
    or nibble bytes [M, gamma*K/2] when ``packed``."""
    mt, ks = _ceil(m, TILE_M), _ceil(gk, KSTEP)
    if packed:
        a = values.reshape(mt, -1, 32, 2, 8).permute(0, 1, 3, 2, 4)
        a = packer.unpack_nibbles(a.reshape(mt, -1, 32, 8))[:, :ks]
    else:
        a = values
    a = a.reshape(mt, ks, 8, 4, 2, 2, 4).permute(0, 5, 2, 1, 4, 3, 6)
    vals = a.reshape(mt * TILE_M, ks * 16, 2)
    words = meta.permute(0, 1, 3, 2).reshape(mt, -1, 32)[:, :ks]
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=meta.device)
    nib = (words[..., None] >> shifts) & 0xF          # [mt, ks, 32, 8]
    nib = nib.reshape(mt, ks, 8, 2, 2, 8).permute(0, 4, 2, 1, 3, 5)
    nib = nib.reshape(mt * TILE_M, ks * 16)
    zero = torch.zeros((), dtype=torch.int8, device=values.device)
    cols = [torch.where((nib & 3) == p, vals[..., 0], zero)
            + torch.where((nib >> 2) == p, vals[..., 1], zero)
            for p in range(4)]
    ws = torch.stack(cols, dim=-1).reshape(mt * TILE_M, ks * KSTEP)[:m, :gk]
    return packer.pack_nibbles(ws) if packed else ws.contiguous()


@functools.lru_cache(maxsize=None)
def splits_for(rows: int, m: int, gk: int) -> int:
    """Splits of the gamma*K stages for the int8/w4 instances: enough
    blocks for two per SM at decode and one per SM at prefill, each split
    keeping MIN_SPLIT_STAGES stages (and at decode at most DEC_MAX_STAGES,
    which it lifts at once); no split count leaves one empty."""
    stages = _ceil(_ceil(gk, KSTEP), STAGE_KS)
    decode = rows <= DECODE_MAX_R
    bm, bn = DECODE_BLOCK if decode else PREFILL_BLOCK
    blocks = _ceil(m, bm) * _ceil(rows, bn)
    want = _ceil((2 if decode else 1) * _SMS, blocks)
    s = max(1, min(want, stages // MIN_SPLIT_STAGES))
    if decode:
        s = max(s, _ceil(stages, DEC_MAX_STAGES))
    return _ceil(stages, _ceil(stages, s))


@functools.cache
def _fn():
    fn = _build.load("fused_slided_matmul").fused_slided_matmul_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bad_args(x, values, meta, s_w, bias, n_fam, act, packed, out_dtype,
              activation, act_absmax=None) -> str | None:
    """What the kernel does not take, or None (messages are built only on
    failure: this runs on every launch)."""
    if not x.is_cuda:
        return ("x must be a CUDA tensor (CPU tensors take the plain version "
                "in kernels.ref)")
    if n_fam not in (2, 3, 4):
        return f"n_fam={n_fam} not in (2, 3, 4)"
    if act not in ("int8", "fp8"):
        return f"unsupported activation precision {act!r}"
    if x.dtype not in (torch.bfloat16, torch.float32):
        return f"unsupported x dtype {x.dtype}"
    if out_dtype not in (torch.bfloat16, torch.float32):
        return f"unsupported out_dtype {out_dtype}"
    if activation not in _ACT:
        return f"unsupported activation {activation!r}"
    if x.dim() != 2 or x.shape[1] % (2 * n_fam):
        return f"x {tuple(x.shape)}: not [R, K] with K a multiple of 2N"
    if s_w.dim() != 2 or s_w.shape[1] != 1 or s_w.dtype != torch.float32:
        return "s_w must be fp32 [M, 1]"
    m, gk = s_w.shape[0], lifted_width(x.shape[1], n_fam)
    mt, ks = _ceil(m, TILE_M), _ceil(gk, KSTEP)
    want = (mt, _ceil(ks, 2) if packed else ks, 32, 16)
    if values.dtype not in (torch.int8, torch.uint8) \
            or tuple(values.shape) != want:
        return (f"values {tuple(values.shape)} {values.dtype} for M={m}, "
                f"gamma*K={gk}, packed={packed}: expected int8 {want}")
    want = (mt, _ceil(ks, STAGE_KS), 32, STAGE_KS)
    if meta.dtype != torch.int32 or tuple(meta.shape) != want:
        return (f"meta {tuple(meta.shape)} {meta.dtype}: expected int32 "
                f"{want}")
    if bias is not None and (tuple(bias.shape) != (m,)
                             or bias.dtype != torch.float32):
        return "bias must be fp32 [M]"
    if act_absmax is not None and (act_absmax.numel() != x.shape[0]
                                   or act_absmax.dtype != torch.float32):
        return "act_absmax must be fp32 with one value per row [R]"
    for t in (x, values, meta, s_w, bias, act_absmax):
        if t is not None and (t.device != x.device
                              or not t.is_contiguous()):
            return "operands must be contiguous and on one device"
    return None


def fused_slided_matmul_cuda(x: torch.Tensor, values: torch.Tensor,
                             meta: torch.Tensor, s_w: torch.Tensor,
                             bias: torch.Tensor | None = None, *, n_fam: int,
                             act: str = "int8", packed: bool = False,
                             out_dtype: torch.dtype = torch.float32,
                             activation: str | None = None,
                             act_absmax: torch.Tensor | None = None,
                             splits: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    x: [R, K] bf16 | f32; (values, meta): the operand of
    :func:`sparse_operand` for M = ``s_w.shape[0]`` weight rows; s_w:
    [M, 1] fp32; bias: [M] fp32 or None.  ``act`` ('int8' | 'fp8') picks
    the prologue quantizer.  out_dtype: bf16 or f32.  ``act_absmax``
    ([R] or [R, 1] fp32, contiguous): the rows' absmax the prologue
    quantizes with, in place of the absmax pass the launch otherwise
    runs first.  The int8/w4 instances split gamma*K in ``splits``
    (None: :func:`splits_for`); e4m3 takes 1."""
    bad = _bad_args(x, values, meta, s_w, bias, n_fam, act, packed,
                    out_dtype, activation, act_absmax)
    if bad is not None:
        raise ValueError(f"fused_slided_matmul_cuda: {bad}")
    rows, k = x.shape
    m = s_w.shape[0]
    if act == "fp8":
        splits = 1
    elif splits is None:
        splits = splits_for(rows, m, lifted_width(k, n_fam))
    elif splits < 1:
        raise ValueError(f"fused_slided_matmul_cuda: splits={splits} < 1")

    out = torch.empty((rows, m), dtype=out_dtype, device=x.device)
    amax = (act_absmax if act_absmax is not None else
            torch.empty((rows,), dtype=torch.float32, device=x.device))
    part = (torch.empty((splits, rows, m), dtype=torch.int32,
                        device=x.device) if splits > 1 else None)
    err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                values.data_ptr(), meta.data_ptr(), s_w.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), amax.data_ptr(),
                part.data_ptr() if part is not None else None,
                rows, m, k, n_fam, int(act == "fp8"), int(packed),
                int(out_dtype == torch.bfloat16), _ACT[activation], splits,
                int(act_absmax is not None),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_slided_matmul_launch")
    _COUNTS["launches"] += 1
    _COUNTS["act_absmax"] += act_absmax is not None
    return out
