"""Wrapper of the CUDA quant+lift kernel (``csrc/fused_quant_slide.cu``).

The port of ``repro.kernels.fused_quant_slide.fused_quant_slide_pallas``:
per-token quantization (int8 or e4m3) and the lift Psi in one pass,
``x [R, K] -> (q [R, gamma*K], scale [R, 1])``.  A row is spread over a
thread block cluster (:func:`launch_plan`); the cluster's blocks take the
row's absmax together through distributed shared memory (plain mirror:
``ref.fused_quant_slide_spans`` over :func:`spans`).  ``launch_count``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_slide_matmul import lifted_width

SMS = 132           # streaming multiprocessors of the H100 SXM
MAX_CLUSTER = 8     # the portable cluster size (csrc MAX_CLUSTER)
MAX_THREADS = 512   # threads, one unit each, of a block (csrc MAX_THREADS)
# source groups of 2N columns a thread owns: its lifted bytes, a multiple
# of 16, go out in 16-byte stores (csrc Unit<N>::U)
UNIT_GROUPS = {2: 4, 3: 2, 4: 4}
_COUNTS = {"launches": 0}


def launch_count() -> int:
    return _COUNTS["launches"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0


@functools.cache
def _fn():
    fn = _build.load("fused_quant_slide").fused_quant_slide_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _noop():
    fn = _build.load("fused_quant_slide").noop_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, k: int, n_fam: int) -> tuple[int, int]:
    """(cluster, units per block): the blocks a row is split over and
    the units (UNIT_GROUPS[n] source groups each) every block owns.  Few
    rows spread each row over up to MAX_CLUSTER blocks, enough for one
    block per SM; from SMS rows on, one block a row, or as many as a row
    of more than MAX_THREADS units needs."""
    units = _ceil(k, UNIT_GROUPS[n_fam] * 2 * n_fam)
    need = _ceil(units, MAX_THREADS)
    if need > MAX_CLUSTER:
        raise ValueError(f"K={k} needs {need} blocks a row, more than a "
                         f"cluster of {MAX_CLUSTER}")
    spread = 1 if rows >= SMS else _ceil(SMS, rows)
    upb = _ceil(units, min(MAX_CLUSTER, max(need, spread), units))
    return _ceil(units, upb), upb  # no block left without a unit


def spans(rows: int, k: int, n_fam: int) -> list[tuple[int, int]]:
    """The source columns [c0, c1) each block of a row's cluster reads,
    whose maxima the cluster reduces to the row's absmax."""
    cluster, upb = launch_plan(rows, k, n_fam)
    width = upb * UNIT_GROUPS[n_fam] * 2 * n_fam
    return [(min(k, b * width), min(k, (b + 1) * width))
            for b in range(cluster)]


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_quant_slide_cuda: {msg}")


def fused_quant_slide_cuda(x: torch.Tensor, *, n_fam: int,
                           fp8: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA tensor x: [R, K] bf16 | f32.  Returns
    (q [R, gamma*K] int8 | float8_e4m3fn, scale [R, 1] fp32)."""
    _need(x.is_cuda, "x must be a CUDA tensor (CPU tensors take the plain "
          "version in kernels.ref)")
    _need(n_fam in (2, 3, 4), f"n_fam={n_fam} not in (2, 3, 4)")
    _need(x.dtype in (torch.bfloat16, torch.float32),
          f"unsupported x dtype {x.dtype}")
    _need(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [R, K]")
    rows, k = x.shape
    _need(k % (2 * n_fam) == 0, f"K={k} not a multiple of 2N={2 * n_fam}")
    _need(rows <= 65535, f"R={rows} rows: at most 65535 (grid.y)")
    cluster, upb = launch_plan(rows, k, n_fam)
    q = torch.empty((rows, lifted_width(k, n_fam)),
                    dtype=torch.float8_e4m3fn if fp8 else torch.int8,
                    device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
                scale.data_ptr(), rows, k, n_fam, int(fp8), cluster, upb,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_quant_slide_launch")
    _COUNTS["launches"] += 1
    return q, scale


def noop_cuda(device=None) -> None:
    """Launch one block that does nothing: the launch floor that B4's
    decode time is read against.  Not counted as a launch of B4."""
    _build.check(_noop()(torch.cuda.current_stream(device).cuda_stream),
                 "noop_launch")
