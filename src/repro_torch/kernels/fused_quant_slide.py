"""Wrapper of the CUDA quant+lift kernel (``csrc/fused_quant_slide.cu``).

The port of ``repro.kernels.fused_quant_slide.fused_quant_slide_pallas``:
per-token quantization (int8 or e4m3) and the lift Psi in one pass,
``x [R, K] -> (q [R, gamma*K], scale [R, 1])``.  ``launch_count`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_slide_matmul import lifted_width

_COUNTS = {"launches": 0}


def launch_count() -> int:
    return _COUNTS["launches"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0


@functools.cache
def _fn():
    fn = _build.load("fused_quant_slide").fused_quant_slide_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    q = torch.empty((rows, lifted_width(k, n_fam)),
                    dtype=torch.float8_e4m3fn if fp8 else torch.int8,
                    device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
                scale.data_ptr(), rows, k, n_fam, int(fp8),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_quant_slide_launch")
    _COUNTS["launches"] += 1
    return q, scale
