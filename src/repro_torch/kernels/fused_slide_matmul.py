"""Wrapper of the CUDA fused slided matmul (``csrc/fused_slided_matmul.cu``).

The port of ``repro.kernels.fused_slide_matmul.fused_slided_matmul_pallas``:
``y[R, M] = act((Psi(q(x)) @ Phi(W)^T) * s_x * s_w + bias)`` in one
kernel, the per-token quantization and the lift in its prologue.
``launch_count`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_ACT = {None: 0, "silu": 1, "gelu": 2}
_COUNTS = {"launches": 0}


def launch_count() -> int:
    return _COUNTS["launches"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0


@functools.cache
def _fn():
    fn = _build.load("fused_slided_matmul").fused_slided_matmul_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_slided_matmul_cuda: {msg}")


def lifted_width(k: int, n_fam: int) -> int:
    """gamma*K of the (2N-2):2N -> 2:4 lift: N-1 windows of 4 per group."""
    return k // (2 * n_fam) * (n_fam - 1) * 4


def fused_slided_matmul_cuda(x: torch.Tensor, w_slided: torch.Tensor,
                             s_w: torch.Tensor,
                             bias: torch.Tensor | None = None, *, n_fam: int,
                             act: str = "int8", packed: bool = False,
                             out_dtype: torch.dtype = torch.float32,
                             activation: str | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    x: [R, K] bf16 | f32; w_slided: [M, gamma*K] int8, or [M, gamma*K/2]
    nibble bytes when ``packed``; s_w: [M, 1] fp32; bias: [M] fp32 or
    None.  ``act`` ('int8' | 'fp8') picks the prologue quantizer.
    out_dtype: bf16 or f32."""
    _need(x.is_cuda, "x must be a CUDA tensor (CPU tensors take the plain "
          "version in kernels.ref)")
    _need(n_fam in (2, 3, 4), f"n_fam={n_fam} not in (2, 3, 4)")
    _need(act in ("int8", "fp8"), f"unsupported activation precision {act!r}")
    _need(x.dtype in (torch.bfloat16, torch.float32),
          f"unsupported x dtype {x.dtype}")
    _need(out_dtype in (torch.bfloat16, torch.float32),
          f"unsupported out_dtype {out_dtype}")
    _need(activation in _ACT, f"unsupported activation {activation!r}")
    _need(x.dim() == 2 and w_slided.dim() == 2, "x and w_slided must be 2-D")
    rows, k = x.shape
    m = w_slided.shape[0]
    _need(k % (2 * n_fam) == 0, f"K={k} not a multiple of 2N={2 * n_fam}")
    gk = lifted_width(k, n_fam)
    _need(w_slided.dtype in (torch.int8, torch.uint8),
          f"slided weights must be int8 bytes, got {w_slided.dtype}")
    _need(w_slided.shape[1] == (gk // 2 if packed else gk),
          f"w_slided width {w_slided.shape[1]} for gamma*K={gk}, "
          f"packed={packed}")
    _need(s_w.shape == (m, 1) and s_w.dtype == torch.float32,
          "s_w must be fp32 [M, 1]")
    if bias is not None:
        _need(bias.shape == (m,) and bias.dtype == torch.float32,
              "bias must be fp32 [M]")
    for t in (t for t in (x, w_slided, s_w, bias) if t is not None):
        _need(t.device == x.device, "all operands on one device")
        _need(t.is_contiguous(), "operands must be contiguous")

    out = torch.empty((rows, m), dtype=out_dtype, device=x.device)
    err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                w_slided.data_ptr(), s_w.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), rows, m, k, n_fam, int(act == "fp8"),
                int(packed), int(out_dtype == torch.bfloat16),
                _ACT[activation],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_slided_matmul_launch")
    _COUNTS["launches"] += 1
    return out
