"""Wrapper of the CUDA dense quantized matmul (``csrc/quant_matmul.cu``).

The port of ``repro.kernels.quant_matmul.quant_matmul_pallas``:
``y[R, M] = act((q_x @ q_w^T) * s_x * s_w + bias)`` over int8 or e4m3
operands.  ``launch_count`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quant_matmul_cuda: {msg}")


def quant_matmul_cuda(q_x: torch.Tensor, s_x: torch.Tensor,
                      q_w: torch.Tensor, s_w: torch.Tensor,
                      bias: torch.Tensor | None = None, *,
                      out_dtype: torch.dtype = torch.float32,
                      activation: str | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    q_x: [R, K] int8 | float8_e4m3fn; s_x: [R, 1] fp32; q_w: [M, K] int8 |
    float8_e4m3fn; s_w: [M, 1] fp32; bias: [M] fp32 or None.  out_dtype:
    bf16 or f32."""
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

    out = torch.empty((rows, m), dtype=out_dtype, device=q_x.device)
    err = _fn()(q_x.data_ptr(), s_x.data_ptr(), q_w.data_ptr(),
                s_w.data_ptr(), bias.data_ptr() if bias is not None else None,
                out.data_ptr(), rows, m, k,
                int(q_x.dtype == torch.float8_e4m3fn),
                int(q_w.dtype == torch.float8_e4m3fn),
                int(out_dtype == torch.bfloat16), _ACT[activation],
                torch.cuda.current_stream(q_x.device).cuda_stream)
    _build.check(err, "quant_matmul_launch")
    _COUNTS["launches"] += 1
    return out
