"""Per-token dynamic quantization (paper §3.3/§4.2).

Port of ``repro.core.quant``, op for op: the reciprocal form
``x * (127 / a)`` with every quotient an IEEE division (:func:`div`),
``round`` half-to-even, then clamp; fp8 clamps BEFORE
the e4m3 cast (the JAX cast gives NaN far out of range where torch
saturates, so the clamp is part of the contract).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT8_QMAX = 127.0
INT4_QMAX = 7.0    # symmetric int4: [-7, 7]
FP8_E4M3_MAX = 448.0


def div(num, den) -> torch.Tensor:
    """The IEEE quotient ``num / den`` (one of them a tensor), as JAX and
    the CUDA kernels compute it.  torch turns a Python-float numerator into
    ``reciprocal(den) * num`` and, on CUDA, a Python-float denominator into
    ``num * (1 / den)``; both miss the quotient's last bit for many
    inputs, so the float operand becomes a tensor here."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(num, den)
    return num / den


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 (int8/int4 range) or float8_e4m3fn
    scale: torch.Tensor   # [..., 1] per-row scale, fp32


def absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax, clamped away from zero (Alg. 1 line 6)."""
    a = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(a, 1e-8)


def quantize_int8(x: torch.Tensor,
                  absmax_: torch.Tensor | None = None) -> Quantized:
    a = absmax(x) if absmax_ is None else absmax_
    r = div(INT8_QMAX, a)
    q = torch.clamp(torch.round(x.to(torch.float32) * r),
                    -INT8_QMAX, INT8_QMAX)
    return Quantized(q.to(torch.int8), div(a, INT8_QMAX))


def quantize_fp8(x: torch.Tensor,
                 absmax_: torch.Tensor | None = None) -> Quantized:
    a = absmax(x) if absmax_ is None else absmax_
    scale = div(a, FP8_E4M3_MAX)
    q = torch.clamp(x.to(torch.float32) / scale, -FP8_E4M3_MAX,
                    FP8_E4M3_MAX).to(torch.float8_e4m3fn)
    return Quantized(q, scale)


def quantize_weight_int8_rowwise(w: torch.Tensor) -> Quantized:
    """Per-output-channel symmetric int8: w [out, K] -> scale [out, 1].
    Zeros stay zero, so quantization commutes with the pattern and Phi."""
    return quantize_int8(w)


def quantize_weight_int4_rowwise(w: torch.Tensor) -> Quantized:
    """Per-output-channel symmetric int4 ('w4'): UNPACKED int8 in [-7, 7]."""
    a = absmax(w)
    r = div(INT4_QMAX, a)
    q = torch.clamp(torch.round(w.to(torch.float32) * r),
                    -INT4_QMAX, INT4_QMAX)
    return Quantized(q.to(torch.int8), div(a, INT4_QMAX))


def quant_dot(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """``q_x @ q_w^T`` under the accumulator rule: all-integer operands
    are exact (int32 on the CPU; float64 on the card, which has no
    integer ``mm`` — exact since |acc| <= 127^2 * K < 2^53); any fp8
    operand -> lossless fp32 casts and an fp32 dot.  Returns int32 or
    float64 (integer-valued) for integers, fp32 otherwise."""
    ints = not (q_x.is_floating_point() or q_w.is_floating_point())
    if ints:
        if q_x.is_cuda:
            return q_x.to(torch.float64) @ q_w.to(torch.float64).T
        return q_x.to(torch.int32) @ q_w.to(torch.int32).T
    return q_x.to(torch.float32) @ q_w.to(torch.float32).T


def matmul_dequant(qx: Quantized, qw: Quantized,
                   out_dtype=torch.float32) -> torch.Tensor:
    """y = (q_x @ q_w^T) * s_x * s_w — the dense quantized GEMM, scales
    applied in the kernels' order ((acc * s_x) * s_w)."""
    acc = quant_dot(qx.q.reshape(-1, qx.q.shape[-1]), qw.q)
    acc = acc.reshape(tuple(qx.q.shape[:-1]) + (qw.q.shape[0],))
    y = acc.to(torch.float32) * qx.scale * qw.scale.squeeze(-1)
    return y.to(out_dtype)
