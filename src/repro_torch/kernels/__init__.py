"""Kernels: the hand-written CUDA sources (``csrc/``), their wrappers and
their plain versions.

* ``fused_slided_matmul_cuda`` (B3) — the single-pass SlideSparse GEMM:
  per-token quantization and the lift in the prologue, 2:4 ``mma.sp``.
* ``fused_quant_slide_cuda`` (B4) — standalone Alg. 1: quantization fused
  with the lift.
* ``compressed_matmul_cuda`` (B1) — the compressed-weight matmul, the
  slide undone during decompression, bias + SiLU/GELU epilogue.
* ``quant_matmul_cuda`` (B5) — the dense w8a8 / e4m3 baseline.
* ``paged_attention_cuda`` (B2) — paged flash attention over the page
  table.
* ``autotune`` — shape-keyed split counts (in-process + on-disk JSON).

They stand for ``repro.kernels``' Pallas names.  ``ops`` holds the
dispatchers (the CUDA kernel on a CUDA tensor, ``ref``'s plain version
on a CPU one).  Importing the package builds nothing: each kernel is
built with nvcc at its first launch.
"""
from . import ops, ref, autotune  # noqa: F401
from .fused_quant_slide import fused_quant_slide_cuda  # noqa: F401
from .fused_slide_matmul import fused_slided_matmul_cuda  # noqa: F401
from .slide_matmul import compressed_matmul_cuda, decompress_count  # noqa: F401
from .quant_matmul import quant_matmul_cuda  # noqa: F401
from .paged_attention import paged_attention_cuda  # noqa: F401
from .ref import lift_pairs  # noqa: F401
