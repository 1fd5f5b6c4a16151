"""Dispatch between the CUDA kernels and their plain versions.

The rule of ``repro.kernels.ops._auto``, with the device in place of the
backend: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the plain PyTorch version in ``ref``.  A CUDA tensor never reaches a plain
version, and no kernel failure falls back to one.  The kernels are built
(nvcc) and loaded (ctypes) by ``_build`` at their first launch.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.core.compressed import CompressedSlided

from . import ref
from . import paged_attention as _pa
from . import slide_matmul as _smm


def compressed_matmul(x: torch.Tensor, c: CompressedSlided,
                      s_w: torch.Tensor | None = None, recipe=None,
                      out_dtype=None, bias: torch.Tensor | None = None,
                      activation: str | None = None) -> torch.Tensor:
    """y = act(x @ decompress(c)^T + bias) — the SlideSparse linear.

    Quantized recipes need rowwise s_w [out, 1] and quantize x per token
    (plain torch on either device); ``c.packed`` must match the recipe's
    weight storage.  x: [..., K] -> [..., out]."""
    rec = precision.resolve(recipe)
    out_dtype = out_dtype or rec.out_dtype(x.dtype)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n = c.decomposition.source.family_n
    if n is None or c.m != 2 or c.n != 4:
        raise ValueError("the kernel supports the (2N-2):2N -> 2:4 family")
    if rec.quantized:
        if s_w is None:
            raise ValueError(f"recipe {rec.name!r} needs s_w row scales")
        if rec.packed_weights != c.packed:
            raise ValueError(
                f"recipe {rec.name!r} expects "
                f"{'nibble-packed' if rec.packed_weights else 'per-slot'} "
                f"values but the operand has packed={c.packed}")
        if x2.is_cuda:
            qx = rec.quantize_act(x2)
            y = _smm.compressed_matmul_cuda(
                qx.q, c.values, c.indices, qx.scale, s_w, bias, n_fam=n,
                packed=c.packed, out_dtype=out_dtype, activation=activation)
        else:
            y = ref.compressed_matmul_quant(x2, c, s_w, rec, out_dtype,
                                            bias=bias, activation=activation)
    else:
        if x2.is_floating_point() and not c.values.is_floating_point():
            raise TypeError(
                f"float activations ({x2.dtype}) against {c.values.dtype}"
                "-compressed weights: pass a quantized recipe with s_w row "
                "scales, or compress float weights for the float path")
        if x2.is_cuda:
            y = _smm.compressed_matmul_cuda(
                x2.to(c.values.dtype), c.values, c.indices, None, None, bias,
                n_fam=n, out_dtype=out_dtype, activation=activation)
        else:
            y = ref.compressed_matmul_fp(x2, c, out_dtype, bias=bias,
                                         activation=activation)
    return y.reshape(lead + (y.shape[-1],))


def paged_attention(q: torch.Tensor, pool: dict, page_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    sliding_window: int | None = None) -> torch.Tensor:
    """Fused paged flash attention over the page pool.

    q: [B, L, H, hd] post-RoPE queries; lane ``i`` of sequence ``b`` sees
    positions ``< kv_len[b] + i`` (and within ``sliding_window`` of its
    own position).  page_table: [B, maxp] int32 (unallocated entries 0);
    kv_len: [B] int32 row-0 lengths.  Returns [B, L, H, hd] in q.dtype."""
    if q.shape[2] % pool["k"].shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{pool['k'].shape[2]}")
    window = int(sliding_window) if sliding_window is not None else None
    if q.is_cuda:
        return _pa.paged_attention_cuda(
            q.contiguous(), pool, page_table.to(torch.int32).contiguous(),
            kv_len.to(torch.int32).contiguous(), window)
    maxp, page_size = page_table.shape[1], pool["k"].shape[1]
    # the JAX CPU default: ~128 tokens per loop block
    block_pages = max(1, min(maxp, max(1, 128 // page_size)))
    return ref.flash_paged(q, pool, page_table, kv_len, window, block_pages)
