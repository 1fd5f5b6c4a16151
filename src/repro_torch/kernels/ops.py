"""Dispatch between the CUDA kernels and their plain versions.

The rule of ``repro.kernels.ops._auto``, with the device in place of the
backend: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the plain PyTorch version in ``ref``.  A CUDA tensor never reaches a plain
version, and no kernel failure falls back to one.  The kernels are built
(nvcc) and loaded (ctypes) by ``_build`` at their first launch.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import precision
from repro_torch.core.compressed import CompressedSlided
from repro_torch.core.patterns import SlideDecomposition

from . import ref
from . import fused_quant_slide as _fqs
from . import fused_slide_matmul as _fsm
from . import paged_attention as _pa
from . import quant_matmul as _qmm
from . import slide_matmul as _smm


# every kernel's wrapper module, each counting its launches in ``_COUNTS``
_COUNTED = {"compressed_matmul": _smm, "paged_attention": _pa,
            "fused_slided_matmul": _fsm, "fused_quant_slide": _fqs,
            "quant_matmul": _qmm}


def launch_counts() -> dict[str, dict[str, int]]:
    """A copy of every kernel's counters (launches; B1 also its
    decompressed tiles)."""
    return {name: dict(mod._COUNTS) for name, mod in _COUNTED.items()}


def add_launch_counts(delta: dict[str, dict[str, int]]) -> None:
    """Add ``delta`` to the counters: the launches of one CUDA graph
    replay, recorded when the graph was captured."""
    for name, counts in delta.items():
        for key, n in counts.items():
            _COUNTED[name]._COUNTS[key] += n


@contextlib.contextmanager
def recorded_launches():
    """Around a CUDA graph capture: the wrappers called inside count as
    usual, but a capture records launches and runs none, so at exit the
    counters are put back and the yielded dict holds what the block
    counted, which each replay of the graph then adds."""
    before = launch_counts()
    delta: dict[str, dict[str, int]] = {}
    try:
        yield delta
    finally:
        after = launch_counts()
        for name, counts in before.items():
            _COUNTED[name]._COUNTS.update(counts)
            delta[name] = {k: after[name][k] - n for k, n in counts.items()}


def _family(dec: SlideDecomposition) -> int:
    n = dec.source.family_n
    if n is None or dec.hw.m != 2 or dec.hw.n != 4:
        raise ValueError("the kernel supports the (2N-2):2N -> 2:4 family")
    return n


def fused_quant_slide(x: torch.Tensor, dec: SlideDecomposition, recipe=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token quantization + lifting Psi (paper Alg. 1).
    x: [..., K] float -> (q [..., gamma*K] int8 | e4m3, scale [..., 1]
    fp32).  ``recipe`` selects the quantizer (default: int8)."""
    rec = precision.resolve(recipe if recipe is not None else "int8")
    if not rec.quantized:
        raise ValueError(f"recipe {rec.name!r} has no activation quantizer"
                         " to fuse the lift into")
    n = _family(dec)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.is_cuda:
        q, s = _fqs.fused_quant_slide_cuda(x2, n_fam=n, fp8=rec.act == "fp8")
    else:
        q, s = ref.fused_quant_slide(x2, dec, fp8=rec.act == "fp8")
    return q.reshape(lead + (q.shape[-1],)), s.reshape(lead + (1,))


def quant_matmul(q_x: torch.Tensor, s_x: torch.Tensor, q_w: torch.Tensor,
                 s_w: torch.Tensor, out_dtype=torch.float32,
                 bias: torch.Tensor | None = None,
                 activation: str | None = None) -> torch.Tensor:
    """Dense quantized GEMM + dequant epilogue (the quantized baseline).
    q_x: [..., K] int8 | e4m3; s_x: [..., 1] fp32; q_w: [M, K]; s_w:
    [M, 1] fp32.  Returns [..., M] in ``out_dtype``."""
    lead = tuple(q_x.shape[:-1])
    x2 = q_x.reshape(-1, q_x.shape[-1]).contiguous()
    s2 = s_x.reshape(-1, 1).contiguous()
    if x2.is_cuda:
        y = _qmm.quant_matmul_cuda(x2, s2, q_w, s_w, bias,
                                   out_dtype=out_dtype, activation=activation)
    else:
        y = ref.quant_matmul(x2, s2, q_w, s_w, out_dtype, bias, activation)
    return y.reshape(lead + (y.shape[-1],))


def slided_matmul_quant(x: torch.Tensor, sp_values: torch.Tensor,
                        sp_meta: torch.Tensor, s_w: torch.Tensor,
                        dec: SlideDecomposition, recipe="int8", out_dtype=None,
                        bias: torch.Tensor | None = None,
                        activation: str | None = None) -> torch.Tensor:
    """The paper's GPU path as ONE kernel: per-token quantization and
    lifting in the GEMM prologue, so the lifted gamma*K activations never
    reach device memory.  int8 or e4m3 activations against the 2:4
    operand of the slided weights (``fused_slide_matmul.sparse_operand``
    of Phi(W), int8 or nibble-packed int4), M = ``s_w.shape[0]``."""
    rec = precision.resolve(recipe)
    if not rec.quantized:
        raise ValueError(f"recipe {rec.name!r} has no quantized GEMM form")
    n = _family(dec)
    out_dtype = out_dtype or rec.out_dtype(x.dtype)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.is_cuda:
        y = _fsm.fused_slided_matmul_cuda(
            x2, sp_values, sp_meta, s_w, bias, n_fam=n, act=rec.act,
            packed=rec.packed_weights, out_dtype=out_dtype,
            activation=activation)
    else:
        y = ref.slided_matmul_sparse(x2, sp_values, sp_meta, s_w, dec, rec,
                                     out_dtype, bias=bias,
                                     activation=activation)
    return y.reshape(lead + (y.shape[-1],))


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
    n = _family(c.decomposition)
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
