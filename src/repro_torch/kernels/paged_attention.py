"""Wrapper of the CUDA paged flash attention (``csrc/paged_attention.cu``).

The port of ``repro.kernels.paged_attention._flash_pallas`` and its
``_merge_splits``: attention of ``q [B, L, H, hd]`` over a page pool
``{'k','v'[,'k_scale','v_scale']}`` of shape ``[num_pages, P, KVH, hd]``
through ``page_table [B, maxp]``, where query lane ``i`` of sequence ``b``
sees positions ``< kv_len[b] + i`` (decode L = 1, prefill chunk L = C).
The table is cut into ``splits_for(...)`` page ranges, each folded by its
own blocks into an fp32 partial ``(acc, m, l)`` in scratch allocated here;
a second kernel merges them in split order.  Written in CUDA C++ rather
than Triton: it shares the nvcc + ctypes build of the other kernels, and
the non-power-of-two head_dim (120) is padded in shared memory by hand.
``launch_count`` counts wrapper calls that launched; a CUDA graph replay
adds the launches its capture recorded (``ops.recorded_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KV_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_COUNTS = {"launches": 0}
SMS = 132                  # streaming multiprocessors of the H100 SXM
BLOCKS_PER_SM = 2          # attend blocks the split aims to keep in flight
ROW_TILE = 64              # query rows per block at prefill (csrc MMA_ROWS)
MIN_SPLIT_TOKENS = 64      # two 32-token chunks: a split's least work
MAX_SPLITS = 32


def launch_count() -> int:
    return _COUNTS["launches"]


def reset_counts() -> None:
    _COUNTS["launches"] = 0


@functools.cache
def _fn():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def splits_for(b: int, kvh: int, maxp: int, page_size: int, lanes: int,
               rep: int) -> int:
    """The number of page ranges S of one call, a pure function of the
    shapes: enough (b, kv-head, split, row-tile) blocks for about
    BLOCKS_PER_SM per SM, while each split keeps at least
    MIN_SPLIT_TOKENS tokens (and so at least one page) of the table."""
    tiles = -(-(lanes * rep) // ROW_TILE)
    want = -(-(BLOCKS_PER_SM * SMS) // (b * kvh * tiles))
    most = max(1, maxp // max(1, -(-MIN_SPLIT_TOKENS // page_size)))
    return max(1, min(want, most, MAX_SPLITS))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, pool: dict,
                         page_table: torch.Tensor, kv_len: torch.Tensor,
                         window: int | None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns [B, L, H, hd] in q.dtype."""
    _need(q.is_cuda, "q must be a CUDA tensor (CPU tensors take the plain "
          "version in kernels.ref)")
    b, lanes, h, hd = q.shape
    k, v = pool["k"], pool["v"]
    num_pages, page_size, kvh, hd_k = k.shape
    _need(q.dtype in (torch.float32, torch.bfloat16),
          f"unsupported q dtype {q.dtype}")
    _need(k.dtype in _KV_MODE and v.dtype == k.dtype,
          f"unsupported pool dtype {k.dtype}")
    _need(hd_k == hd and v.shape == k.shape, "pool shape mismatch")
    _need(h % kvh == 0, f"q heads {h} not a multiple of kv heads {kvh}")
    _need(hd <= 128 and hd % 8 == 0,
          f"head_dim {hd} must be a multiple of 8 and <= 128")
    _need(page_table.dtype == torch.int32 and page_table.dim() == 2
          and page_table.shape[0] == b, "page_table must be int32 [B, maxp]")
    _need(kv_len.dtype == torch.int32 and kv_len.shape == (b,),
          "kv_len must be int32 [B]")
    quantized = k.dtype == torch.int8
    operands = [q, k, v, page_table, kv_len]
    if quantized:
        ks, vs = pool["k_scale"], pool["v_scale"]
        _need(ks.shape == (num_pages, page_size, kvh, 1) == vs.shape
              and ks.dtype == vs.dtype == torch.float32,
              "int8 pools need fp32 scale pools [num_pages, P, KVH, 1]")
        operands += [ks, vs]
    for t in operands:
        _need(t.device == q.device, "all operands on one device")
        _need(t.is_contiguous(), "operands must be contiguous")
    for t in (k, v):
        _need(t.data_ptr() % 16 == 0, "the pools must be 16-byte aligned "
              "(the kernel's vector loads)")

    maxp = page_table.shape[1]
    rep = h // kvh
    splits = splits_for(b, kvh, maxp, page_size, lanes, rep)
    out = torch.empty_like(q)
    part = [None, None, None]
    if splits > 1:  # one scratch buffer: acc [rows, hd], then m, then l
        rows = b * kvh * splits * lanes * rep
        scratch = torch.empty((rows * (hd + 2),), dtype=torch.float32,
                              device=q.device)
        part = [scratch, scratch[rows * hd:], scratch[rows * (hd + 1):]]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                pool["k_scale"].data_ptr() if quantized else None,
                pool["v_scale"].data_ptr() if quantized else None,
                page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                *(t.data_ptr() if t is not None else None for t in part),
                b, lanes, h, kvh, hd, page_size, maxp,
                -1 if window is None else int(window), splits,
                hd ** -0.5,  # rounded to fp32 by c_float, as JAX does
                int(q.dtype == torch.bfloat16), _KV_MODE[k.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention_launch")
    _COUNTS["launches"] += 1
    return out
