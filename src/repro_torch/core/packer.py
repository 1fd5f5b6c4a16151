"""Offline weight packer — paper Algorithm 2 (greedy residual allocation).

Port of ``repro.core.packer``: transforms a Z:L-sparse weight matrix into
``w`` concatenated M:N-compliant windows (default (2N-2):2N -> 2:4).  The
2-position overlap between adjacent windows is the spillover buffer of
§4.1.  Deterministic (App B.1: fixed iteration order g, l, d), and
bit-identical to the JAX packer on the same inputs.
"""
from __future__ import annotations

import torch

from .patterns import Pattern, SlideDecomposition


def _check_shapes(w: torch.Tensor, dec: SlideDecomposition) -> int:
    k = w.shape[-1]
    if k % dec.source.l:
        raise ValueError(f"K={k} must be a multiple of L={dec.source.l}")
    return k // dec.source.l


def pack_slided(w: torch.Tensor, dec: SlideDecomposition) -> torch.Tensor:
    """Vectorized Algorithm 2: [..., K] Z:L rows -> [..., gamma*K] slided
    weights; every aligned N-window holds at most M non-zeros."""
    g = _check_shapes(w, dec)
    l, n, m, s, nw = (dec.source.l, dec.hw.n, dec.hw.m, dec.hw.stride,
                      dec.num_windows)
    lead = tuple(w.shape[:-1])
    wg = w.reshape(lead + (g, l))
    used = torch.zeros(wg.shape, dtype=torch.bool, device=w.device)
    nz = wg != 0
    outs = []
    for j in range(nw):  # N-1 sequential window steps, each vectorized
        b = s * j
        cand = (nz & ~used)[..., b:b + n]
        rank = torch.cumsum(cand.to(torch.int32), dim=-1)
        take = cand & (rank <= m)  # earliest-first, capacity M
        outs.append(torch.where(take, wg[..., b:b + n],
                                torch.zeros((), dtype=w.dtype,
                                            device=w.device)))
        used[..., b:b + n] |= take
    out = torch.stack(outs, dim=-2)  # [..., g, w, n]
    return out.reshape(lead + (g * nw * n,))


def slided_window_view(ws: torch.Tensor, dec: SlideDecomposition):
    """Reshape a slided [..., gamma*K] tensor to windows [..., G, w, n]."""
    n, nw = dec.hw.n, dec.num_windows
    g = ws.shape[-1] // (nw * n)
    return ws.reshape(tuple(ws.shape[:-1]) + (g, nw, n))


def pack_nibbles(v: torch.Tensor) -> torch.Tensor:
    """Bit-pack int8 values in [-8, 7] two per byte (the 'w4' store):
    element ``2i`` -> low nibble, ``2i+1`` -> high nibble of byte ``i``.
    The high nibble's shift wraps in int8, which keeps its sign bits."""
    if v.shape[-1] % 2:
        raise ValueError(f"cannot nibble-pack odd trailing dim {tuple(v.shape)}")
    pairs = v.to(torch.int8).reshape(tuple(v.shape[:-1])
                                     + (v.shape[-1] // 2, 2))
    lo = pairs[..., 0] & 0x0F
    hi = (pairs[..., 1].to(torch.int16) << 4).to(torch.int8)  # int8 wrap
    return lo | hi


def unpack_nibbles(p: torch.Tensor, count: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: bytes -> int8 values in [-8, 7].

    Arithmetic shifts sign-extend each nibble (``(b << 4) >> 4`` for the
    low half, with the left shift wrapping in int8).  ``count`` trims a
    padded tail."""
    lo = (p.to(torch.int16) << 4).to(torch.int8) >> 4
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(tuple(p.shape[:-1]) + (-1,))
    return out if count is None else out[..., :count]


def magnitude_keep_mask(w: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """Boolean top-Z-by-|w| keep mask per L-group.

    Rank by pairwise comparison counting (O(L^2), L <= 16), not
    ``topk``/``argsort``: ties break by position, exactly as the JAX
    packer breaks them."""
    k = w.shape[-1]
    if k % pattern.l:
        raise ValueError(f"K={k} not a multiple of L={pattern.l}")
    grp = w.to(torch.float32).abs().reshape(tuple(w.shape[:-1])
                                            + (k // pattern.l, pattern.l))
    a, b = grp[..., :, None], grp[..., None, :]
    pos = torch.arange(pattern.l, device=w.device)
    earlier = pos[None, :] < pos[:, None]
    beats_me = (b > a) | ((b == a) & earlier)  # strict rank of each slot
    rank = beats_me.sum(dim=-1)
    return (rank < pattern.z).reshape(w.shape)


def prune_to_pattern(w: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """Magnitude-prune to Z:L: zero the (L-Z) smallest-|.| per L-group."""
    return torch.where(magnitude_keep_mask(w, pattern), w,
                       torch.zeros((), dtype=w.dtype, device=w.device))
