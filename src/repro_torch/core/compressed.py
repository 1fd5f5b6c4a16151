"""Hardware-compressed representation of slided 2:4 windows (paper §4.3).

Mirrors cuSPARSELt's 2:4 operand: per window the M non-zero values plus
their int8 in-window positions (0..N-1).  For the (2N-2):2N family the
value count is exactly the source non-zero budget.  Under the 'w4'
recipe the int4 values are nibble-packed two per byte (``packed=True``);
``indices`` are never packed.
"""
from __future__ import annotations

import dataclasses

import torch

from .patterns import HardwarePattern, Pattern, SlideDecomposition
from . import packer


@dataclasses.dataclass
class CompressedSlided:
    """The compressed operand + static decomposition info."""

    values: torch.Tensor   # [out, G*w*M] ([out, G*w*M/2] bytes if packed)
    indices: torch.Tensor  # [out, G*w*M] int8 in-window positions
    k: int                 # original contraction length
    z: int
    l: int
    m: int
    n: int
    packed: bool = False   # True: values nibble-packed ('w4' recipe)

    @property
    def decomposition(self) -> SlideDecomposition:
        return SlideDecomposition(Pattern(self.z, self.l),
                                  HardwarePattern(self.m, self.n))

    @property
    def nbytes_values(self) -> int:
        return self.values.numel() * self.values.element_size()

    @property
    def nbytes_meta_packed(self) -> int:
        # 2-bit indices, 16 per int32 word
        return (self.indices.numel() + 15) // 16 * 4

    @property
    def slots(self) -> int:
        """Per-row compressed slot count (== indices width)."""
        return self.indices.shape[-1]

    def values_unpacked(self) -> torch.Tensor:
        """Per-slot int8 values regardless of nibble packing."""
        if not self.packed:
            return self.values
        return packer.unpack_nibbles(self.values, self.slots)


def compress(w_slided: torch.Tensor, dec: SlideDecomposition,
             pack_values: bool = False) -> CompressedSlided:
    """Pack a slided (hardware-compliant) tensor into values + positions:
    per window the non-zeros first, in position order, then zeros — the
    JAX sort key ``arange(n) + n * is_zero``, whose keys are distinct, so
    the order does not depend on the sort's stability."""
    wv = packer.slided_window_view(w_slided, dec)  # [..., G, w, n]
    n, m = dec.hw.n, dec.hw.m
    nz = wv != 0
    key = (torch.arange(n, dtype=torch.int32, device=wv.device)
           + n * (~nz).to(torch.int32))
    order = torch.argsort(key, dim=-1)[..., :m]
    vals = torch.take_along_dim(wv, order, dim=-1)
    lead = tuple(wv.shape[:-3])
    g, nw = wv.shape[-3], wv.shape[-2]
    vals = vals.reshape(lead + (g * nw * m,))
    if pack_values:
        vals = packer.pack_nibbles(vals)
    return CompressedSlided(
        values=vals,
        indices=order.to(torch.int8).reshape(lead + (g * nw * m,)),
        k=g * dec.source.l, z=dec.source.z, l=dec.source.l, m=m, n=n,
        packed=pack_values)


def decompress_original(c: CompressedSlided) -> torch.Tensor:
    """Scatter compressed values straight back to the original K layout.

    Source position of slot (group g, window j, slot t) is
    ``s*j + idx``; every source position receives at most one non-zero
    (Algorithm 2), so the per-position sum is exact in any dtype.  Built
    from compares and selects (one pass per in-group position) rather
    than a scatter, which also runs for int8 on the card."""
    dec = c.decomposition
    g = c.k // c.l
    nw, m = dec.num_windows, c.m
    lead = tuple(c.indices.shape[:-1])
    vals = c.values_unpacked().reshape(lead + (g, nw, m))
    j = torch.arange(nw, dtype=torch.int32, device=vals.device)[:, None]
    pos = dec.hw.stride * j + c.indices.reshape(lead + (g, nw, m)).to(
        torch.int32)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    cols = [torch.where(pos == d, vals, zero).sum(dim=(-2, -1),
                                                  dtype=vals.dtype)
            for d in range(c.l)]
    return torch.stack(cols, dim=-1).reshape(lead + (g * c.l,))


def decompress_slided(c: CompressedSlided) -> torch.Tensor:
    """Inverse of :func:`compress`: the slided dense windows
    [..., gamma*K].  Each slot's value lands at its in-window position
    (compares and selects, as in :func:`decompress_original`)."""
    dec = c.decomposition
    g = c.k // c.l
    nw, m, n = dec.num_windows, c.m, dec.hw.n
    lead = tuple(c.indices.shape[:-1])
    vals = c.values_unpacked().reshape(lead + (g, nw, m))
    idx = c.indices.reshape(lead + (g, nw, m)).to(torch.int32)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    cols = [torch.where(idx == p, vals, zero).sum(dim=-1, dtype=vals.dtype)
            for p in range(n)]
    return torch.stack(cols, dim=-1).reshape(lead + (g * nw * n,))


def split_out(c: CompressedSlided, shards: int) -> list[CompressedSlided]:
    """Column-parallel sharding: ``shards`` equal contiguous blocks of the
    output dim, each over the full contraction length ``k``; shard ``i``
    decompresses to rows ``[i*out/shards, (i+1)*out/shards)``."""
    out = c.values.shape[-2] if c.values.dim() > 1 else 1
    if c.values.dim() < 2 or out % shards:
        raise ValueError(f"cannot split out dim of shape "
                         f"{tuple(c.values.shape)} into {shards} shards")
    step = out // shards
    return [CompressedSlided(
        c.values[..., i * step:(i + 1) * step, :],
        c.indices[..., i * step:(i + 1) * step, :],
        c.k, c.z, c.l, c.m, c.n, c.packed) for i in range(shards)]


def split_k(c: CompressedSlided, shards: int) -> list[CompressedSlided]:
    """Row-parallel sharding: ``shards`` contiguous blocks of whole
    L-groups of the contraction dim.  The layout is group-major, so a
    contiguous slice of the packed dim is a contiguous slice of K, and
    shard ``i`` decompresses to columns ``[i*k/shards, (i+1)*k/shards)``
    with ``k/shards`` as its contraction length.  Nibble-packed values
    hold an even slot count per group, so their byte slices stay aligned.
    Requires ``(k/shards) % L == 0``."""
    if c.k % shards or (c.k // shards) % c.l:
        raise ValueError(
            f"cannot split k={c.k} into {shards} shards of whole L={c.l} "
            f"groups (pattern group would straddle a shard boundary)")
    per_group = c.decomposition.num_windows * c.m   # slots per L-group
    step = (c.k // shards) // c.l * per_group
    vstep = step // 2 if c.packed else step
    return [CompressedSlided(
        c.values[..., i * vstep:(i + 1) * vstep],
        c.indices[..., i * step:(i + 1) * step],
        c.k // shards, c.z, c.l, c.m, c.n, c.packed) for i in range(shards)]


def pack_meta(indices: torch.Tensor) -> torch.Tensor:
    """Bit-pack 2-bit indices into int32 words, 16 per word (index ``i``
    of a word at bits ``2i``), the last word zero-padded."""
    n = indices.shape[-1]
    pad = (-n) % 16
    flat = indices.to(torch.int64)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    grp = flat.reshape(tuple(flat.shape[:-1]) + ((n + pad) // 16, 16))
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=indices.device)
    words = (grp << shifts).sum(dim=-1)
    # the fields do not overlap, so the sum is their OR; wrap to int32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_meta(words: torch.Tensor, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_meta`: int8 indices of length ``count``."""
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    idx = (words.to(torch.int32)[..., None] >> shifts) & 3
    idx = idx.reshape(tuple(words.shape[:-1]) + (-1,))[..., :count]
    return idx.to(torch.int8)
