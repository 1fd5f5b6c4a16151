"""The sequence-sharded serve step's context: this rank's slice of the
one-shot KV cache along S.

JAX serves a batch-1 decode over a cache whose S dim ``rules.cache_spec``
splits over every axis of the mesh (B over the data-parallel axes when
it divides, else S takes them too, and S over ``model``); its
``_decode_sdpa`` then keeps QK^T local to each S-shard and GSPMD
combines the softmax statistics across the shards.  The port runs that
split explicitly: :func:`activate` marks a step as one rank's share and
holds a :class:`SeqShard` (this rank's S offset and length, the mesh
axes S spans); ``models.attention`` reads it (:func:`current`) in its
decode branch, where each rank attends over its own S-slice and
:func:`combine` merges the ranks' partial statistics by the flash-decode
rule.  The merge gathers every shard's (max, sum, p@V) along the S axes
through the ``sharding.ctx.Mesh`` (so the collectives are counted, and a
dry mesh counts them too) and sums them in shard order, so every rank
computes the same result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's piece of the cache along S: positions ``offset`` to
    ``offset + length`` of a cache ``length * shards`` long, split over
    ``axes`` of ``mesh`` (major first: the S-shard index is the axes'
    coordinates read as one mixed-radix number, as ``NamedSharding``
    lays out a dim sharded over several axes)."""
    mesh: Any
    axes: tuple
    offset: int
    length: int

    @property
    def shards(self) -> int:
        return math.prod(self.mesh.axis_size(a) for a in self.axes)


class _State(threading.local):
    shard = None


_STATE = _State()


def current() -> SeqShard | None:
    return _STATE.shard


@contextlib.contextmanager
def activate(shard: SeqShard | None):
    """Mark the dynamic extent as one rank's share of a decode step over
    a cache split along S as ``shard`` says (None: not split)."""
    prev = _STATE.shard
    _STATE.shard = shard
    try:
        yield
    finally:
        _STATE.shard = prev


def merge(parts: torch.Tensor) -> torch.Tensor:
    """Every shard's partials [n, ..., hd + 2] (p@V, then the sum of
    exponentials l, then the max m, in shard order) -> the attention
    output [..., hd]: the global max M, each shard's l and p@V rescaled
    by exp(m_i - M) and summed, then divided by the summed l.  A shard
    with no valid position has m = NEG_INF, so its weight is exactly 0."""
    acc, l, m = parts[..., :-2], parts[..., -2], parts[..., -1]
    w = torch.exp(m - m.amax(0))
    return (acc * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
            shard: SeqShard) -> torch.Tensor:
    """This rank's partials over its S-slice (max ``m`` and sum ``l``
    [...], p@V ``acc`` [..., hd], all fp32) -> the output over the whole
    cache, on every rank: one all-gather per S axis (minor first, so the
    gathered shards lie in S order), then :func:`merge`."""
    parts = torch.cat([acc, l[..., None], m[..., None]], -1)[None]
    for a in reversed(shard.axes):
        parts = shard.mesh.all_gather(parts, a, 0)
    return merge(parts)
