"""The SlideSparse operator pair (Phi, Psi) — paper §3.

``phi`` (weight transformation) is the packer; ``lift`` (activation
lifting Psi, §3.3) replicates input elements by window coverage — pure
index remapping — so that ``w^T x == Phi(w)^T Psi(x)`` (paper Eq. 3).
``slided_matmul`` is the paper's GPU semantics in plain torch: lifted
activations against slided weights over the gamma*K contraction;
``unslid_matmul`` scatters the windows back to the original K first (the
same product over K, 1.0x dense FLOPs), and ``dense_matmul`` is the
baseline ``x @ W^T``.  All three are plain full-fp32 products (TF32 is
off for the process, ``repro_torch/__init__``), as JAX's run at
``Precision.HIGHEST`` outside any kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .patterns import HardwarePattern, Pattern, SlideDecomposition, TWO_FOUR
from . import packer


@functools.lru_cache(maxsize=None)
def lift_index_map(k: int, z: int, l: int, m: int, n: int) -> np.ndarray:
    """Gather indices idx[gamma*K] with Psi(x) = x[..., idx]: output
    position (group g, window j, offset d) reads source L*g + s*j + d."""
    dec = SlideDecomposition(Pattern(z, l), HardwarePattern(m, n))
    g = k // l
    block = np.asarray(dec.lift_indices_block(), dtype=np.int32)
    return (np.arange(g, dtype=np.int32)[:, None] * l
            + block[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _lift_index(k: int, z: int, l: int, m: int, n: int,
                device: torch.device) -> torch.Tensor:
    """:func:`lift_index_map` on ``device``, copied there once: a step
    that lifts copies nothing from the host, so a CUDA graph can hold it."""
    return torch.as_tensor(lift_index_map(k, z, l, m, n), dtype=torch.long,
                           device=device)


def lift(x: torch.Tensor, dec: SlideDecomposition) -> torch.Tensor:
    """Activation lifting Psi: [..., K] -> [..., gamma*K] (paper Eq. 4)."""
    return x.index_select(-1, _lift_index(x.shape[-1], dec.source.z,
                                          dec.source.l, dec.hw.m, dec.hw.n,
                                          x.device))


def phi(w: torch.Tensor, dec: SlideDecomposition) -> torch.Tensor:
    """Weight transformation Phi (Thm 1 constructive proof / Alg. 2)."""
    return packer.pack_slided(w, dec)


def slided_matmul(x: torch.Tensor, w_slided: torch.Tensor,
                  dec: SlideDecomposition) -> torch.Tensor:
    """Paper-faithful execution y = Psi(x) @ Phi(W)^T.  x: [..., K];
    w_slided: [M, gamma*K] (from ``phi``); returns [..., M] in the promoted
    dtype of the two, as ``jnp.einsum`` does."""
    return dense_matmul(lift(x, dec), w_slided)


def unslid_matmul(x: torch.Tensor, w_slided: torch.Tensor,
                  dec: SlideDecomposition) -> torch.Tensor:
    """y = x @ unslide(Phi(W))^T: the windows scattered back to the
    original K, then a dense product (identical output: the packer is
    lossless).  Returns [..., M] in the promoted dtype."""
    return dense_matmul(x, packer.unslide(w_slided, dec))


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Baseline y = x @ W^T with W [M, K], in the promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


def decomposition_for(pattern: Pattern) -> SlideDecomposition:
    """Default mapping of a source pattern onto 2:4 hardware windows."""
    return SlideDecomposition(pattern, TWO_FOUR)
