"""(2N-2):2N magnitude masks and straight-through-estimator training
(port of ``repro.core.masks``).

``ste_prune`` lets a model train under the pattern from initialisation
(sparse-aware training, Zhou et al. 2021; the paper's §8): the forward
sees the magnitude-pruned weights, the backward passes the gradient of
every weight, kept or pruned, straight through.
"""
from __future__ import annotations

import torch

from .packer import magnitude_keep_mask, prune_to_pattern
from .patterns import Pattern


def magnitude_mask(w: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """Boolean keep-mask: top-Z by |w| in every L-group."""
    return magnitude_keep_mask(w, pattern)


def ste_prune(w: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """Forward: magnitude-pruned weights.  Backward: identity (dense
    grads).  ``w + (pruned - w)`` with the difference detached, JAX's
    ``w + stop_gradient(pruned - w)``: a kept weight adds 0, a pruned one
    adds -w, both exact."""
    with torch.no_grad():
        delta = prune_to_pattern(w, pattern) - w
    return w + delta
