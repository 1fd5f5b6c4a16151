"""Carry weights of the JAX package into the port.

``params_from_jax`` takes the tree of the JAX ``model.init`` converted to
numpy (``jax.tree_util.tree_map(np.asarray, tree)``) and returns the
port's parameter tree: the same nested dicts, with the JAX stack of
scanned units ``units[leaf] : [U, ...]`` split into a list of U unit
dicts.  Nothing here imports JAX; numpy arrays of the ml_dtypes types
(bfloat16, float8_e4m3fn) are reinterpreted bit for bit.  Like every
entry point of the port, both functions put their tensors on the card
unless the caller names a device (``resolve_device``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

_BITCAST = {"bfloat16": (np.int16, torch.bfloat16),
            "float8_e4m3fn": (np.int8, torch.float8_e4m3fn)}


def to_torch(a, device=None) -> torch.Tensor:
    """numpy (or array-like) -> torch tensor with identical bits."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name in _BITCAST:
        raw, dt = _BITCAST[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(raw).copy()).view(
            dt).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(tree: dict[str, Any], cfg, device=None) -> dict[str, Any]:
    """JAX ``model.init`` tree (as numpy) -> the port's parameters."""
    device = resolve_device(device)
    out = {k: _map(v, lambda a: to_torch(a, device))
           for k, v in tree.items() if k != "units"}
    out["units"] = [_map(tree["units"], lambda a, u=u: to_torch(a[u], device))
                    for u in range(cfg.num_units)]
    return out
