"""Shared layers (plain functions on parameter dicts), ported from
``repro.models.layers``.  Every projection routes through
``core.linear`` so the technique is one flag across the stack."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import linear as sl
from repro_torch.core.linear import SparsityConfig


def rmsnorm_init(d: int, device=None):
    return {"g": torch.ones((d,), dtype=torch.float32,
                            device=resolve_device(device))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params["g"]).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=resolve_device(device))
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int. Half-split convention."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return {"w_gate": sl.init(gen, d_model, d_ff, dtype),
            "w_up": sl.init(gen, d_model, d_ff, dtype),
            "w_down": sl.init(gen, d_ff, d_model, dtype)}


def swiglu(params, x: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Gate/up/down MLP; with ``cfg.fuse_epilogue`` the SiLU rides the gate
    projection's kernel epilogue instead of a separate pass."""
    if cfg.fuse_epilogue:
        g = sl.apply(params["w_gate"], x, cfg, activation="silu")
        u = sl.apply(params["w_up"], x, cfg)
        return sl.apply(params["w_down"], g * u, cfg)
    g = sl.apply(params["w_gate"], x, cfg)
    u = sl.apply(params["w_up"], x, cfg)
    return sl.apply(params["w_down"], g * torch.sigmoid(g) * u, cfg)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
    return {"w": w.to(dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["w"][tokens]


def unembed(params, x: torch.Tensor,
            cfg: SparsityConfig = sl.DENSE) -> torch.Tensor:
    """LM head, SparseLinear-routed like every other projection."""
    return sl.apply(params, x, cfg)
