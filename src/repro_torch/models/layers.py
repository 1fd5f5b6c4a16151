"""Shared layers (plain functions on parameter dicts), ported from
``repro.models.layers``.  Every projection routes through
``core.linear`` so the technique is one flag across the stack."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import linear as sl
from repro_torch.core.linear import SparsityConfig
from repro_torch.sharding import tp


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): hd/2 split into (t, h, w) sections by
    the relative weights ``sections`` (the last takes the rest), each
    rotated by its own position stream.  x: [B, S, H, hd]; positions:
    [3, B, S] int.  With three equal streams this is :func:`apply_rope`."""
    hd = x.shape[-1]
    half = hd // 2
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    freqs = rope_frequencies(hd, theta, x.device)
    parts, off = [], 0
    for stream, size in enumerate(sizes):
        parts.append(positions[stream][..., None].to(torch.float32)
                     * freqs[off:off + size])
        off += size
    angles = torch.cat(parts, dim=-1)  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [max_len, d]."""
    return sinusoidal_positions_at(
        torch.arange(max_len, dtype=torch.int32,
                     device=resolve_device(device)), d)


def sinusoidal_positions_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal rows at arbitrary positions [N] -> [N, d] (fp32), on
    the positions' device."""
    pos = positions.to(torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return {"w_gate": sl.init(gen, d_model, d_ff, dtype),
            "w_up": sl.init(gen, d_model, d_ff, dtype),
            "w_down": sl.init(gen, d_ff, d_model, dtype)}


def swiglu(params, x: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Gate/up/down MLP; with ``cfg.fuse_epilogue`` the SiLU rides the gate
    projection's kernel epilogue instead of a separate pass.  Under tensor
    parallelism gate/up are column-parallel (the SiLU stays on local
    columns; their input enters through ``tp.enter``) and down is
    row-parallel: ``reduce_out`` all-reduces its output."""
    x = tp.enter(x)
    if cfg.fuse_epilogue:
        g = sl.apply(params["w_gate"], x, cfg, activation="silu")
        u = sl.apply(params["w_up"], x, cfg)
        return sl.apply(params["w_down"], g * u, cfg, reduce_out=True)
    g = sl.apply(params["w_gate"], x, cfg)
    u = sl.apply(params["w_up"], x, cfg)
    return sl.apply(params["w_down"], g * torch.sigmoid(g) * u, cfg,
                    reduce_out=True)


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
