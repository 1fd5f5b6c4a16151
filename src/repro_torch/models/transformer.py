"""Decoder-only LM stack: dense attention / sliding-window units (port).

Port of ``repro.models.transformer`` for the stacks this slice serves:
``attn``/``swa`` units with a dense SwiGLU FFN.  The JAX package scans a
stack of ``[U, ...]`` unit parameters; the port keeps ``params['units']``
as a list of U unit dicts (same inner keys, ``layer_i``) and loops over it
in Python.  SSM and MoE units raise (ROADMAP A.7).  Every projection
routes through ``core.linear.apply`` on ``cfg.sparsity``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from . import attention, layers


def _check_supported(cfg: ModelConfig) -> None:
    if any(k not in ("attn", "swa") for k in cfg.unit_pattern) or cfg.uses_moe:
        raise NotImplementedError(
            f"{cfg.name}: unit pattern {cfg.unit_pattern} / MoE "
            f"{cfg.moe_pattern} is not ported yet — the port serves attn/swa "
            "units with a dense SwiGLU FFN (ROADMAP A.7)")
    if cfg.m_rope:
        raise NotImplementedError(f"{cfg.name}: M-RoPE not ported yet "
                                  "(ROADMAP A.7)")


def attn_spec(cfg: ModelConfig, kind: str) -> attention.AttnSpec:
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, causal=True,
        sliding_window=cfg.sliding_window if kind == "swa" else None)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layers(cfg: ModelConfig):
    """(unit index, layer key, kind) in execution order."""
    for u in range(cfg.num_units):
        for i, kind in enumerate(cfg.unit_pattern):
            yield u, f"layer_{i}", kind


# ------------------------------------------------------------------ init
def init(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """Random weights from ``gen`` on its device, with the JAX
    distributions: linears N(0, 1) * k^-0.5, embedding 0.02 * N(0, 1)."""
    _check_supported(cfg)
    dt, dev = _dtype(cfg), gen.device
    units = []
    for _ in range(cfg.num_units):
        unit = {}
        for i, kind in enumerate(cfg.unit_pattern):
            lp = {"pre_norm": layers.rmsnorm_init(cfg.d_model, dev),
                  "mixer": attention.init(gen, attn_spec(cfg, kind), dt)}
            if cfg.d_ff > 0:
                lp["ffn_norm"] = layers.rmsnorm_init(cfg.d_model, dev)
                lp["ffn"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)
            unit[f"layer_{i}"] = lp
        units.append(unit)
    return {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "units": units,
            "final_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "lm_head": sl.init(gen, cfg.d_model, cfg.vocab_size, dt)}


def _ffn(lp, cfg: ModelConfig, xx):
    if cfg.d_ff > 0:
        h = layers.rmsnorm(lp["ffn_norm"], xx, cfg.norm_eps)
        xx = xx + layers.swiglu(lp["ffn"], h, cfg.sparsity)
    return xx


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["lm_head"], hidden, cfg.sparsity)


def _embed(params, cfg, tokens):
    return layers.embed(params["embed"], tokens).to(_dtype(cfg))


# ------------------------------------------------------------- one-shot
@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None):
    """Full-prompt forward; returns (logits_last [B, V], cache, kv_len)."""
    _check_supported(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    xx = _embed(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    sp = cfg.sparsity
    kv = getattr(torch, cfg.kv_cache_dtype)
    cache = [dict() for _ in range(cfg.num_units)]
    for u, key, kind in _layers(cfg):
        lp = params["units"][u][key]
        spec = attn_spec(cfg, kind)
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        y, _ = attention.apply(lp["mixer"], spec, hh, positions, sp)
        cache[u][key] = attention.build_prefill_cache(
            lp["mixer"], spec, hh, positions, sp, max_len, kv)
        xx = _ffn(lp, cfg, xx + y)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    logits = logits_fn(params, cfg, h[:, -1:, :])[:, 0]
    kv_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, kv_len


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token, cache, kv_len):
    """One-token decode over the dense cache (updated in place).
    token: [B] int; returns (logits [B, V], cache, kv_len + 1)."""
    xx = _embed(params, cfg, token[:, None])
    positions = kv_len[:, None]
    for u, key, kind in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        y, _ = attention.apply(lp["mixer"], attn_spec(cfg, kind), hh,
                               positions, cfg.sparsity, cache=cache[u][key],
                               kv_len=kv_len)
        xx = _ffn(lp, cfg, xx + y)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    return logits_fn(params, cfg, h)[:, 0], cache, kv_len + 1


# ------------------------------------------------------- paged inference
def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_batch: int, device=None):
    """Per unit, per attention layer, a physical page pool of
    ``num_pages`` pages [page_size, KVH, hd] and the spare page that takes
    dropped writes (``attention.make_paged_pool``); one logical page id
    addresses the same slot in every layer."""
    _check_supported(cfg)
    kv = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)
    return [{f"layer_{i}": attention.make_paged_pool(
                attn_spec(cfg, kind), num_pages, page_size, kv, device)
             for i, kind in enumerate(cfg.unit_pattern)}
            for _ in range(cfg.num_units)]


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, tokens, cache, page_table,
                        start: torch.Tensor, real_len: torch.Tensor,
                        page_size: int):
    """One prompt chunk of one sequence through the paged cache.
    tokens: [1, C] (rows >= real_len are right-padding); page_table:
    [1, max_pages]; start/real_len: int32 device scalars (0-d), so the
    step reads no value on the host.  Returns (logits [1, V] at the last
    real token, cache)."""
    b, c = tokens.shape
    xx = _embed(params, cfg, tokens)
    positions = start + torch.arange(c, dtype=torch.int32,
                                     device=tokens.device)[None].expand(b, c)
    for u, key, kind in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        y, _ = attention.paged_prefill_chunk(
            lp["mixer"], attn_spec(cfg, kind), hh, positions, cfg.sparsity,
            cache[u][key], page_table, start, real_len, page_size)
        xx = _ffn(lp, cfg, xx + y)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    last = torch.clamp(real_len - 1, 0, c - 1).long().reshape(1)
    return logits_fn(params, cfg, h.index_select(1, last))[:, 0], cache


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, token, cache, page_table,
                      kv_len, active, page_size: int):
    """One decode token for every slot.  token: [B]; kv_len: [B] context
    lengths already written; active: [B] bool.
    Returns (logits [B, V], cache)."""
    xx = _embed(params, cfg, token[:, None])
    for u, key, kind in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        y, _ = attention.paged_decode_step(
            lp["mixer"], attn_spec(cfg, kind), hh, cfg.sparsity,
            cache[u][key], page_table, kv_len, active, page_size)
        xx = _ffn(lp, cfg, xx + y)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    return logits_fn(params, cfg, h)[:, 0], cache
