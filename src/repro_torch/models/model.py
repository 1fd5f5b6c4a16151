"""Model API over the architecture families the port serves so far.

Port of ``repro.models.model``: decoder-only stacks (attention, MoE, SSM
and hybrid units) dispatch to ``transformer``; encoder-decoder models are
not ported yet (ROADMAP A.3).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from . import transformer


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet (ROADMAP A.3)")


def init(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    _decoder_only(cfg)
    return transformer.init(cfg, gen)


def draw_ssm_wo(params, cfg: ModelConfig, gen: torch.Generator):
    return transformer.draw_ssm_wo(params, cfg, gen)


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None):
    _decoder_only(cfg)
    return transformer.prefill(params, cfg, tokens, max_len)


def serve_step(params, cfg: ModelConfig, token, cache, kv_len):
    return transformer.serve_step(params, cfg, token, cache, kv_len)


def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_batch: int, device=None):
    _decoder_only(cfg)
    return transformer.make_paged_cache(cfg, num_pages, page_size, max_batch,
                                        device)


def paged_prefill_chunk(params, cfg: ModelConfig, tokens, cache, page_table,
                        start, real_len, slot, reset, page_size: int):
    """One prompt chunk through the paged cache (decoder-only stacks);
    ``start``/``real_len``/``slot`` are int32 and ``reset`` a bool device
    scalar (``reset`` zeroes the slot's SSM state on a first chunk)."""
    return transformer.paged_prefill_chunk(params, cfg, tokens, cache,
                                           page_table, start, real_len,
                                           slot, reset, page_size)


def paged_decode_step(params, cfg: ModelConfig, token, cache, page_table,
                      kv_len, active, page_size: int):
    """One decode token for every slot; sampling lives above this call."""
    return transformer.paged_decode_step(params, cfg, token, cache,
                                         page_table, kv_len, active,
                                         page_size)


def paged_verify_step(params, cfg: ModelConfig, tokens, cache, page_table,
                      kv_len, real_len, active, page_size: int):
    """Speculative verify step: score [B, K+1] draft lanes per slot in one
    pass (decoder stacks without SSM layers)."""
    return transformer.paged_verify_step(params, cfg, tokens, cache,
                                         page_table, kv_len, real_len,
                                         active, page_size)


def paged_copy_pages(cfg: ModelConfig, cache, src_ids, dst_ids):
    """Copy-on-write page duplication across the whole stack."""
    return transformer.paged_copy_pages(cfg, cache, src_ids, dst_ids)
