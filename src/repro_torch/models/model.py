"""Model API over every architecture family of the registry.

Port of ``repro.models.model``: decoder-only stacks (attention with RoPE
or M-RoPE, MoE, SSM and hybrid units) dispatch to ``transformer``, the
encoder-decoder (whisper) to ``encdec``.  ``extra_embeds`` carries the
modality frontend stub's output: the audio frames [B, T, D] an
encoder-decoder needs, or the vision patch embeddings [B, n, D] summed
into a decoder's first n prompt positions.  The paged engine's steps are
decoder-only, as in JAX: encoder-decoder models serve through the
one-shot ``serve_loop.generate``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ModelConfig
from . import encdec, transformer


def init(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    if cfg.is_encoder_decoder:
        return encdec.init(cfg, gen)
    return transformer.init(cfg, gen)


def draw_ssm_wo(params, cfg: ModelConfig, gen: torch.Generator):
    return transformer.draw_ssm_wo(params, cfg, gen)


def _extra_embeds(cfg: ModelConfig, batch):
    if cfg.frontend == "audio":
        return batch["audio_embeds"]
    if cfg.frontend == "vision":
        return batch.get("vision_embeds")
    return None


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token cross entropy of a training batch {'tokens',
    'labels' [B, S], and 'audio_embeds' or 'vision_embeds' where the
    frontend takes them}, with autograd on."""
    if cfg.is_encoder_decoder:
        return encdec.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch["audio_embeds"])
    return transformer.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                               _extra_embeds(cfg, batch))


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None,
            extra_embeds=None):
    if cfg.is_encoder_decoder:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                             "the audio frames (extra_embeds)")
        return encdec.prefill(params, cfg, tokens, extra_embeds, max_len)
    return transformer.prefill(params, cfg, tokens, max_len, extra_embeds)


def serve_step(params, cfg: ModelConfig, token, cache, kv_len):
    if cfg.is_encoder_decoder:
        return encdec.serve_step(params, cfg, token, cache, kv_len)
    return transformer.serve_step(params, cfg, token, cache, kv_len)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The one-shot dense cache: for an encoder-decoder its decoder's self
    caches and a zero ``enc_out`` [B, max_source_positions, D]."""
    if cfg.is_encoder_decoder:
        return {"self": encdec.make_cache(cfg, batch, max_len, device),
                "enc_out": torch.zeros(
                    (batch, cfg.max_source_positions, cfg.d_model),
                    dtype=getattr(torch, cfg.dtype),
                    device=resolve_device(device))}
    return transformer.make_cache(cfg, batch, max_len, device)


def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_batch: int, device=None):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "paged serving engine covers decoder-only stacks; encoder-"
            "decoder serving uses the dense one-shot path (serve_loop."
            "generate)")
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


def param_count(params) -> int:
    """Elements over the tree's leaves (tensors of any device, meta too)."""
    return sum(int(x.numel()) for x in tree.leaves(params))
