"""Whisper-style encoder-decoder LM (audio family), ported from
``repro.models.encdec``.

The conv frontend is a stub: the caller hands in precomputed frame
embeddings [B, T_frames, d_model] (what Whisper's two strided convs would
emit).  Positions are sinusoidal (unbounded).  Decoder layers: causal
self-attention with RoPE and a dense KV cache, cross-attention over the
encoder output, and a GELU MLP.  Every projection routes through
``core.linear.apply``; the encoder's and the cross-attention's attention
are the plain chunked SDPA, as in JAX.  As in JAX, a decode step
recomputes each layer's cross K/V from ``enc_out`` (:func:`_cross_kv`).
The parameter tree keeps JAX's keys, with the ``[L, ...]`` encoder and
decoder stacks split into lists of per-layer dicts.  Training
(:func:`lm_loss`) runs the encoder and the decoder with autograd on,
each layer checkpointed under ``cfg.remat`` as JAX's scans are; the
serving entry points keep ``torch.no_grad``.

Under a tensor-parallel context (``sharding.tp``; the split train step
of ``runtime.steps``) a rank computes its share, as the decoder stacks
of ``models.transformer`` do: its heads and KV heads of all three
attention kinds, ``w_in``'s column slice (GELU on its own columns) and
``w_out``'s row-parallel K slice.  The encoder output enters the cross
K/V projections once, ahead of the decoder stack (:func:`_cross_in`),
so its gradient (each rank's wk/wv slice gives a partial one) is
all-reduced once a step.  The residual stream stays whole: JAX's
encoder-decoder reads no ``sequence_parallel``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from repro_torch.sharding import tp
from . import attention, layers, transformer


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _spec(cfg: ModelConfig, causal: bool) -> attention.AttnSpec:
    """Attention spec; under an active tensor-parallel context this
    rank's heads and KV heads (``transformer.attn_spec``)."""
    shards = tp.size()
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads // shards,
        num_kv_heads=cfg.num_kv_heads // shards,
        head_dim=cfg.resolved_head_dim, causal=causal, sliding_window=None)


def _mlp_init(gen: torch.Generator, d: int, f: int, dtype):
    return {"w_in": sl.init(gen, d, f, dtype),
            "w_out": sl.init(gen, f, d, dtype)}


def _mlp(params, x, sp):
    """GELU MLP; under tensor parallelism ``w_in`` is column-parallel
    (its input enters through ``tp.enter``) and ``w_out`` row-parallel."""
    x = tp.enter(x)
    if sp.fuse_epilogue:  # GELU in the in-projection's kernel epilogue
        h = sl.apply(params["w_in"], x, sp, activation="gelu")
    else:                 # jax.nn.gelu's tanh form
        h = F.gelu(sl.apply(params["w_in"], x, sp), approximate="tanh")
    return sl.apply(params["w_out"], h, sp, reduce_out=True)


def _enc_layer_init(cfg, gen):
    dt, dev = _dtype(cfg), gen.device
    return {"attn_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "attn": attention.init(gen, _spec(cfg, False), dt),
            "mlp_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "mlp": _mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def _dec_layer_init(cfg, gen):
    dt, dev = _dtype(cfg), gen.device
    return {"self_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "self_attn": attention.init(gen, _spec(cfg, True), dt),
            "cross_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "cross_attn": attention.init(gen, _spec(cfg, False), dt),
            "mlp_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "mlp": _mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def init(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """Random weights from ``gen`` on its device, JAX's distributions."""
    dt, dev = _dtype(cfg), gen.device
    return {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "encoder": [_enc_layer_init(cfg, gen)
                    for _ in range(cfg.encoder_layers)],
        "enc_norm": layers.rmsnorm_init(cfg.d_model, dev),
        "decoder": [_dec_layer_init(cfg, gen) for _ in range(cfg.num_layers)],
        "final_norm": layers.rmsnorm_init(cfg.d_model, dev),
        "lm_head": sl.init(gen, cfg.d_model, cfg.vocab_size, dt)}


def _enc_layer(cfg: ModelConfig, lp, x):
    sp = cfg.sparsity
    a, _ = attention.apply(lp["attn"], _spec(cfg, False),
                           layers.rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                           None, sp)
    x = x + a
    return x + _mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], x,
                                              cfg.norm_eps), sp)


def _encode(params, cfg: ModelConfig, audio_embeds) -> torch.Tensor:
    """The encoder, autograd on: each layer checkpointed under
    ``cfg.remat`` (``transformer.remat``)."""
    _, t, d = audio_embeds.shape
    dt = _dtype(cfg)
    pos = layers.sinusoidal_positions(t, d, audio_embeds.device).to(dt)
    x = audio_embeds.to(dt) + pos[None]
    for lp in params["encoder"]:
        x = (transformer.remat(_enc_layer, cfg, lp, x) if cfg.remat
             else _enc_layer(cfg, lp, x))
    return layers.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


@torch.no_grad()
def encode(params, cfg: ModelConfig, audio_embeds) -> torch.Tensor:
    """audio_embeds: [B, T, D] (conv-frontend stub output) -> [B, T, D]."""
    return _encode(params, cfg, audio_embeds)


def _cross_in(enc_out):
    """The encoder output entering the decoder's cross K/V projections
    (``tp.copy_in``: its gradient summed over the ranks)."""
    return tp.copy_in(enc_out)


def _cross_kv(lp, cfg: ModelConfig, enc_out):
    """A decoder layer's cross-attention K/V over the encoder output:
    [B, T, KVH, hd] each (this rank's KV heads under tensor
    parallelism)."""
    sp, spec = cfg.sparsity, _spec(cfg, False)
    shp = tuple(enc_out.shape[:-1]) + (spec.num_kv_heads, spec.head_dim)
    return (sl.apply(lp["cross_attn"]["wk"], enc_out, sp).reshape(shp),
            sl.apply(lp["cross_attn"]["wv"], enc_out, sp).reshape(shp))


def _cross_mlp(lp, cfg, h, enc_out):
    """A decoder layer after its self-attention: cross-attention over the
    encoder output, then the MLP, each with its residual."""
    sp = cfg.sparsity
    c, _ = attention.apply(
        lp["cross_attn"], _spec(cfg, False),
        layers.rmsnorm(lp["cross_norm"], h, cfg.norm_eps), None, sp,
        cross_kv=_cross_kv(lp, cfg, enc_out))
    h = h + c
    return h + _mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], h, cfg.norm_eps),
                    sp)


def _dec_layer(cfg: ModelConfig, lp, x, positions, enc_out):
    """A decoder layer over a whole sequence, no cache (training)."""
    a, _ = attention.apply(
        lp["self_attn"], _spec(cfg, True),
        layers.rmsnorm(lp["self_norm"], x, cfg.norm_eps), positions,
        cfg.sparsity)
    return _cross_mlp(lp, cfg, x + a, enc_out)


def lm_loss(params, cfg: ModelConfig, tokens, labels, audio_embeds):
    """Next-token cross entropy of the decoder over tokens/labels [B, S],
    given the audio frames [B, T, D]; the decoder's layers checkpointed
    under ``cfg.remat`` and the LM head sequence-chunked
    (``transformer.chunked_xent``)."""
    enc_out = _cross_in(_encode(params, cfg, audio_embeds))
    b, s = tokens.shape
    dt = _dtype(cfg)
    x = layers.embed(params["embed"], tokens).to(dt)
    x = x + layers.sinusoidal_positions(s, cfg.d_model,
                                        tokens.device).to(dt)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    for lp in params["decoder"]:
        x = (transformer.remat(_dec_layer, cfg, lp, x, positions, enc_out)
             if cfg.remat else _dec_layer(cfg, lp, x, positions, enc_out))
    h = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return transformer.chunked_xent(params["lm_head"], cfg, h, labels)


def _decoder_pass(params, cfg: ModelConfig, x, positions, enc_out, cache,
                  kv_len):
    """The decoder stack over a decode token; each layer's self cache
    ({'k','v'}, updated in place) is written at ``kv_len[0]``."""
    spec_self = _spec(cfg, True)
    for lp, lcache in zip(params["decoder"], cache):
        a, _ = attention.apply(
            lp["self_attn"], spec_self,
            layers.rmsnorm(lp["self_norm"], x, cfg.norm_eps), positions,
            cfg.sparsity, cache=lcache, kv_len=kv_len)
        x = _cross_mlp(lp, cfg, x + a, enc_out)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Per decoder layer a dense self-attention cache in the model dtype."""
    device = resolve_device(device)
    return [attention.make_cache(_spec(cfg, True), batch, max_len,
                                 _dtype(cfg), device)
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, audio_embeds,
            max_len: int | None = None):
    """Encode the audio and run the decoder over the prompt [B, S].
    Returns (logits [B, V] at the last token, {"self": per-layer caches,
    "enc_out": [B, T, D]}, kv_len [B])."""
    enc_out = encode(params, cfg, audio_embeds)
    b, s = tokens.shape
    max_len = max_len or s
    x = layers.embed(params["embed"], tokens).to(_dtype(cfg))
    x = x + layers.sinusoidal_positions(s, cfg.d_model, tokens.device).to(
        _dtype(cfg))[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    sp, spec_self = cfg.sparsity, _spec(cfg, True)
    cache = []
    for lp in params["decoder"]:
        hh = layers.rmsnorm(lp["self_norm"], x, cfg.norm_eps)
        a, _ = attention.apply(lp["self_attn"], spec_self, hh, positions, sp)
        cache.append(attention.build_prefill_cache(
            lp["self_attn"], spec_self, hh, positions, sp, max_len,
            _dtype(cfg)))
        x = _cross_mlp(lp, cfg, x + a, enc_out)
    h = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = sl.apply(params["lm_head"], h[:, -1:], sp)[:, 0]
    return logits, {"self": cache, "enc_out": enc_out}, \
        torch.full((b,), s, dtype=torch.int32, device=tokens.device)


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token, cache, kv_len):
    """One decode token [B] at positions ``kv_len`` [B] (sinusoidal row and
    RoPE); the cross K/V are recomputed from ``cache['enc_out']``.
    Returns (logits [B, V], cache, kv_len + 1)."""
    x = layers.embed(params["embed"], token[:, None]).to(_dtype(cfg))
    x = x + layers.sinusoidal_positions_at(kv_len, cfg.d_model).to(
        _dtype(cfg))[:, None, :]
    h, new_self = _decoder_pass(params, cfg, x, kv_len[:, None],
                                cache["enc_out"], cache["self"], kv_len)
    logits = sl.apply(params["lm_head"], h, cfg.sparsity)[:, 0]
    return logits, {"self": new_self, "enc_out": cache["enc_out"]}, kv_len + 1
