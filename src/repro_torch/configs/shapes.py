"""Assigned input shapes (the 4 cells per architecture) + input_specs()
(port of ``repro.configs.shapes``).

LM transformer shapes are seq_len x global_batch.  decode_*/long_* run
``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``.  long_500k runs only for sub-quadratic archs.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

I32 = torch.int32


def _spec(shape, dtype) -> torch.Tensor:
    """A stand-in of this shape and dtype that holds no memory (JAX's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int):
    d = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        # conv-frontend stub output: precomputed frame embeddings
        return {"audio_embeds": _spec(
            (batch, cfg.max_source_positions, cfg.d_model), d)}
    if cfg.frontend == "vision":
        # patch-embedding stub: 256 visual tokens prepended to the sequence
        return {"vision_embeds": _spec((batch, 256, cfg.d_model), d)}
    return {}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {
            "tokens": _spec((b, s), I32),
            "labels": _spec((b, s), I32),
        }
        specs.update(_frontend_specs(cfg, b))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _spec((b, s), I32)}
        specs.update(_frontend_specs(cfg, b))
        return specs
    if shape.kind == "decode":
        return {
            "token": _spec((b,), I32),
            "kv_len": _spec((b,), I32),
        }
    raise ValueError(shape.kind)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention stack: long_500k needs "
                       "sub-quadratic attention (skip noted in DESIGN.md §8)")
    return True, ""
