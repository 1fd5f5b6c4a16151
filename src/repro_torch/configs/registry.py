"""--arch <id> registry + reduced smoke-test configs."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig
from . import (jamba_1_5_large_398b, h2o_danube_3_4b, phi3_medium_14b,
               gemma3_12b, minitron_4b, mamba2_780m, granite_moe_3b_a800m,
               mixtral_8x22b, qwen2_vl_72b, whisper_small)

_MODULES = [jamba_1_5_large_398b, h2o_danube_3_4b, phi3_medium_14b,
            gemma3_12b, minitron_4b, mamba2_780m, granite_moe_3b_a800m,
            mixtral_8x22b, qwen2_vl_72b, whisper_small]

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = sorted(CONFIGS)


def get(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return CONFIGS[key]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small widths/depths, tiny vocab —
    runs one forward/train step on a single CPU device."""
    cfg = get(arch)
    return dataclasses.replace(
        cfg,
        num_layers=len(cfg.unit_pattern) * min(2, cfg.num_units),
        d_model=64,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=min(cfg.d_ff, 96) if cfg.d_ff else 0,
        vocab_size=128,
        moe_num_experts=min(cfg.moe_num_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        # no capacity drops at smoke scale: keeps prefill/decode bit-consistent
        moe_capacity_factor=16.0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        sliding_window=16,
        encoder_layers=min(cfg.encoder_layers, 2),
        max_source_positions=min(cfg.max_source_positions, 8),
        logits_chunk=16,
        dtype="float32",
    )
