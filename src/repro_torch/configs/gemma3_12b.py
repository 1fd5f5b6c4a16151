"""gemma3-12b [dense] — hf:google/gemma-3-1b-pt family (unverified).

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
interleave (sliding window 1024 on local layers), 128k context.
head_dim=256 (q_dim != d_model, Gemma convention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    unit_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    moe_pattern=(False,) * 6,
    sliding_window=1024,
    rope_theta=1e6,
)
