"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba+attn 1:7 interleave (one attention layer per 8-layer block), MoE on
every other layer.  SSM realized as Mamba-2 SSD (see DESIGN.md: the scan is
attn-free; SlideSparse covers the in/out projections).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    unit_pattern=("ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm", "ssm"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    moe_num_experts=16,
    moe_top_k=2,
    ssm_state=128,
    # d_inner=16384 -> 256 SSD heads: the [B,H,C,Q,Q] decay matrix at Q=256
    # costs ~17 GB/device in the 4k train cell; Q=64 caps it at ~0.3 GB
    # (EXPERIMENTS.md §Perf extras)
    ssm_chunk=64,
)
