"""mixtral-8x22b [moe] — arXiv:2401.04088 (hf).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    unit_pattern=("swa",),
    moe_pattern=(True,),
    moe_num_experts=8,
    moe_top_k=2,
    sliding_window=4096,
)
