"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0 family (hf).

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    unit_pattern=("attn",),
    moe_pattern=(True,),
    moe_num_experts=40,
    moe_top_k=8,
)
