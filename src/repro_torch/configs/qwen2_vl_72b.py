"""qwen2-vl-72b [vlm] — arXiv:2409.12191 (hf).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE, dynamic
resolution.  Backbone only per the brief: the vision frontend is a stub
(input_specs provides precomputed patch embeddings).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    unit_pattern=("attn",),
    moe_pattern=(False,),
    m_rope=True,
    frontend="vision",
)
