"""whisper-small [audio] — arXiv:2212.04356 (unverified). Encoder-decoder.

12L (decoder) + 12L encoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
Conv frontend is a stub per the brief (input_specs provides precomputed
frame embeddings); positions are sinusoidal so arbitrary decode lengths
lower.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    unit_pattern=("attn",),
    moe_pattern=(False,),
    is_encoder_decoder=True,
    encoder_layers=12,
    max_source_positions=1500,
    frontend="audio",
)
