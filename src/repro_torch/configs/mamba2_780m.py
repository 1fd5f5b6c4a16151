"""mamba2-780m [ssm] — arXiv:2405.21060 (unverified). SSD, attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.  num_heads fields are
nominal (no attention layers exist).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=12,
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    unit_pattern=("ssm",),
    moe_pattern=(False,),
    ssm_state=128,
)
