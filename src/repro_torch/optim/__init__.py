"""Optimizer: AdamW (fp32 or blockwise-int8 moments) and the LR schedule."""
from .adamw import AdamWConfig, OptState, init, update, global_norm  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
