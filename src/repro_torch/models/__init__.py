"""Model stack: layers, attention (one-shot and paged), MoE, SSM,
transformer, encoder-decoder and the model API."""
from . import layers, attention, moe, ssm, transformer, encdec, model  # noqa: F401
