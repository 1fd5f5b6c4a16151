"""Architecture configs (one module per arch) + registry."""
from .base import ModelConfig  # noqa: F401
from .registry import CONFIGS, ARCH_IDS, get, smoke_config  # noqa: F401
