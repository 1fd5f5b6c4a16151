"""Architecture configs (one module per arch) + shapes + registry."""
from .base import ModelConfig  # noqa: F401
from .shapes import SHAPES, ShapeSpec, input_specs, applicable  # noqa: F401
from .registry import CONFIGS, ARCH_IDS, get, smoke_config  # noqa: F401
