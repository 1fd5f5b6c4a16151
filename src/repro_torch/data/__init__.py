"""The deterministic synthetic token stream and its prefetcher."""
from .pipeline import SyntheticLM, Prefetcher  # noqa: F401
