"""Runtime: step functions, the train and serve loops, KV page accounting,
the scheduler and fault tolerance."""
from . import steps  # noqa: F401
