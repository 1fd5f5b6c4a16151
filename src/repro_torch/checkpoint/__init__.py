"""Atomic, asynchronous checkpoints with exact resume."""
from .checkpointer import (  # noqa: F401
    save, restore, latest_step, AsyncCheckpointer,
)
