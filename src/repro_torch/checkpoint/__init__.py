"""Atomic, asynchronous checkpoints with exact resume."""
