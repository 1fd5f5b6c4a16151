"""Serving runtime: KV page accounting, scheduler, engine."""
