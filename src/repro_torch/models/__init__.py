"""Model stack: layers, attention (one-shot and paged), transformer."""
