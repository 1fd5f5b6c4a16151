"""The deterministic synthetic token stream and its prefetcher."""
