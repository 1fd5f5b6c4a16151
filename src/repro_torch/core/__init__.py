"""Core SlideSparse algebra (patterns, packer, slide, compression, quant)."""
