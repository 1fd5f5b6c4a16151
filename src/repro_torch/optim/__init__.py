"""Optimizer: AdamW (fp32 or blockwise-int8 moments) and the LR schedule."""
