"""Plain reference of the index's answers (NumPy and plain PyTorch only)."""
