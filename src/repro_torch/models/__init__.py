"""Model layers, attention and the paged LM (PyTorch)."""
