"""Plain references: PyTorch only, importing nothing of the program."""
