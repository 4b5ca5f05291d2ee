"""MADDNESS online path and LUT-MU chain pruning (PyTorch)."""
