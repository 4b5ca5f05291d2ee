"""Synthetic data (numpy only)."""
from repro_torch.data.pipeline import TokenStream  # noqa: F401
