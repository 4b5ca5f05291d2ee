"""Synthetic data (numpy only)."""
from repro_torch.data.pipeline import (  # noqa: F401
    BatchSpec,
    TokenStream,
    synthetic_cifar,
    synthetic_mnist,
    token_batch_specs,
)
