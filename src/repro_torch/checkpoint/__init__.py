"""Checkpoints in the JAX package's on-disk format (PyTorch)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    restore_into,
)
