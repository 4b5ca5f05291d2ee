"""Optimizer and gradient compression (PyTorch, on param dicts)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    compress_gradients,
    compression_init,
    dequantize,
)
