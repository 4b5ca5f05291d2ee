"""FINN-style quantisation baseline (PyTorch)."""
from repro_torch.quant.fake_quant import (  # noqa: F401
    fake_quant,
    quant_params_bits,
    successive_threshold,
    thresholds_from_bn,
)
