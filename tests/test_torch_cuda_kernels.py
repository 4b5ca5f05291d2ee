"""The CUDA LUT-MU kernels against their plain PyTorch versions.

The kernels need a card: these tests carry the ``cuda`` marker and skip
without one.  The module imports no JAX, so it runs on the card as
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
int8 results must be bit-equal; float32/bfloat16 LUT sums within rtol 1e-5,
atol 1e-4 (float32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import lut_aggregate as LA
from repro_torch.kernels import maddness_encode as ME

# (B, C, N, depth): ragged B, C and N at each depth
CASES = [(5, 7, 130, 2), (16, 3, 33, 3), (1, 12, 257, 4), (9, 5, 64, 4)]
LUT_DTYPES = ["int8", "float32", "bfloat16"]
_TORCH = {"int8": torch.int8, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _inputs(b, c, n, depth, lut_dtype, seed=0, unit_epilogue=False):
    """numpy inputs (bf16 LUT values are exactly representable, so every
    consumer, the JAX package included, holds the same table)."""
    rng = np.random.default_rng(seed)
    g = 2**depth
    x = rng.normal(size=(b, c, depth)).astype(np.float32)
    thr = rng.normal(size=(c, g - 1)).astype(np.float32)
    if lut_dtype == "int8":
        lut = rng.integers(-128, 128, size=(c, g, n)).astype(np.int8)
    else:
        lut = rng.normal(size=(c, g, n)).astype(np.float32)
        if lut_dtype == "bfloat16":
            lut = torch.from_numpy(lut).to(torch.bfloat16).float().numpy()
    if unit_epilogue:
        scale, offset = np.float32(1.0), np.float32(0.0)
        scale, offset = np.asarray(scale), np.asarray(offset)
    else:
        scale = rng.uniform(0.005, 0.02, size=(n,)).astype(np.float32)
        offset = rng.normal(size=(n,)).astype(np.float32)
    return x, thr, lut, scale, offset


def _torch(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out.to(_TORCH[dtype]) if dtype else out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays, dtype=None):
    return [_torch(a, dtype).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(32, 640, 8704, 4)])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_matches_plain(cuda_device, case, lut_dtype):
    x, thr, lut, scale, offset = _inputs(*case, lut_dtype)
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype=lut_dtype)
    before = FL.LAUNCHES.n
    got = FL.fused_lutmu(xt, tt, lt, st, ot)
    torch.cuda.synchronize()
    assert FL.LAUNCHES.n == before + 1
    want = FL.fused_lutmu_plain(xt, tt, lt, st, ot)
    if lut_dtype == "int8":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_encode_onehot_matches_plain(cuda_device, case, out_dtype):
    x, thr, *_ = _inputs(*case, "float32")
    xt, tt = _on(cuda_device, x, thr)
    got = ME.encode_onehot(xt, tt, out_dtype=_TORCH[out_dtype])
    want = ME.encode_onehot_plain(xt, tt, _TORCH[out_dtype])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_lut_aggregate_matches_plain(cuda_device, case, lut_dtype):
    x, thr, lut, scale, offset = _inputs(*case, lut_dtype)
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype=lut_dtype)
    onehot = ME.encode_onehot_plain(xt, tt)
    got = LA.lut_aggregate(onehot, lt, st, ot)
    want = LA.lut_aggregate_plain(onehot, lt, st, ot)
    if lut_dtype == "int8":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    x, thr, lut, scale, offset = _inputs(4, 3, 32, 2, "int8")
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype="int8")
    with pytest.raises(ValueError):
        FL.fused_lutmu(xt.double(), tt, lt, st, ot)
    with pytest.raises(ValueError):
        FL.fused_lutmu(xt.transpose(0, 1).contiguous().transpose(0, 1), tt,
                       lt, st, ot)  # same shape, not contiguous
    with pytest.raises(ValueError):
        FL.fused_lutmu(xt.cpu(), tt, lt, st, ot)
