"""The CUDA kernels against their plain PyTorch versions.

The kernels need a card: these tests carry the ``cuda`` marker and skip
without one.  The module imports no JAX, so it runs on the card as
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
LUT-MU: int8 results must be bit-equal; int16 results bit-equal wherever
C ≤ 512 (the plain version sums int16 entries in float32, exact while every
partial sum stays within 2**24 = 512 · 2**15), else within ``_int16_tol``;
float32/bfloat16 LUT sums within rtol 1e-5, atol 1e-4 (float32 sums taken
in another order).  Verify window:
tolerances at ``VERIFY_TOL`` below, each with its reason.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import lut_aggregate as LA
from repro_torch.kernels import fused_verify as FV
from repro_torch.kernels import maddness_encode as ME
from repro_torch.kernels.ref import encode_codes_ref
from repro_torch.models import attention as TA
from repro_torch.models.config import ModelConfig

# (B, C, N, depth): ragged B, C and N at each depth
CASES = [(5, 7, 130, 2), (16, 3, 33, 3), (1, 12, 257, 4), (9, 5, 64, 4)]
LUT_DTYPES = ["int8", "int16", "float32", "bfloat16"]
_TORCH = {"int8": torch.int8, "int16": torch.int16, "float32": torch.float32,
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
    elif lut_dtype == "int16":
        lut = rng.integers(-2**15, 2**15, size=(c, g, n)).astype(np.int16)
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


def _int16_tol(c: int, scale: torch.Tensor) -> dict:
    """int16 tables above 512 codebooks: each of the plain version's C - 1
    float32 additions may round by half an ulp of the largest possible sum
    (C · 2**15), and the epilogue scales that."""
    ulp = 2.0 ** (math.ceil(math.log2(c * 2**15)) - 23)
    return dict(rtol=1e-6, atol=(c - 1) * ulp / 2 * scale.abs().max().item())


def assert_lut_sums(got, want, lut_dtype: str, c: int, scale):
    """int8 bit-equal, int16 bit-equal at C ≤ 512 (else ``_int16_tol``),
    float within rtol 1e-5 / atol 1e-4."""
    if lut_dtype == "int8" or (lut_dtype == "int16" and c <= 512):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    elif lut_dtype == "int16":
        torch.testing.assert_close(got, want, **_int16_tol(c, scale))
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


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
    assert_lut_sums(got, want, lut_dtype, case[1], st)


def _forced_plan(b, c, depth, lut_dtype, cluster, k_stage=None, thr_smem=None):
    """A launch plan that ``FL.plan`` might not pick: every cluster size,
    short ring stages, thresholds read from device memory."""
    itemsize = torch.empty((), dtype=_TORCH[lut_dtype]).element_size()
    p = FL.sized(b, c, depth, itemsize, cluster)
    k_stage = k_stage or p.k_stage
    thr_smem = p.thr_smem if thr_smem is None else thr_smem
    smem = FL.smem_bytes(b, depth, itemsize, p.per, k_stage, thr_smem)
    return FL.Plan(p.tile_bytes, cluster, p.per, k_stage, thr_smem, smem)


def _lutmu_vs_plain(dev, arrays, lut_dtype, launch_plan=None):
    """The kernel (one launch) against the plain version (see
    :func:`assert_lut_sums`).  Returns the kernel's output."""
    x, thr, lut, scale, offset = arrays
    xt, tt, st, ot = _on(dev, x, thr, scale, offset)
    (lt,) = _on(dev, lut, dtype=lut_dtype)
    before = FL.LAUNCHES.n
    if launch_plan is None:
        got = FL.fused_lutmu(xt, tt, lt, st, ot)
    else:
        got = FL.launch(xt, tt, lt, st, ot, launch_plan)
    torch.cuda.synchronize()
    assert FL.LAUNCHES.n == before + 1
    want = FL.fused_lutmu_plain(xt, tt, lt, st, ot)
    assert_lut_sums(got, want, lut_dtype, x.shape[1], st)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 31, 32, 33, 70])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_row_groups(cuda_device, b, lut_dtype):
    """Batches of one row group (≤ 32 rows) and of two or three."""
    _lutmu_vs_plain(cuda_device, _inputs(b, 37, 304, 4, lut_dtype, seed=b),
                    lut_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_depths(cuda_device, depth, lut_dtype):
    """Depth 1 (G = 2) and depth 8 (G = 256 leaves, 8 threshold registers
    per lane, up to 32 distinct leaves per codebook)."""
    _lutmu_vs_plain(cuda_device, _inputs(33, 20, 208, depth, lut_dtype, seed=2),
                    lut_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 13])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_few_codebooks_in_a_cluster(cuda_device, c, lut_dtype):
    """Clusters of 8 over fewer codebooks (blocks with empty slices) and
    over a count that 8 does not divide; N = 257, rows not 16-byte
    aligned."""
    arrays = _inputs(6, c, 257, 4, lut_dtype, seed=c)
    p = _forced_plan(6, c, 4, lut_dtype, 8)
    _lutmu_vs_plain(cuda_device, arrays, lut_dtype, p)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 5, 8, 12, 16])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_every_cluster_size(cuda_device, cluster, lut_dtype):
    """Every cluster size up to the non-portable 16, over 600 codebooks,
    so a thread of a one-block cluster adds more than 256 (the int8 16-bit
    lanes flush); stages of 3 codebooks (the last one short), and with one
    block the thresholds read from device memory."""
    b, c, n = 9, 600, 1104
    arrays = _inputs(b, c, n, 4, lut_dtype, seed=cluster)
    p = _forced_plan(b, c, 4, lut_dtype, cluster, k_stage=3,
                     thr_smem=cluster > 1)
    _lutmu_vs_plain(cuda_device, arrays, lut_dtype, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1003, 1040])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_ragged_n(cuda_device, n, lut_dtype):
    """Ragged last N-tiles: LUT rows that are not 16-byte aligned (N = 1,
    33, 1003: copied entry by entry) and rows that are (N = 1040)."""
    _lutmu_vs_plain(cuda_device, _inputs(7, 19, n, 3, lut_dtype, seed=n),
                    lut_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["same", "distinct"])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_fused_lutmu_shared_and_distinct_leaves(cuda_device, kind,
                                                     lut_dtype):
    """32 rows that all choose one leaf of each codebook (one segment read
    for all), and 32 rows that choose 32 different leaves (depth 5, x the
    bits of (row + codebook) mod 32 against zero thresholds)."""
    b, c, n, depth = 32, 50, 704, 5
    _, _, lut, scale, offset = _inputs(b, c, n, depth, lut_dtype, seed=11)
    thr = np.zeros((c, 2**depth - 1), np.float32)
    if kind == "same":
        rng = np.random.default_rng(12)
        x = np.broadcast_to(rng.normal(size=(1, c, depth)), (b, c, depth))
        x = np.ascontiguousarray(x, dtype=np.float32)
    else:
        leaf = (np.arange(b)[:, None] + np.arange(c)[None]) % 32
        bits = (leaf[..., None] >> (depth - 1 - np.arange(depth))) & 1
        x = np.where(bits == 1, 1.0, -1.0).astype(np.float32)
    _lutmu_vs_plain(cuda_device, (x, thr, lut, scale, offset), lut_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("value", [-128, 127])
def test_cuda_fused_lutmu_int8_extremes(cuda_device, value):
    """Every entry at an end of the int8 range over 600 codebooks in one
    block: the offset-binary 16-bit lanes at their fullest, exact."""
    b, c, n = 5, 600, 96
    x, thr, _, _, _ = _inputs(b, c, n, 4, "int8", seed=3)
    lut = np.full((c, 16, n), value, np.int8)
    one, zero = np.asarray(np.float32(1)), np.asarray(np.float32(0))
    p = _forced_plan(b, c, 4, "int8", 1)
    got = _lutmu_vs_plain(cuda_device, (x, thr, lut, one, zero), "int8", p)
    assert bool((got == float(value * c)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, FL.MAX_CLUSTER + 1))
def test_cuda_fused_lutmu_int16_every_cluster_size(cuda_device, cluster):
    """int16 tables at every cluster size ``plan`` can pick, over 512
    codebooks (the most at which the plain version's float32 sums are
    exact for any table): bit-equal."""
    b, c, n = 9, 512, 1104
    arrays = _inputs(b, c, n, 4, "int16", seed=100 + cluster)
    _lutmu_vs_plain(cuda_device, arrays, "int16",
                    _forced_plan(b, c, 4, "int16", cluster))


@pytest.mark.cuda
@pytest.mark.parametrize("value", [-2**15, 2**15 - 1])
def test_cuda_fused_lutmu_int16_extremes(cuda_device, value):
    """Every entry at an end of the int16 range over 512 codebooks in one
    block: sums of ±2**24, exact in both versions."""
    b, c, n = 5, 512, 96
    x, thr, _, _, _ = _inputs(b, c, n, 4, "int16", seed=3)
    lut = np.full((c, 16, n), value, np.int16)
    one, zero = np.asarray(np.float32(1)), np.asarray(np.float32(0))
    p = _forced_plan(b, c, 4, "int16", 1)
    got = _lutmu_vs_plain(cuda_device, (x, thr, lut, one, zero), "int16", p)
    assert bool((got == float(value * c)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
def test_cuda_fused_lutmu_float_deterministic(cuda_device, lut_dtype):
    """Float sums in a fixed order: two calls give the same bits."""
    x, thr, lut, scale, offset = _inputs(32, 2176, 512, 4, lut_dtype, seed=4)
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype=lut_dtype)
    first = FL.fused_lutmu(xt, tt, lt, st, ot)
    second = FL.fused_lutmu(xt, tt, lt, st, ot)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_fused_lutmu_equals_unfused_int8(cuda_device):
    """The fused kernel and the unfused pair (encode, then aggregate) give
    the same bits on int8 tables."""
    x, thr, lut, scale, offset = _inputs(33, 640, 1000, 4, "int8", seed=8)
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype="int8")
    fused = FL.fused_lutmu(xt, tt, lt, st, ot)
    unfused = LA.lut_aggregate(ME.encode_onehot(xt, tt, out_dtype=torch.int8),
                               lt, st, ot)
    assert torch.equal(fused, unfused)


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
    before = LA.LAUNCHES.n
    got = LA.lut_aggregate(onehot, lt, st, ot)
    torch.cuda.synchronize()
    assert LA.LAUNCHES.n == before + 1
    want = LA.lut_aggregate_plain(onehot, lt, st, ot)
    assert_lut_sums(got, want, lut_dtype, case[1], st)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "zero"])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_cuda_lut_aggregate_any_left_operand(cuda_device, kind, lut_dtype):
    """Not only one-hots: a dense left operand (values in [-2, 2], so each
    product is exact and only the float sums' order differs; int16 tables
    then sum past 2**24, so they are held to the float tolerance) and an
    all-zero one (every output is the offset), with ragged N and enough K
    to split it over the grid."""
    b, c, n, depth = 6, 300, 1003, 4
    _, _, lut, scale, offset = _inputs(b, c, n, depth, lut_dtype, seed=5)
    rng = np.random.default_rng(6)
    lhs = (rng.integers(-2, 3, size=(b, c, 2**depth)) if kind == "dense"
           else np.zeros((b, c, 2**depth)))
    lhs_dtype = "int8" if lut_dtype == "int8" else "float32"
    (lt,) = _on(cuda_device, lut, dtype=lut_dtype)
    (ht,) = _on(cuda_device, lhs, dtype=lhs_dtype)
    st, ot = _on(cuda_device, scale, offset)
    before = LA.LAUNCHES.n
    got = LA.lut_aggregate(ht, lt, st, ot)
    torch.cuda.synchronize()
    assert LA.LAUNCHES.n == before + 1
    if kind == "zero":
        assert torch.equal(got, ot[None].expand(b, n))
    want = LA.lut_aggregate_plain(ht, lt, st, ot)
    if lut_dtype == "int8":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# MADDNESS encode: csrc/maddness_encode.cu against the plain version, bit
# for bit (the same x >= thr comparisons: ties go right, NaN goes left)
# ---------------------------------------------------------------------------

OUT_DTYPES = ["float32", "bfloat16", "int8"]


def _encode_inputs(b, c, depth, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, c, depth)).astype(np.float32),
            rng.normal(size=(c, 2**depth - 1)).astype(np.float32))


def _special_inputs(seed=0):
    """Split values that tie their thresholds (x == thr), ±inf and NaN,
    against thresholds of 0.5 in most codebooks and of ±inf and NaN in
    the rest: (B=6, C=40, I=4).  Row 0 takes NaN at every level of
    codebook 0 (leaf 0) and ties at every level of codebook 1 (leaf 15)."""
    rng = np.random.default_rng(seed)
    b, c, depth = 6, 40, 4
    vals = np.array([0.5, -np.inf, np.inf, np.nan, 0.25, 0.75], np.float32)
    x = rng.choice(vals, size=(b, c, depth)).astype(np.float32)
    x[0, 0], x[0, 1] = np.nan, 0.5
    thr = np.full((c, 2**depth - 1), 0.5, np.float32)
    odd = rng.choice(np.array([np.inf, -np.inf, np.nan, 0.5], np.float32),
                     size=(c // 4, 2**depth - 1))
    thr[-(c // 4):] = odd
    return x, thr


def _encode_vs_plain(dev, x, thr, out_dtype, launch_plan=None):
    """The kernel (one launch) bit-equal to the plain version; numpy or
    CUDA-tensor inputs."""
    xt, tt = (a if isinstance(a, torch.Tensor) else _torch(a).to(dev)
              for a in (x, thr))
    dt = _TORCH[out_dtype]
    before = ME.LAUNCHES.n
    if launch_plan is None:
        got = ME.encode_onehot(xt, tt, out_dtype=dt)
    else:
        got = ME.launch(xt, tt, dt, launch_plan)
    torch.cuda.synchronize()
    assert ME.LAUNCHES.n == before + 1
    want = ME.encode_onehot_plain(xt, tt, dt)
    assert got.dtype == want.dtype == dt and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("depth", range(1, ME.MAX_DEPTH + 1))
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_every_depth(cuda_device, depth, out_dtype):
    """Every depth the wrapper takes, at a small C: thresholds staged
    (above 48 KB of shared memory at depth 14) and, at depths 15 and 16,
    read from device memory."""
    x, thr = _encode_inputs(5, 3, depth, seed=depth)
    assert ME.plan(5, 3, depth, 4, 132).thr_smem == (depth <= 14)
    _encode_vs_plain(cuda_device, x, thr, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("thr_smem", [True, False])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_forced_tiles(cuda_device, depth, thr_smem,
                                         out_dtype):
    """Both threshold instances at depths where either fits, under tiles
    the plan would not pick (3 rows × 5 codebooks over ragged B and C)."""
    b, c = 11, 13
    x, thr = _encode_inputs(b, c, depth, seed=20 + depth)
    p = ME.sized(b, c, depth, 3, 5, thr_smem)
    _encode_vs_plain(cuda_device, x, thr, out_dtype, p)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1, 1), (1, 7), (5, 1), (33, 31), (31, 129),
                                 (64, 65)])
@pytest.mark.parametrize("depth", [1, 3, 4])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_ragged(cuda_device, b, c, depth, out_dtype):
    """Ragged B and C around the tile sizes, B=1 and C=1; at depths 1 and
    3 a 16-byte chunk spans several codebooks (int8, bfloat16) and rows'
    runs start off a 16-byte boundary."""
    x, thr = _encode_inputs(b, c, depth, seed=b * 1000 + c)
    _encode_vs_plain(cuda_device, x, thr, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_unaligned_inputs(cuda_device, offset, out_dtype):
    """Split values and thresholds that start 4, 8 or 12 bytes past a
    16-byte boundary (contiguous views into a larger buffer)."""
    b, c, depth = 9, 37, 4
    x, thr = _encode_inputs(b, c, depth, seed=offset)
    xt, tt = (torch.empty(a.size + offset, device=cuda_device)[offset:]
              .view(a.shape).copy_(_torch(a)) for a in (x, thr))
    assert xt.data_ptr() % 16 == 4 * offset
    _encode_vs_plain(cuda_device, xt, tt, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(4, 640), (4, 2176), (32, 640), (32, 2176)])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_main_path_shapes(cuda_device, b, c, out_dtype):
    """qwen3-14b's gate/up (C=640) and down (C=2176) at a decode batch and
    a prefill chunk, depth 4."""
    x, thr = _encode_inputs(b, c, 4, seed=b + c)
    _encode_vs_plain(cuda_device, x, thr, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_cuda_encode_onehot_ties_inf_nan(cuda_device, out_dtype):
    """Ties go right, NaN goes left, ±inf compare as numbers."""
    x, thr = _special_inputs()
    _encode_vs_plain(cuda_device, x, thr, out_dtype)


@pytest.mark.cuda
def test_cuda_encode_onehot_rejects_a_wrong_plan(cuda_device):
    """The kernel checks the plan's shared memory against its own layout:
    a launch that would not fit raises, and nothing is counted."""
    x, thr = _encode_inputs(4, 9, 4)
    xt, tt = _on(cuda_device, x, thr)
    p = ME.sized(4, 9, 4, 2, 3)
    before = ME.LAUNCHES.n
    with pytest.raises(RuntimeError, match="CUDA error"):
        ME.launch(xt, tt, torch.float32,
                  ME.Plan(p.c_t, p.b_t, p.thr_smem, p.smem + 16, p.grid))
    assert ME.LAUNCHES.n == before


# ROADMAP C5: int16 tables whose sums pass 2**24, where the plain
# version's float32 sums round and the fused kernel's int32 sums do not.
@pytest.mark.cuda
@pytest.mark.parametrize("c", [640, 2176])
@pytest.mark.parametrize("fill", ["max", "alternating"])
def test_cuda_int16_worst_case_sums(cuda_device, c, fill):
    """Every entry 2**15 - 1, or 2**15 - 1 and 2**15 - 3 alternating (odd
    sums past 2**24 are not float32 numbers): ``fused`` equals the exact
    integer sum rounded once, and both ``fused`` and ``unfused`` (the
    encode kernel, then the aggregate's float32 sums) stay within
    ``_int16_tol`` of the plain version."""
    b, n, depth = 32, 256, 4
    x, thr = _encode_inputs(b, c, depth, seed=c)
    g = 2**depth
    if fill == "max":
        lut = np.full((c, g, n), 2**15 - 1, np.int16)
    else:
        parity = np.add.outer(np.add.outer(np.arange(c), np.arange(g)),
                              np.arange(n)) % 2
        lut = np.where(parity == 0, 2**15 - 1, 2**15 - 3).astype(np.int16)
    one, zero = np.asarray(np.float32(1)), np.asarray(np.float32(0))
    xt, tt, st, ot = _on(cuda_device, x, thr, one, zero)
    (lt,) = _on(cuda_device, lut, dtype="int16")
    fused = FL.fused_lutmu(xt, tt, lt, st, ot)
    unfused = LA.lut_aggregate(ME.encode_onehot(xt, tt), lt, st, ot)
    plain = FL.fused_lutmu_plain(xt, tt, lt, st, ot)
    codes = encode_codes_ref(xt, tt).long()
    exact = lt[torch.arange(c, device=cuda_device)[None], codes].long().sum(1)
    torch.cuda.synchronize()
    assert int(exact.max()) > 2**24
    assert torch.equal(fused, exact.double().float())
    d_fused = (fused - plain).abs().max().item()
    d_unfused = (unfused - plain).abs().max().item()
    d_exact = (unfused.double() - exact.double()).abs().max().item()
    print(f"int16 C={c} {fill}: max |fused - plain| {d_fused}, "
          f"|unfused - plain| {d_unfused}, |unfused - exact| {d_exact}, "
          f"tolerance {_int16_tol(c, st)['atol']}")
    torch.testing.assert_close(fused, plain, **_int16_tol(c, st))
    torch.testing.assert_close(unfused, plain, **_int16_tol(c, st))


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
    # no fallback for a LUT type without a kernel instance, or an operand
    # pair without one
    with pytest.raises(ValueError, match="lut dtype"):
        FL.fused_lutmu(xt, tt, lt.to(torch.int32), st, ot)
    onehot = ME.encode_onehot(xt, tt, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported operand types"):
        LA.lut_aggregate(onehot, lt.to(torch.int16), st, ot)


# ---------------------------------------------------------------------------
# verify window: csrc/verify_window.cu against the plain version
# ---------------------------------------------------------------------------

# float32: sums of ≤ 128 products and of ≤ 4096 weighted values, taken in
# another order than the plain einsums, plus expf and the softmax sum's
# order → a few float32 ulps of outputs of size ≈ 1.
# bfloat16: the weights are rounded to bfloat16 before the value product,
# and a weight one float32 ulp apart can land on the neighbouring bfloat16
# (a relative step of 2**-8), so each output may move by ≈ 2**-8 · |v|.
# int8: logits and both products are exact integers in both versions; a
# softmax weight whose float32 value differs by an ulp can round to the
# neighbouring int8 step, moving an output by |v|·0.05/127 ≤ 0.05 per such
# weight.  At most two such weights per output, and ≥ 99 % of the outputs
# bit-equal.
VERIFY_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=0, atol=2e-2),
              "int8": dict(rtol=0, atol=2 * 0.05)}
INT8_MIN_EQUAL_SHARE = 0.99
# (page_size, max_pages, W, n_kv, g, hd): S up to 4096; the full-width
# qwen3-14b heads (n_kv 8, g 5, hd 128, W 5) at S = 128 and S = 4096; S = 201
# (page size 3); S = 2096, which its 5 splits do not divide; S = 8320, whose
# logits go to the device-memory scratch; W·g = 40 query rows, two blocks'
# worth
VERIFY_CASES = [(16, 8, 5, 8, 5, 128), (16, 256, 5, 8, 5, 128),
                (16, 64, 3, 2, 3, 64), (8, 5, 2, 1, 2, 32),
                (3, 67, 5, 8, 5, 128), (16, 520, 5, 8, 5, 128),
                (16, 12, 8, 2, 5, 64), (16, 131, 5, 8, 5, 128)]


def _verify_inputs(dev, case, kv_dtype, seed=0):
    """4 batch rows: a long history, a short one, a window that runs past
    the table's end (its last slots are trash-padded, as for n_valid < W),
    and an inactive row whose whole table is the trash page."""
    ps, mp, w, nkv, g, hd = case
    rng = np.random.default_rng(seed)
    b = 4
    n_pages = b * mp + 1
    trash = n_pages - 1
    s_len = ps * mp
    if kv_dtype == "int8":
        kp = rng.integers(-127, 128, (n_pages, ps, nkv, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, ps, nkv, hd)).astype(np.int8)
    else:
        kp = rng.normal(size=(n_pages, ps, nkv, hd)).astype(np.float32)
        vp = rng.normal(size=(n_pages, ps, nkv, hd)).astype(np.float32)
    pt = np.full((b, mp), trash, np.int32)
    pos = np.array([s_len - w, min(3, s_len - w), s_len - 2, 0], np.int32)
    for i in range(3):
        used = -(-(int(pos[i]) + w) // ps)
        pt[i, :min(used, mp)] = rng.permutation(b * mp)[:min(used, mp)]
    q = rng.normal(size=(b, w, nkv, g, hd)).astype(np.float32) * 2.0
    kt, vt = _on(dev, kp, vp, dtype=None)
    if kv_dtype == "bfloat16":
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    qt, ptt, post = _on(dev, q, pt, pos)
    return qt, kt, vt, ptt, post


@pytest.mark.cuda
@pytest.mark.parametrize("case", VERIFY_CASES)
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 37])
def test_cuda_verify_window_matches_plain(cuda_device, case, kv_dtype, window):
    qt, kt, vt, ptt, post = _verify_inputs(cuda_device, case, kv_dtype)
    before, plain_before = FV.LAUNCHES.n, FV.PLAIN_ON_CUDA.n
    got = FV.verify_window_attend_cuda(qt, kt, vt, ptt, post, window)
    torch.cuda.synchronize()
    assert FV.LAUNCHES.n == before + 1 and FV.PLAIN_ON_CUDA.n == plain_before
    want = FV.verify_window_attend_plain(qt, kt, vt, ptt, post, window)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **VERIFY_TOL[kv_dtype])
    if kv_dtype == "int8":
        share = (got == want).float().mean().item()
        assert share >= INT8_MIN_EQUAL_SHARE, share


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_cuda_paged_verify_window_kernel_matches_plain(cuda_device, kv_dtype):
    """One layer's verify-window attention with ``n_valid < W`` rows (their
    last slots write to the trash page): the kernel route against the
    plain route from the same pages, pages compared after the write."""
    cfg = ModelConfig(name="tiny", family="dense", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                      head_dim=32, qk_norm=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = TA.init_attn_params(cfg, gen)
    b, w, ps, mp = 3, 4, 8, 4
    n_pages = b * mp + 1
    shape = (n_pages, ps, 2, 32)
    if kv_dtype == "int8":
        kp = torch.randint(-127, 128, shape, generator=gen, device=cuda_device,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=cuda_device,
                           dtype=torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=cuda_device)
        vp = torch.randn(shape, generator=gen, device=cuda_device)
    pt = torch.arange(b * mp, device=cuda_device, dtype=torch.int32).reshape(b, mp)
    pos = torch.tensor([9, 0, 27], device=cuda_device, dtype=torch.int32)
    n_valid = torch.tensor([4, 2, 1], device=cuda_device, dtype=torch.int32)
    x = torch.randn((b, w, 64), generator=gen, device=cuda_device)
    outs, pages = {}, {}
    for impl in ("cuda", "plain"):
        k2, v2 = kp.clone(), vp.clone()
        outs[impl] = TA.paged_verify_window(params, x, cfg, k2, v2, pt, pos,
                                            n_valid, 2**30, attend_impl=impl)
        pages[impl] = (k2[:-1], v2[:-1])
    torch.cuda.synchronize()
    assert torch.equal(pages["cuda"][0], pages["plain"][0])
    assert torch.equal(pages["cuda"][1], pages["plain"][1])
    for i in range(b):
        nv = int(n_valid[i])
        got, want = outs["cuda"][i, :nv], outs["plain"][i, :nv]
        if kv_dtype == "int8":  # ≤ 2 int8 weight steps, through wo (|w| ≲ 1)
            torch.testing.assert_close(got, want, rtol=0, atol=2 * 0.05 * 8)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_verify_window_rejects_bad_inputs(cuda_device):
    qt, kt, vt, ptt, post = _verify_inputs(cuda_device, VERIFY_CASES[3],
                                           "float32")
    with pytest.raises(ValueError):
        FV.verify_window_attend_cuda(qt.to(torch.bfloat16), kt, vt, ptt, post,
                                     None)
    with pytest.raises(ValueError):
        FV.verify_window_attend_cuda(qt, kt, vt, ptt, post.long(), None)
    with pytest.raises(ValueError):
        FV.verify_window_attend_cuda(qt, kt, vt.to(torch.bfloat16), ptt, post,
                                     None)
    with pytest.raises(ValueError):
        FV.verify_window_attend_cuda(qt, kt, vt, ptt.cpu(), post, None)
    assert FV.resolve_impl("auto", cuda_device) == "cuda"


# ---------------------------------------------------------------------------
# the paged decode read: the verify kernel at W = 1 (decode_attend_paged_cuda)
# ---------------------------------------------------------------------------

# batch-decode's read: 32 rows, n_kv 8, g 5, hd 128, pages of 16
DECODE_B, DECODE_NKV, DECODE_G, DECODE_HD, DECODE_PS = 32, 8, 5, 128, 16


def _decode_inputs(dev, s_len, kv_dtype, seed=0, w=1):
    """Rows 0..29 at positions spread over [64, S - w], their tables every
    page of the pool in random order; rows 30 and 31 idle, as the engine
    leaves a row without a request: the whole table on the trash page,
    position 0.  q holds bf16 values (the serve path's)."""
    rng = np.random.default_rng(seed)
    b, nkv, g, hd, ps = DECODE_B, DECODE_NKV, DECODE_G, DECODE_HD, DECODE_PS
    mp = s_len // ps
    n_pages = b * mp + 1
    shape = (n_pages, ps, nkv, hd)
    if kv_dtype == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
    pt = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    pt[30:] = n_pages - 1
    pos = np.linspace(64, s_len - w, b).round().astype(np.int32)
    pos[30:] = 0
    q = rng.normal(size=(b, w, nkv, g, hd)).astype(np.float32) * 2.0
    kt, vt = _on(dev, kp, vp)
    if kv_dtype == "bfloat16":
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    (qt,) = _on(dev, q)
    qt = qt.to(torch.bfloat16).float()
    ptt, post = _on(dev, pt, pos)
    return qt, kt, vt, ptt, post


def _plain_decode_read_cpu(qt, kt, vt, ptt, post, window):
    """The plain read, computed on the CPU."""
    k_view, v_view = FV.paged_view(kt.cpu(), vt.cpu(), ptt.cpu())
    return FV.decode_attend(qt.cpu(), k_view, v_view, post.cpu().long(),
                            window)


def _assert_decode_read(got, want, kv_dtype):
    """int8: bit for bit (exact sums; the plain read on the card, unlike
    the CPU's, moves a few int8 weights of long rows by one step: 0.6 % of
    the outputs at S = 1,024); float within VERIFY_TOL."""
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if kv_dtype == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **VERIFY_TOL[kv_dtype])
    share = (got == want).float().mean().item()
    print(f"{kv_dtype}: bit-equal share {share:.6f}")


@pytest.mark.cuda
@pytest.mark.parametrize("s_len", [1024, 1536])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_decode_read_matches_plain(cuda_device, s_len, kv_dtype):
    """B = 32, W = 1 at batch-decode's (S = 1,024) and chat-open's
    (S = 1,536) tables, with two idle rows, through the split count the
    decode path takes, against the plain read."""
    qt, kt, vt, ptt, post = _decode_inputs(cuda_device, s_len, kv_dtype)
    before, plain_before = FV.DECODE_LAUNCHES.n, FV.PLAIN_DECODE_ON_CUDA.n
    verify_before = FV.LAUNCHES.n
    got = FV.decode_attend_paged_cuda(qt, kt, vt, ptt, post, None)
    torch.cuda.synchronize()
    assert FV.DECODE_LAUNCHES.n == before + 1
    assert FV.PLAIN_DECODE_ON_CUDA.n == plain_before
    assert FV.LAUNCHES.n == verify_before
    _assert_decode_read(got, _plain_decode_read_cpu(qt, kt, vt, ptt, post,
                                                    None), kv_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [1, 37, 500])
def test_cuda_decode_read_sliding_window(cuda_device, kv_dtype, window):
    """gemma3's local layers: each row reads the ``window`` positions up
    to its own."""
    qt, kt, vt, ptt, post = _decode_inputs(cuda_device, 1024, kv_dtype, seed=1)
    got = FV.decode_attend_paged_cuda(qt, kt, vt, ptt, post, window)
    _assert_decode_read(got, _plain_decode_read_cpu(qt, kt, vt, ptt, post,
                                                    window), kv_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s_len", [1024, 1536])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_cuda_decode_read_is_the_plain_read_on_the_card(cuda_device, s_len,
                                                        kv_dtype):
    """At the benchmark's decode shapes the float read is bitwise the plain
    read computed on the card (its library calls: each logit one FMA chain
    over the head dim, each output the sum of four partials of 256-position
    chunks), as the served model's logits must be bitwise a plain
    reference's.  A cuBLAS that sums these shapes otherwise fails here."""
    qt, kt, vt, ptt, post = _decode_inputs(cuda_device, s_len, kv_dtype,
                                           seed=2)
    got = FV.decode_attend_paged_cuda(qt, kt, vt, ptt, post, None)
    k_view, v_view = FV.paged_view(kt, vt, ptt)
    want = FV.decode_attend(qt, k_view, v_view, post.long(), None)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_read_rejects_a_window_of_several_positions(cuda_device):
    qt, kt, vt, ptt, post = _decode_inputs(cuda_device, 1024, "float32",
                                           w=2)
    with pytest.raises(ValueError, match="qg must be"):
        FV.decode_attend_paged_cuda(qt, kt, vt, ptt, post, None)


# ---------------------------------------------------------------------------
# autotuned launch plans (kernels/autotune.py) and the fit on the card
# ---------------------------------------------------------------------------

# (B, C, N): qwen3-14b's gate/up at decode, down at a prefill chunk, a
# ragged one and the SFC chain's layer 0
AUTOTUNE_CASES = [(4, 640, 8704), (32, 2176, 5120), (5, 7, 130), (256, 98, 128)]


@pytest.fixture
def empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    return tmp_path / "tune.json"


@pytest.mark.cuda
@pytest.mark.parametrize("case", AUTOTUNE_CASES)
@pytest.mark.parametrize("lut_dtype", ["int8", "int16", "float32"])
def test_cuda_measured_plans_equal_the_heuristic(cuda_device, case, lut_dtype,
                                                 empty_autotune_cache):
    """Every measured cluster size gives the heuristic's output: bit-equal
    on integer tables (exact int32 sums in any split), float32 within
    rtol 1e-5 / atol 1e-4.  On the card the heuristic is the wrapper's own
    plan, and a cache holding the measured plan reaches the kernel through
    the dispatch."""
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import dispatch as TD

    b, c, n = case
    depth = 4
    dt = _TORCH[lut_dtype]
    x, thr, lut, scale, offset = _inputs(b, c, n, depth, lut_dtype)
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype=lut_dtype)
    heur = AT.heuristic_tiles(b, c, n, depth, dt, device=cuda_device)
    assert (AT.fused_plan(heur, b, c, depth, dt)
            == FL._plan_for(b, c, n, depth, dt, 0))
    want = FL.fused_lutmu(xt, tt, lt, st, ot)
    best, timings = AT.measure_fused_tiles(b, c, n, depth, dt, iters=2,
                                           device=cuda_device)
    assert set(timings) == set(AT.candidate_tiles(b, c, n, depth, dt,
                                                  cuda_device))
    assert best in timings and heur in timings
    for t in timings:
        got = FL.fused_lutmu(xt, tt, lt, st, ot,
                             launch_plan=AT.fused_plan(t, b, c, depth, dt))
        torch.cuda.synchronize()
        if lut_dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(got, want), t
    cache = AT.AutotuneCache(empty_autotune_cache)
    cache.put(AT.shape_key("cuda", "fused", b, c, n, depth, dt), best)
    params = TD.params_from_arrays(
        torch.zeros((c, depth), dtype=torch.int32, device=cuda_device), tt, lt,
        st, ot)
    before = FL.LAUNCHES.n
    got = TD.lutmu_matmul(xt, params, backend="fused", input_kind="split",
                          cache=cache)
    torch.cuda.synchronize()
    assert FL.LAUNCHES.n == before + 1
    if lut_dtype != "float32":
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_a_plan_failing_the_budget_raises(cuda_device):
    import dataclasses

    x, thr, lut, scale, offset = _inputs(4, 64, 256, 4, "int8")
    xt, tt, st, ot = _on(cuda_device, x, thr, scale, offset)
    (lt,) = _on(cuda_device, lut, dtype="int8")
    p = FL.sized(4, 64, 4, 1, 4)
    with pytest.raises(ValueError, match="shared memory"):
        FL.fused_lutmu(xt, tt, lt, st, ot, launch_plan=dataclasses.replace(
            p, smem=FL.MAX_SMEM + 16))
    with pytest.raises(ValueError, match="splits"):
        qt, kt, vt, ptt, post = _verify_inputs(cuda_device, VERIFY_CASES[0],
                                               "float32")
        FV.verify_window_attend_cuda(qt, kt, vt, ptt, post, None, splits=9)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [VERIFY_CASES[0], VERIFY_CASES[1]])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_measured_verify_splits_within_tol(cuda_device, case, kv_dtype,
                                                empty_autotune_cache):
    """Every measured split count (the full-width heads at S = 128 and
    4096) against the plain version within ``VERIFY_TOL``; the heuristic
    is the wrapper's own count."""
    from repro_torch.kernels import autotune as AT

    ps, mp, w, nkv, g, hd = case
    s_len, b = ps * mp, 4
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    qt, kt, vt, ptt, post = _verify_inputs(cuda_device, case, kv_dtype)
    heur = AT.verify_heuristic_tiles(s_len, w, nkv, g, hd, dt, b=b,
                                     page_size=ps, device=cuda_device)
    assert heur == AT.get_verify_tiles(s_len, w, nkv, g, hd, dt, b=b,
                                       page_size=ps, device=cuda_device)
    best, timings = AT.measure_verify_tiles(s_len, w, nkv, g, hd, dt, b=b,
                                            page_size=ps, iters=2,
                                            device=cuda_device)
    assert best in timings and heur in timings
    want = FV.verify_window_attend_plain(qt, kt, vt, ptt, post, None)
    for t in timings:
        got = FV.verify_window_attend_cuda(qt, kt, vt, ptt, post, None,
                                           splits=t.splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **VERIFY_TOL[kv_dtype])


@pytest.mark.cuda
def test_cuda_fit_equals_the_cpu_fit(cuda_device):
    """``chip_smoke.fit_card_vs_cpu``: the reduced-width fit on the card
    against the same code on the CPU (trees equal but for named
    near-ties, prototypes within tolerance, int8 codes within one step)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.fit_card_vs_cpu(torch)
    assert set(out["excused"]) == {"up", "down"}


# ---------------------------------------------------------------------------
# the case studies' shapes: tall row counts, few codebooks, float32 tables
# ---------------------------------------------------------------------------

# (B, C, N) of a 256-image ResNet-9 forward at depth 4: a Kn2col tap of
# conv1 (32×32 maps, 64 channels in d_sub 8), of res2a (4×4 maps, 512
# channels), and the Im2col res1a (16×16 maps, 128 codebooks of K·K = 9
# dims); B cut where the plain version's one-hot would not fit the test's
# budget
CNN_CASES = {"kn2col_conv1": (65536, 8, 128), "kn2col_res2a": (4096, 64, 512),
             "im2col_res1a": (65536, 128, 128)}


def _device_inputs(dev, b, c, n, depth, lut_dtype, seed=0):
    """Inputs made on the card (tall B: no host round trip)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = 2**depth
    x = torch.randn((b, c, depth), generator=gen, device=dev)
    thr = torch.randn((c, g - 1), generator=gen, device=dev)
    if lut_dtype == "int8":
        lut = torch.randint(-128, 128, (c, g, n), generator=gen, device=dev,
                            dtype=torch.int8)
    else:
        lut = torch.randn((c, g, n), generator=gen, device=dev)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.015 + 0.005
    offset = torch.randn((n,), generator=gen, device=dev)
    return x, thr, lut, scale, offset


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CNN_CASES))
@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
def test_cuda_cnn_shapes_match_plain(cuda_device, shape, lut_dtype):
    b, c, n = CNN_CASES[shape]
    x, thr, lut, scale, offset = _device_inputs(cuda_device, b, c, n, 4,
                                                lut_dtype)
    got = FL.fused_lutmu(x, thr, lut, scale, offset)
    assert_lut_sums(got, FL.fused_lutmu_plain(x, thr, lut, scale, offset),
                    lut_dtype, c, scale)
    out = torch.int8 if lut_dtype == "int8" else torch.float32
    onehot = ME.encode_onehot(x, thr, out_dtype=out)
    torch.testing.assert_close(onehot, ME.encode_onehot_plain(x, thr, out),
                               rtol=0, atol=0)
    got = LA.lut_aggregate(onehot, lut, scale, offset)
    assert_lut_sums(got, LA.lut_aggregate_plain(onehot, lut, scale, offset),
                    lut_dtype, c, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b", [("lut_aggregate", 262_144),
                                      ("lut_aggregate", 262_141),
                                      ("fused_lutmu", 2_097_152),
                                      ("fused_lutmu", 2_097_121)])
@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
def test_cuda_rows_past_the_grid_y_limit(cuda_device, kernel, b, lut_dtype):
    """Row counts whose row blocks (4 rows) or row groups (32 rows) pass
    CUDA's 65,535 grid.y limit: every row, the last included, is held to
    the plain version.  Rows share grid.x with the N-tiles, so one wrapper
    call is one launch of the kernel, counted once."""
    c, n = 8, 128
    x, thr, lut, scale, offset = _device_inputs(cuda_device, b, c, n, 4,
                                                lut_dtype, seed=3)
    if kernel == "fused_lutmu":
        before = FL.LAUNCHES.n
        got = FL.fused_lutmu(x, thr, lut, scale, offset)
        assert FL.LAUNCHES.n == before + 1
        want = FL.fused_lutmu_plain(x, thr, lut, scale, offset)
    else:
        onehot = ME.encode_onehot_plain(
            x, thr, torch.int8 if lut_dtype == "int8" else torch.float32)
        before = LA.LAUNCHES.n
        got = LA.lut_aggregate(onehot, lut, scale, offset)
        assert LA.LAUNCHES.n == before + 1
        want = LA.lut_aggregate_plain(onehot, lut, scale, offset)
    torch.cuda.synchronize()
    assert got.shape == (b, n)
    assert_lut_sums(got, want, lut_dtype, c, scale)
    assert_lut_sums(got[-5:], want[-5:], lut_dtype, c, scale)


@pytest.mark.cuda
def test_cuda_ste_function_matches_cpu(cuda_device):
    """The straight-through LUT-MU's forward (the encode and aggregate
    kernels) and both gradients on the card against the same calls on the
    CPU (the plain versions): float32 sums in another order."""
    from repro_torch.core import ste as STE

    b, d, n, c, depth = 300, 64, 48, 8, 4
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((b, d), generator=gen)
    lut = torch.randn((c, 2**depth, n), generator=gen)
    w = torch.randn((d, n), generator=gen) / 8
    split = torch.randint(0, d // c, (c, depth), generator=gen,
                          dtype=torch.int32)
    thr = torch.randn((c, 2**depth - 1), generator=gen) * 0.5
    g_out = torch.randn((b, n), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        xx = x.to(dev, copy=True).requires_grad_(True)
        ll = lut.to(dev, copy=True).requires_grad_(True)
        enc0, agg0 = ME.LAUNCHES.n, LA.LAUNCHES.n
        y = STE.ste_lut_matmul(xx, ll, w.to(dev), split.to(dev), thr.to(dev))
        (y * g_out.to(dev)).sum().backward()
        if dev == "cuda":
            assert ME.LAUNCHES.n == enc0 + 1 and LA.LAUNCHES.n == agg0 + 1
        outs[dev] = [t.detach().cpu() for t in (y, ll.grad, xx.grad)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
