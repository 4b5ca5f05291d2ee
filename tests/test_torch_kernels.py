"""The port's LUT-MU kernels' plain versions against the JAX Pallas
kernels (the CUDA kernels against the plain versions are in
``test_torch_cuda_kernels.py``).

On the CPU every port wrapper runs its plain version; the same numpy inputs
go through the JAX Pallas kernel in interpret mode.  Tree codes, one-hots
and int8 and int16 LUT sums (unit epilogue; integer sums, exact in float32
at these few codebooks) must match bit for bit; float LUT sums match
within rtol 1e-5 (float32 sums of at most a few tens of terms, taken in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as JD
from repro.kernels import ref as jref
from repro.kernels.fused_lutmu import fused_lutmu_pallas
from repro.kernels.lut_aggregate import lut_aggregate_pallas
from repro.kernels.maddness_encode import encode_onehot_pallas
from repro_torch.kernels import dispatch as TD
from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import lut_aggregate as LA
from repro_torch.kernels import maddness_encode as ME
from repro_torch.kernels import ref as tref
from test_torch_cuda_kernels import (CASES, LUT_DTYPES, OUT_DTYPES, _TORCH,
                                     _inputs, _special_inputs, _torch)

_JNP = {"int8": jnp.int8, "int16": jnp.int16, "float32": jnp.float32,
        "bfloat16": jnp.bfloat16}


def _jax(a, dtype=None):
    out = jnp.asarray(a)
    return out.astype(_JNP[dtype]) if dtype else out


@pytest.mark.parametrize("case", CASES)
def test_encode_codes_match_jax_oracle(case):
    b, c, _, depth = case
    x, thr, *_ = _inputs(*case, "float32")
    want = np.asarray(jref.encode_codes_ref(_jax(x), _jax(thr)))
    got = tref.encode_codes_ref(_torch(x), _torch(thr)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("out_dtype", ["float32", "int8"])
def test_encode_onehot_plain_matches_pallas(case, out_dtype):
    _, _, _, depth = case
    x, thr, *_ = _inputs(*case, "float32")
    want = encode_onehot_pallas(_jax(x), _jax(thr), depth=depth,
                                out_dtype=_JNP[out_dtype], interpret=True)
    got = ME.encode_onehot(_torch(x), _torch(thr),
                           out_dtype=_TORCH[out_dtype])
    assert got.dtype == _TORCH[out_dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def _check(got: torch.Tensor, want, lut_dtype: str, unit: bool):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if lut_dtype in ("int8", "int16") and unit:
        np.testing.assert_array_equal(got, want)  # the integer sums, exactly
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_fused_lutmu_plain_matches_pallas(case, lut_dtype):
    depth = case[3]
    for unit in (True, False):
        x, thr, lut, scale, offset = _inputs(*case, lut_dtype,
                                             unit_epilogue=unit)
        want = fused_lutmu_pallas(_jax(x), _jax(thr), _jax(lut, lut_dtype),
                                  _jax(scale), _jax(offset), depth=depth,
                                  interpret=True)
        got = FL.fused_lutmu(_torch(x), _torch(thr), _torch(lut, lut_dtype),
                             _torch(scale), _torch(offset))
        _check(got, want, lut_dtype, unit)


@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_lut_aggregate_plain_matches_pallas(case, lut_dtype):
    x, thr, lut, scale, offset = _inputs(*case, lut_dtype, unit_epilogue=True)
    onehot = np.asarray(jref.encode_onehot_ref(_jax(x), _jax(thr)))
    want = lut_aggregate_pallas(_jax(onehot), _jax(lut, lut_dtype),
                                _jax(scale), _jax(offset), interpret=True)
    got = LA.lut_aggregate(_torch(onehot), _torch(lut, lut_dtype),
                           _torch(scale), _torch(offset))
    _check(got, want, lut_dtype, unit=True)


def test_lut_aggregate_plain_takes_any_left_operand():
    """Not only one-hots: a dense integer left operand sums exactly."""
    rng = np.random.default_rng(3)
    lhs = rng.integers(-3, 4, size=(6, 4, 8)).astype(np.int8)
    lut = rng.integers(-128, 128, size=(4, 8, 40)).astype(np.int8)
    one, zero = np.asarray(np.float32(1)), np.asarray(np.float32(0))
    want = lut_aggregate_pallas(_jax(lhs), _jax(lut), _jax(one), _jax(zero),
                                interpret=True)
    got = LA.lut_aggregate(_torch(lhs), _torch(lut), _torch(one),
                           _torch(zero))
    exact = lhs.reshape(6, -1).astype(np.int64) @ lut.reshape(-1, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("b,c,g,n", [(4, 640, 16, 8704), (4, 2176, 16, 5120),
                                     (32, 640, 16, 8704), (32, 2176, 16, 5120),
                                     (1, 3, 4, 33), (9, 1, 2, 7),
                                     (2, 70000, 16, 64)])
@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_lut_aggregate_k_splits_cover_k(b, c, g, n, lut_dtype):
    """The aggregate's K-split plan: split ``z`` sums entries
    ``[z·per, (z+1)·per)``; the splits cover K exactly once, fit the grid's
    z limit, and a block walks at least 256 entries unless K is smaller."""
    k = c * g
    for sms in (1, 132):
        splits, per = LA.k_splits(b, k, n, _TORCH[lut_dtype], sms)
        assert 1 <= splits <= 65535 and per >= 1
        assert (splits - 1) * per < k <= splits * per
        assert per >= min(256, k)
    assert LA.k_splits(4, 2176 * 16, 5120, torch.int8, 132)[0] > 1


# the eight (B, C, N, LUT) cases of chip_smoke.py's kernel phase, depth 4
# (the last two: int16 tables at gate/up and at the SFC chain's layer 0)
CHIP_SMOKE_CASES = [(4, 640, 8704, "int8"), (4, 2176, 5120, "int8"),
                    (32, 640, 8704, "int8"), (32, 2176, 5120, "int8"),
                    (4, 640, 8704, "float32"), (32, 2176, 5120, "bfloat16"),
                    (4, 640, 8704, "int16"), (256, 98, 128, "int16")]


def test_fused_lutmu_plan_cases_are_chip_smokes():
    """The planner tests below include every shape chip_smoke.py runs."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.DEPTH == 4
    assert sorted((b, *cs.SHAPES[p], lut) for p, b, lut in cs.CASES) == \
        sorted(CHIP_SMOKE_CASES)


@pytest.mark.parametrize("b,c,n,depth,lut_dtype",
                         [(*case[:3], 4, case[3]) for case in CHIP_SMOKE_CASES]
                         + [(1, 3, 33, 4, "int8"), (70, 2176, 5120, 4, "int8"),
                            (33, 20, 208, 8, "bfloat16"), (9, 1, 7, 1, "float32"),
                            (2, 70000, 64, 4, "int8"), (32, 600, 1104, 8, "int8")])
def test_fused_lutmu_plan_covers_codebooks(b, c, n, depth, lut_dtype):
    """The fused kernel's launch plan: block k of a cluster sums codebooks
    [k·per, (k+1)·per), which cover C exactly once with no empty block;
    the cluster is at most the kernel's 16 blocks; the shared memory the
    kernel computes fits a block; a ring stage lies inside the slice and
    gives each consumer thread at most one (codebook, row) to encode."""
    itemsize = torch.empty((), dtype=_TORCH[lut_dtype]).element_size()
    for sms, resident in ((1, None), (132, None), (132, lambda p: 3)):
        p = FL.plan(b, c, n, depth, itemsize, sms, resident)
        assert 1 <= p.cluster <= FL.MAX_CLUSTER == 16
        assert p.tile_bytes == FL.tile_bytes(itemsize)
        slices = [range(k * p.per, min(c, (k + 1) * p.per))
                  for k in range(p.cluster)]
        assert [cb for s in slices for cb in s] == list(range(c))
        assert all(len(s) > 0 for s in slices)
        assert 1 <= p.k_stage <= p.per
        assert p.k_stage * (1 << (min(b, 32) - 1).bit_length()) <= 256
        assert p.smem == FL.smem_bytes(b, depth, itemsize, p.per, p.k_stage,
                                       p.thr_smem)
        assert p.smem <= FL.MAX_SMEM


def test_fused_lutmu_plan_fills_one_wave():
    """The cluster sizes the planner picks for chip_smoke.py's shapes on a
    132-SM card (the fastest of every plan in a sweep there): about 200
    blocks, fewer when the card runs fewer clusters at once."""
    picks = {(b, c, n, lut): FL.plan(b, c, n, 4, _TORCH[lut].itemsize, 132).cluster
             for b, c, n, lut in CHIP_SMOKE_CASES}
    assert picks == {(4, 640, 8704, "int8"): 6, (4, 2176, 5120, "int8"): 10,
                     (32, 640, 8704, "int8"): 6, (32, 2176, 5120, "int8"): 10,
                     (4, 640, 8704, "float32"): 3,
                     (32, 2176, 5120, "bfloat16"): 10,
                     # 2-byte entries take bfloat16's 512-byte tiles: 34
                     # N-tiles → clusters of 6; the chain's 8 row groups
                     # × 1 N-tile → 14 of 7 codebooks each
                     (4, 640, 8704, "int16"): 6,
                     (256, 98, 128, "int16"): 14}
    # a card that runs no cluster above 8 blocks, and 20 of 8 at once
    assert FL.plan(4, 2176, 5120, 4, 1, 132,
                   lambda p: 20 if p.cluster <= 8 else 0).cluster == 8
    # one that runs too few clusters of any size for a wave: one block each
    assert FL.plan(4, 2176, 5120, 4, 1, 132, lambda p: 16).cluster == 1


# ---------------------------------------------------------------------------
# MADDNESS encode: the tile plan, edge inputs, the unfused path's one-hot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", range(1, ME.MAX_DEPTH + 1))
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_encode_plan_fits_and_covers(depth, out_dtype):
    """At every depth and output type: the plan's shared memory is the
    kernel's layout and stays within ``SMEM_BUDGET``, its staged
    thresholds within ``THR_BUDGET``; a tile holds at most ``PAIRS``
    (row, codebook) pairs and ``ROWS`` rows; the grid's tiles cover every
    (row, codebook) exactly once at ragged B and C; depths whose one
    codebook's thresholds do not fit (15, 16) read them from device
    memory."""
    itemsize = _TORCH[out_dtype].itemsize
    assert ME.SMEM_BUDGET <= FL.MAX_SMEM
    for b, c in [(1, 1), (4, 640), (32, 2176), (33, 7), (7, 130), (70, 97)]:
        for sms in (1, 132):
            p = ME.plan(b, c, depth, itemsize, sms)
            assert p.thr_smem == (depth <= 14)
            assert p.smem == ME.smem_bytes(p.b_t, p.c_t, depth, p.thr_smem)
            assert p.smem <= ME.SMEM_BUDGET
            staged = p.smem - ME.smem_bytes(p.b_t, p.c_t, depth, False)
            assert staged <= ME.THR_BUDGET
            assert 1 <= p.b_t <= min(b, ME.ROWS) and 1 <= p.c_t <= c
            assert p.b_t * p.c_t <= ME.PAIRS
            tiles_c = -(-c // p.c_t)
            assert p.grid == tiles_c * -(-b // p.b_t)
            seen = np.zeros((b, c), np.int64)
            for blk in range(p.grid):  # csrc/maddness_encode.cu's tile order
                tb, tc = divmod(blk, tiles_c)
                seen[tb * p.b_t:(tb + 1) * p.b_t,
                     tc * p.c_t:(tc + 1) * p.c_t] += 1
            assert (seen == 1).all()


def test_encode_plan_main_path_shapes():
    """The tiles the plan picks at chip_smoke.py's encode shapes on a
    132-SM card: a prefill chunk of the down projection fills the card
    (272 blocks of 32 rows × 8 codebooks), a decode call stays at 20–68
    blocks of 128 pairs, whatever the output type."""
    for itemsize in (4, 2, 1):
        picks = {(b, c): (p.b_t, p.c_t, p.grid) for b, c in
                 [(4, 640), (4, 2176), (32, 640), (32, 2176), (256, 98)]
                 for p in [ME.plan(b, c, 4, itemsize, 132)]}
        assert picks == {(4, 640): (4, 32, 20), (4, 2176): (4, 32, 68),
                         (32, 640): (32, 4, 160), (32, 2176): (32, 8, 272),
                         (256, 98): (32, 4, 200)}


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_encode_onehot_plain_ties_inf_nan_match_pallas(out_dtype):
    """Ties (x == thr) go right, NaN goes left, ±inf compare as numbers:
    the plain encode equals the Pallas kernel bit for bit."""
    x, thr = _special_inputs()
    want = encode_onehot_pallas(_jax(x), _jax(thr), depth=4,
                                out_dtype=_JNP[out_dtype], interpret=True)
    got = ME.encode_onehot(_torch(x), _torch(thr),
                           out_dtype=_TORCH[out_dtype])
    assert got.dtype == _TORCH[out_dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    codes = tref.encode_codes_ref(_torch(x), _torch(thr)).numpy()
    assert codes[0, 0] == 0 and codes[0, 1] == 15  # all NaN; all ties


@pytest.mark.parametrize("lut_dtype", LUT_DTYPES)
def test_unfused_asks_for_an_int8_onehot_only_for_int8_tables(monkeypatch,
                                                               lut_dtype):
    """``backend="unfused"`` asks the encode for an int8 one-hot when the
    tables are int8 (the aggregate takes it as it is) and for float32
    otherwise (the aggregate's left operand for float and int16 tables)."""
    asked = []
    real = TD.encode_onehot_cuda

    def spy(xs, thresholds, *, out_dtype=torch.float32, launch_plan=None):
        asked.append(out_dtype)
        return real(xs, thresholds, out_dtype=out_dtype,
                    launch_plan=launch_plan)

    monkeypatch.setattr(TD, "encode_onehot_cuda", spy)
    x, thr, lut, scale, offset = _inputs(5, 7, 40, 3, lut_dtype)
    split = np.zeros((7, 3), np.int32)
    params = TD.params_from_arrays(_torch(split), _torch(thr),
                                   _torch(lut, lut_dtype), _torch(scale),
                                   _torch(offset))
    out = TD.lutmu_matmul(_torch(x), params, backend="unfused",
                          input_kind="split")
    assert out.shape == (5, 40)
    assert asked == [torch.int8 if lut_dtype == "int8" else torch.float32]


@pytest.mark.parametrize("input_kind", ["split", "full"])
@pytest.mark.parametrize("unit", [True, False])
def test_unfused_int8_matches_jax_unfused(input_kind, unit):
    """On int8 tables the port's ``backend="unfused"`` (an int8 one-hot)
    equals the JAX package's (a float32 one-hot through the Pallas
    kernels, interpret mode) bit for bit in the integer sums (unit
    epilogue).  With a real epilogue the Pallas aggregate contracts
    acc·scale + offset into one FMA in interpret mode, while the port
    rounds twice, as JAX's ``ref`` backend does: the port equals that
    backend bit for bit, and the Pallas path within the product's
    rounding plus the sum's (half an ulp of values below 32 each: |acc| ≤
    9 · 128, scale ≤ 0.02, |offset| < 8)."""
    rng = np.random.default_rng(17)
    b, c, depth, n, d_sub = 6, 9, 4, 72, 4
    split = rng.integers(0, d_sub, size=(c, depth)).astype(np.int32)
    thr = rng.normal(size=(c, 2**depth - 1)).astype(np.float32) * 0.5
    lut = rng.integers(-128, 128, size=(c, 2**depth, n)).astype(np.int8)
    if unit:
        scale, offset = np.asarray(np.float32(1)), np.asarray(np.float32(0))
    else:
        scale = rng.uniform(0.005, 0.02, size=(n,)).astype(np.float32)
        offset = rng.normal(size=(n,)).astype(np.float32)
    arrays = (split, thr, lut, scale, offset)
    jp = JD.params_from_arrays(*map(jnp.asarray, arrays))
    tp = TD.params_from_arrays(*map(torch.from_numpy, arrays))
    shape = (b, c, depth) if input_kind == "split" else (b, c * d_sub)
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(JD.lutmu_matmul(jnp.asarray(x), jp, backend="unfused",
                                      input_kind=input_kind))
    got = TD.lutmu_matmul(torch.from_numpy(x), tp, backend="unfused",
                          input_kind=input_kind).numpy()
    if unit:
        np.testing.assert_array_equal(got, want)
        return
    two_roundings = np.asarray(JD.lutmu_matmul(
        jnp.asarray(x), jp, backend="ref", input_kind=input_kind))
    np.testing.assert_array_equal(got, two_roundings)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0**-20)
