"""The port's launch-plan autotuner (``kernels/autotune.py``) on the CPU.

The JAX autotune tests' cases (``tests/test_dispatch.py``,
``tests/test_fused_verify.py``) on the port: the JSON cache's round trip,
its corruption and concurrent-writer merge, cache-then-heuristic, measured
plans persisting (with a fake timer: measuring needs the card) and not
re-measured.  The heuristic is exactly each wrapper's own pick on every
``chip_smoke.CASES`` shape and the serve path's verify rows, so an empty
cache changes no launch; recorded plans reach an ``AMMChain`` only from a
port artifact.  Measured plans against the heuristic on the card are in
``tests/test_torch_cuda_kernels.py``.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compiler as TC
from repro_torch.core import maddness as M
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import fused_verify as FV
from repro_torch.kernels import lut_aggregate as LA
from repro_torch.kernels import maddness_encode as ME
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_autotune_cache_roundtrip(tmp_path):
    path = tmp_path / "cache.json"
    cache = AT.AutotuneCache(path)
    key = AT.shape_key("cuda", "fused", 256, 16, 256, 4, torch.float32)
    assert key == "cuda|fused|b256|c16|n256|i4|float32"
    assert cache.get(key) is None
    cache.put(key, AT.TileConfig(4, 32, 8, 256), us=42.0)
    cache.save()
    reloaded = AT.AutotuneCache(path)
    assert reloaded.get(key) == AT.TileConfig(4, 32, 8, 256)
    assert len(reloaded) == 1
    entry = json.loads(path.read_text())[key]
    assert entry["source"] == "measured" and entry["us"] == 42.0


def test_autotune_cache_tolerates_corruption(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        cache = AT.AutotuneCache(path)
    assert len(cache) == 0
    key = AT.shape_key("cuda", "fused", 8, 2, 16, 2, torch.float32)
    cache.put(key, AT.TileConfig(2, 8, 2, 64), us=1.0)
    cache.save()
    assert AT.AutotuneCache(path).get(key) == AT.TileConfig(2, 8, 2, 64)
    # an entry of another shape of plan is no hit, not a crash
    path.write_text(json.dumps({key: {"block_b": 8, "block_n": 128,
                                      "block_c": 2}}))
    assert AT.AutotuneCache(path).get(key) is None


def test_autotune_cache_save_merges_concurrent_writers(tmp_path):
    path = tmp_path / "cache.json"
    a = AT.AutotuneCache(path)
    b = AT.AutotuneCache(path)  # opened before a saves (sees no file)
    ka = AT.shape_key("cuda", "fused", 16, 4, 32, 2, torch.float32)
    kb = AT.shape_key("cuda", "fused", 64, 8, 128, 4, torch.int8)
    a.put(ka, AT.TileConfig(1, 16, 4, 32), us=10.0)
    b.put(kb, AT.TileConfig(8, 32, 8, 256), us=20.0)
    a.save()
    b.save()  # merge-on-save: a's entry survives
    merged = AT.AutotuneCache(path)
    assert merged.get(ka) == AT.TileConfig(1, 16, 4, 32)
    assert merged.get(kb) == AT.TileConfig(8, 32, 8, 256)
    assert len(merged) == 2
    # the in-memory writer wins a genuine conflict (it just measured)
    b.put(ka, AT.TileConfig(2, 16, 4, 32), us=5.0)
    b.save()
    assert AT.AutotuneCache(path).get(ka) == AT.TileConfig(2, 16, 4, 32)
    assert list(tmp_path.glob("*.tmp.*")) == []


def test_default_cache_corruption_degrades_not_crashes(tmp_path, monkeypatch):
    path = tmp_path / "garbage.json"
    path.write_bytes(b'{"cuda|fused|b16\x00\xff TRUNCATED')
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(AT, "_default_cache", None)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        cache = AT.get_default_cache()
    assert len(cache) == 0 and cache.path == path
    assert AT.get_tiles(16, 4, 32, 2) == AT.heuristic_tiles(16, 4, 32, 2)
    # dispatch on the CPU (the plain versions) still works
    rng = np.random.default_rng(0)
    p = D.params_from_arrays(
        torch.from_numpy(rng.integers(0, 2, (4, 2)).astype(np.int32)),
        torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 4, 32)).astype(np.float32)),
        torch.ones(()), torch.zeros((32,)))
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    torch.testing.assert_close(D.lutmu_matmul(x, p, backend="fused"),
                               D.lutmu_matmul(x, p, backend="ref"))


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    path = AT.default_cache_path()
    assert path.parts[-2:] == ("repro_torch", "lutmu_autotune.json")


def test_get_tiles_prefers_cache_then_heuristic(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cache = AT.AutotuneCache(tmp_path / "cache.json")
    pinned = AT.TileConfig(3, 8, 4, 128)
    cache.put(AT.shape_key("cuda", "fused", 64, 8, 128, 4, torch.float32),
              pinned)
    assert AT.get_tiles(64, 8, 128, 4, cache=cache) == pinned
    # the unfused namespace is its own
    assert (AT.get_tiles(64, 8, 128, 4, backend="unfused", cache=cache)
            == AT.heuristic_tiles(64, 8, 128, 4))
    assert (AT.get_tiles(64, 8, 256, 4, cache=cache)
            == AT.heuristic_tiles(64, 8, 256, 4))
    # REPRO_AUTOTUNE measures on the card only: off it, the heuristic
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setattr(AT, "measure_fused_tiles",
                        lambda *a, **k: pytest.fail("measured off the card"))
    assert (AT.get_tiles(64, 8, 512, 4, cache=cache, device="cpu")
            == AT.heuristic_tiles(64, 8, 512, 4))


def test_measured_autotune_persists_and_rehits(tmp_path, monkeypatch):
    """A fake timer (the kernels run only on the card): the largest cluster
    measures fastest, is kept, written, and found by a fresh cache."""
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    timed = []

    def fake(fn, iters=5):  # each candidate faster than the one before
        timed.append(1)
        return 100.0 - 10 * len(timed)

    monkeypatch.setattr(AT, "_time_us", fake)
    cache = AT.AutotuneCache(tmp_path / "cache.json")
    kw = dict(b=16, c=8, n=64, depth=3, lut_dtype=torch.int8)
    cands = AT.candidate_tiles(**kw)
    best = AT.get_tiles(**kw, cache=cache, allow_measure=True, device="cpu")
    assert len(timed) == len(cands) and best == cands[-1]
    key = AT.shape_key("cuda", "fused", 16, 8, 64, 3, torch.int8)
    assert cache.get(key) == best
    monkeypatch.setattr(AT, "measure_fused_tiles",
                        lambda *a, **k: pytest.fail("measured on cache hit"))
    fresh = AT.AutotuneCache(tmp_path / "cache.json")
    assert AT.get_tiles(**kw, cache=fresh, allow_measure=True) == best


def test_candidates_heuristic_first_and_in_budget():
    for b, c, n, depth, dt in [(4, 640, 8704, 4, torch.int8),
                               (32, 2176, 5120, 4, torch.bfloat16),
                               (256, 98, 128, 4, torch.int16)]:
        cands = AT.candidate_tiles(b, c, n, depth, dt)
        assert cands[0] == AT.heuristic_tiles(b, c, n, depth, dt)
        assert len(set(cands)) == len(cands) > 1
        for t in cands:
            p = AT.fused_plan(t, b, c, depth, dt)
            assert p.smem <= FL.MAX_SMEM
            assert p.smem == AT.fused_smem_bytes(t, b, c, depth, dt)
            assert -(-c // p.per) == p.cluster  # every block has codebooks
            assert {k: v for k, v in t.to_dict().items() if k != "cluster"} \
                == {k: v for k, v in cands[0].to_dict().items()
                    if k != "cluster"}


@pytest.mark.parametrize("case", CS.CASES, ids=lambda c: "-".join(map(str, c)))
def test_heuristic_is_todays_plan_on_every_chip_smoke_case(case):
    """With an empty cache every launch is the wrapper's own, on an H100's
    132 SMs (off the card: shared memory alone, as ``plan`` without an
    occupancy query)."""
    proj, b, lut_name = case
    c, n = CS.SHAPES[proj]
    dt = getattr(torch, lut_name)
    itemsize = torch.empty((), dtype=dt).element_size()
    t = AT.heuristic_tiles(b, c, n, CS.DEPTH, dt)
    assert (AT.fused_plan(t, b, c, CS.DEPTH, dt)
            == FL.plan(b, c, n, CS.DEPTH, itemsize, AT.H100_SMS))
    assert (AT.encode_plan(t, b, c, CS.DEPTH)
            == ME.plan(b, c, CS.DEPTH, 1 if dt == torch.int8 else 4,
                       AT.H100_SMS))
    k = c * 2**CS.DEPTH
    splits, per = LA.k_splits(b, k, n, dt, AT.H100_SMS)
    assert t.split_k == per and -(-k // t.split_k) == splits


@pytest.mark.parametrize("s_len", CS.VERIFY_S)
@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
def test_verify_heuristic_is_todays_split(s_len, kv):
    b, w, nkv, g, hd, ps = CS.VERIFY_SHAPE
    t = AT.verify_heuristic_tiles(s_len, w, nkv, g, hd, getattr(torch, kv),
                                  b=b, page_size=ps)
    assert t.splits == FV.verify_splits(s_len)[0]
    assert FV.split_cap(s_len, t.splits) == FV.verify_splits(s_len)[1]


def test_get_verify_tiles_cache_hit_and_heuristic(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cache = AT.AutotuneCache(tmp_path / "tune.json")
    key = AT.verify_shape_key("cuda", 4096, 5, 8, 5, 128, torch.int8, 4)
    assert key == "cuda|verify|b4|s4096|w5|kv8|g5|h128|int8"
    cache.put(key, AT.VerifyTileConfig(4), us=1.0)
    hit = AT.get_verify_tiles(4096, 5, 8, 5, 128, torch.int8, b=4,
                              cache=cache)
    assert hit == AT.VerifyTileConfig(4)
    assert AT.get_verify_tiles(4096, 5, 8, 5, 128, torch.float32, b=4,
                               cache=cache) == AT.VerifyTileConfig(8)
    assert AT.get_verify_tiles(128, 5, 8, 5, 128, torch.int8, b=4,
                               cache=cache) == AT.VerifyTileConfig(1)


def test_measured_verify_tiles_persist_and_rehit(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    calls = []

    def fake(fn, iters=5):  # the 3-split candidate is fastest
        calls.append(1)
        return 5.0 if len(calls) == 3 else 9.0

    monkeypatch.setattr(AT, "_time_us", fake)
    cache = AT.AutotuneCache(tmp_path / "tune.json")
    shape = (1024, 3, 2, 2, 32)
    cands = AT.verify_candidate_tiles(*shape, torch.int8, b=2)
    assert cands[0].splits == 2 and len(cands) == FV._MAX_SPLITS
    got = AT.get_verify_tiles(*shape, torch.int8, b=2, allow_measure=True,
                              cache=cache, device="cpu")
    assert got == cands[2] and len(calls) == len(cands)
    monkeypatch.setattr(AT, "measure_verify_tiles",
                        lambda *a, **k: pytest.fail("re-measured"))
    fresh = AT.AutotuneCache(tmp_path / "tune.json")
    assert AT.get_verify_tiles(*shape, torch.int8, b=2, allow_measure=True,
                               cache=fresh) == got


def test_ops_and_dispatch_take_plans_on_the_cpu():
    """On CPU tensors a plan is ignored: every op is its plain version."""
    rng = np.random.default_rng(1)
    b, c, depth, n = 6, 5, 3, 40
    tree = M.HashTree(torch.from_numpy(rng.integers(0, 4, (c, depth)).astype(
        np.int32)), torch.from_numpy(rng.normal(size=(c, 7)).astype(np.float32)))
    lut = torch.from_numpy(rng.integers(-128, 128, (c, 8, n)).astype(np.int8))
    p = M.MaddnessParams(tree, None, lut, torch.full((n,), 0.01),
                         torch.zeros((n,)))
    x = torch.from_numpy(rng.normal(size=(b, c * 4)).astype(np.float32))
    want = D.lutmu_matmul(x, p, backend="ref")
    tiles = AT.TileConfig(2, 4, 2, 16)
    for be in ("fused", "unfused"):
        assert torch.equal(D.lutmu_matmul(x, p, backend=be, tiles=tiles), want)
    assert torch.equal(ops.amm_matmul(x, p, tiles=tiles), want)
    xs = M.gather_split_values(x, tree)
    onehot = ops.encode_onehot(xs, tree, tiles=tiles)
    codes = ops.encode_codes(xs, tree)
    assert torch.equal(codes, M.encode(xs, tree))
    assert torch.equal(onehot, M.encode_onehot(xs, tree))
    assert torch.equal(ops.lut_aggregate(onehot, lut, p.lut_scale,
                                         p.lut_offset, tiles=tiles), want)
    package = x.reshape(b, c, 4).gather(
        2, tree.split_dims.long()[None].expand(b, c, depth)
    ).transpose(1, 2).reshape(b, depth * c)
    assert torch.equal(ops.amm_matmul_package(package, p, c, depth), want)


def test_recorded_plans_apply_only_from_a_port_artifact(tmp_path):
    rng = np.random.default_rng(2)
    calib = rng.normal(size=(96, 32)).astype(np.float32)
    ws = [(rng.normal(size=(32, 16)) / 6).astype(np.float32),
          (rng.normal(size=(16, 8)) / 4).astype(np.float32)]
    res = TC.compile_chain(ws, [None, None], calib, num_codebooks=[4, 2],
                           depths=[2, 2], activations=["relu"],
                           resolution="int8", out=str(tmp_path / "chain"))
    recs = res.artifact.manifest["layers"]
    assert all(AT.TileConfig.from_dict(r["tiles"]) == l.tiles
               for r, l in zip(recs, res.chain.layers))
    assert recs[0]["tiles"] == AT.heuristic_tiles(
        256, 4, recs[0]["cols"], 2, torch.int8).to_dict()
    art = TC.load_artifact(tmp_path / "chain")
    chain = art.to_chain(device="cpu")
    assert [l.tiles for l in chain.layers] == [l.tiles for l in res.chain.layers]
    art.manifest["platform"] = "tpu"  # another package's plans: ignored
    other = art.to_chain(device="cpu")
    assert other.backends is None
    assert all(l.tiles is None for l in other.layers)
    x = torch.from_numpy(calib[:8])
    assert torch.equal(chain(x), other(x))
