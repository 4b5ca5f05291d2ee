"""The serving state's placement pieces of the port, on the CPU, without a
mesh: the plain split functions a mesh runs with collectives.

* ``decode_attend_split`` (the slot cache's read over sequence shards,
  combined in rank order) against ``decode_attend`` over the whole view,
  at 2–8 shards, with and without a window, float32, bfloat16 and int8
  caches, within ``split_read_bound``: each softmax weight of the split
  read lies within ``SPLIT_REL`` of the whole read's (the denominator
  summed in parts), so a rounded weight moves at most one rounding step of
  the cache type (one ``round(w·127)`` step for int8) where that interval
  crosses a rounding boundary, and float value products add
  ``SPLIT_REL`` of ``Σ w·|v|`` for their other grouping.
* ``paged_view_part`` + ``sum_parts`` (the pool cut into page shards,
  every shard's masked gather summed bitwise) equal ``paged_view`` bit for
  bit, negative zeros included.
* ``PagedKVCache(pad_to=)``: the physical page count, the trash page and
  the buffers' shape equal the JAX cache's; padding pages are never
  allocated.
* On an abstract mesh (``analysis.cost.ShapeComm``): a decode over a
  sequence cut over ``model`` issues the split softmax's three
  all-reduces, and a paged decode over a pool cut over ``data`` gathers
  the step's K/V and reduce-scatters the rows' views, at the bytes stated.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_verify as FV

SPLIT_REL = 1e-5


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _read_inputs(dtype, b=3, s=48, nkv=2, g=3, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    qg = torch.from_numpy(rng.normal(size=(b, 1, nkv, g, hd)).astype(
        np.float32))
    if dtype == torch.int8:
        k = torch.from_numpy(rng.integers(-127, 128, (b, s, nkv, hd)).astype(
            np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (b, s, nkv, hd)).astype(
            np.int8))
    else:
        k = torch.from_numpy(rng.normal(size=(b, s, nkv, hd)).astype(
            np.float32)).to(dtype)
        v = torch.from_numpy(rng.normal(size=(b, s, nkv, hd)).astype(
            np.float32)).to(dtype)
    pos = torch.tensor([s - 1, s // 2, 3])[:b]
    return qg, k, v, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_split_read_within_bound_of_decode_attend(dtype, window, shards):
    qg, k, v, pos = _read_inputs(dtype)
    want = FV.decode_attend(qg, k, v, pos, window)
    got = FV.decode_attend_split(qg, list(k.chunk(shards, dim=1)),
                                 list(v.chunk(shards, dim=1)), pos, window)
    assert got.shape == want.shape and got.dtype == want.dtype
    w = torch.softmax(FV.split_logits(qg, k, pos, window, 0), dim=-1)
    bound = FV.split_read_bound(w, v, SPLIT_REL)
    assert bool(((got - want).abs() <= bound).all()), (
        float((got - want).abs().max()), float(bound.max()))
    # a position past the row's mask contributes nothing
    assert bool(torch.isfinite(got).all())


def test_split_read_one_shard_is_the_whole_read_up_to_its_sums():
    qg, k, v, pos = _read_inputs(torch.float32, seed=1)
    got = FV.decode_attend_split(qg, [k], [v], pos, None)
    want = FV.decode_attend(qg, k, v, pos, None)
    torch.testing.assert_close(got, want, rtol=SPLIT_REL, atol=1e-6)


def test_split_read_bound_is_tight_enough_to_fail_a_wrong_read():
    """The bound rejects a read that drops one shard's softmax mass (a
    combine that forgot a rank)."""
    qg, k, v, pos = _read_inputs(torch.bfloat16, seed=2)
    ks, vs = list(k.chunk(4, dim=1)), list(v.chunk(4, dim=1))
    lgs = [FV.split_logits(qg, kk, pos, None, i * 12)
           for i, kk in enumerate(ks)]
    m = torch.stack([lg.amax(-1, keepdim=True) for lg in lgs]).amax(0)
    s = sum(FV.split_exp_sum(lg, m) for lg in lgs[:-1])  # one shard lost
    bad = sum(FV.split_values(lg, m, s, vv) for lg, vv in zip(lgs, vs))
    want = FV.decode_attend(qg, k, v, pos, None)
    w = torch.softmax(FV.split_logits(qg, k, pos, None, 0), dim=-1)
    bound = FV.split_read_bound(w, v, SPLIT_REL)
    assert not bool(((bad - want).abs() <= bound).all())


def test_cross_read_split_unmasked_float():
    """Cross-attention's read: no mask, weights not rounded."""
    qg, k, v, _ = _read_inputs(torch.float32, seed=3)
    lg = FV.split_logits(qg, k, None, None, 0)
    want = torch.einsum("bngst,btnh->bsngh", torch.softmax(lg, dim=-1),
                        v.float())
    lgs = [FV.split_logits(qg, kk, None, None, 0) for kk in k.chunk(3, 1)]
    m = torch.stack([x.amax(-1, keepdim=True) for x in lgs]).amax(0)
    s = sum(FV.split_exp_sum(x, m) for x in lgs)
    got = sum(FV.split_values(x, m, s, vv, rounded=False)
              for x, vv in zip(lgs, v.chunk(3, 1)))
    torch.testing.assert_close(got, want, rtol=SPLIT_REL, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shards", [2, 4])
def test_paged_view_parts_sum_to_the_view_bitwise(dtype, shards):
    rng = np.random.default_rng(4)
    total, ps, nkv, hd, b, mp = 12, 4, 2, 8, 3, 5
    if dtype == torch.int8:
        pages = torch.from_numpy(rng.integers(-127, 128, (total, ps, nkv, hd))
                                 .astype(np.int8))
    else:
        pages = torch.from_numpy(rng.normal(size=(total, ps, nkv, hd)).astype(
            np.float32)).to(dtype)
        pages[1, 0, 0, :3] = -0.0  # a negative zero survives the sum
    vpages = pages.flip(0).contiguous()
    table = torch.from_numpy(rng.integers(0, total, (b, mp)).astype(np.int32))
    held = total // shards
    parts = [FV.paged_view_part(pages[r * held:(r + 1) * held],
                                vpages[r * held:(r + 1) * held], table,
                                r * held, held) for r in range(shards)]
    k_want, v_want = FV.paged_view(pages, vpages, table)
    assert _bits_equal(FV.sum_parts([p[0] for p in parts]), k_want)
    assert _bits_equal(FV.sum_parts([p[1] for p in parts]), v_want)


@pytest.mark.parametrize("num_pages,pad_to", [(6, 1), (6, 2), (7, 2),
                                              (6, 4), (32, 16)])
def test_paged_pool_padding_equals_jax(num_pages, pad_to):
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.serving.kv_cache import PagedKVCache as JCache
    from repro_torch.convert import config_from_jax
    from repro_torch.serving.kv_cache import PagedKVCache
    jcfg = get_config("qwen3-14b", reduced=True)
    want = JCache(jcfg, num_pages=num_pages, page_size=4, dtype=jnp.float32,
                  pad_to=pad_to)
    got = PagedKVCache(config_from_jax(jcfg), num_pages=num_pages,
                       page_size=4, pad_to=pad_to, device="cpu")
    assert got.trash == want.trash
    assert got.buffers["k"].shape == want.buffers["k"].shape
    assert got.allocator.num_pages == num_pages
    pages = got.allocator.alloc(num_pages)
    assert sorted(pages) == list(range(num_pages))  # no padding page
    assert got.allocator.alloc(1) is None


def _meta_rank(mesh_shape, cfg):
    """A rank (index 0 on every axis) of an abstract mesh: its parallel
    context over ``analysis.cost.ShapeComm``."""
    from repro_torch.analysis.cost import ShapeComm
    from repro_torch.device import MetaGenerator
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.models import model as MD
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    comm = ShapeComm(mesh)
    params = MD.init_params(cfg, MetaGenerator())
    return ParallelContext(cfg, mesh, params, comm), comm, params


def _tiny():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-14b", reduced=True),
                               num_heads=2, num_kv_heads=1, head_dim=32,
                               d_model=64)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_shape_comm_counts_the_split_read():
    """A slot-cache decode whose sequence is cut over ``model`` issues
    the split softmax's three all-reduces: the row maxima, the
    denominators and the value products."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as MD
    cfg = _tiny()
    par, comm, params = _meta_rank((1, 4), cfg)
    b, s_len, hd, g = 2, 32, cfg.resolved_head_dim, cfg.num_heads
    specs = par.place_cache(MD.init_cache(cfg, b, s_len, device="meta"), b)
    assert specs["k"][2] == "model" and par.seq_split("k") == (("model",), 0)
    lp = MD.layer_params(params["layers"], 0)["attn"]
    out = A.decode_step(lp, _meta(b, 1, cfg.d_model), cfg,
                        _meta(b, s_len // 4, 1, hd), _meta(b, s_len // 4, 1,
                                                           hd),
                        torch.zeros((b,), dtype=torch.int64, device="meta"),
                        None, par.seq_split("k"), par)
    assert out.shape == (b, 1, cfg.d_model)
    got = comm.collectives()["all-reduce"]
    assert got == {"count": 3, "bytes": 4 * (2 * b * g + b * g * hd)}


def test_shape_comm_counts_the_pool_views():
    """A paged decode on a pool cut over two data ranks: the step's K/V
    gathered over ``data``, and the rows' views reduce-scattered (the
    rows split) as int32 words, K and V in one."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as MD
    cfg = _tiny()
    par, comm, params = _meta_rank((2, 1), cfg)
    assert par.pool_cut
    b, mp, ps, hd = 4, 3, 4, cfg.resolved_head_dim
    held = 4  # a shard of 8 physical pages, plus its write sink
    lp = MD.layer_params(params["layers"], 0)["attn"]
    out = A.paged_decode_step(
        lp, _meta(b // 2, 1, cfg.d_model), cfg, _meta(held + 1, ps, 1, hd),
        _meta(held + 1, ps, 1, hd),
        torch.zeros((b, mp), dtype=torch.int32, device="meta"),
        torch.zeros((b,), dtype=torch.int64, device="meta"), None, par=par)
    assert out.shape == (b // 2, 1, cfg.d_model)
    got = comm.collectives()
    assert got["reduce-scatter"] == {"count": 1,
                                     "bytes": b * 2 * mp * ps * hd * 4}
    assert got["all-gather"]["count"] == 2
