#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each fatal on failure:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — the three LUT-MU CUDA kernels from ``src/repro_torch/csrc``;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (gate/up C=640 N=8704, down C=2176 N=5120; B=4 decode and
   B=32 prefill chunk; int8, plus one float32 and one bfloat16 LUT case):
   int8 bit for bit, float within the stated tolerance; kernel, plain,
   bound and library (one ``torch.matmul`` of the float32 one-hot × LUT)
   times;
4. agree — at full width, a prefill chunk and a decode step through the
   kernels give bit-identical logits to the same calls through the plain
   ``ref`` LUT-MU path;
5. serve — qwen3-14b at full width and depth (40 layers, bf16, random int8
   LUTs from a seeded generator on the card) through
   ``load_engine(None, ...)``: 6 greedy requests, 16 new tokens each, with
   every launch counter set to 0 just before; ``fused_lutmu`` must launch
   120 times per forward call and the ``ref`` path never; then a decode
   step's host time and device busy time (``torch.profiler``);
6. unfused — the ``--amm-backend unfused`` path (encode + aggregate
   kernels) at full width, depth cut to 4 layers, 2 requests.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repo's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                # H100 SXM device memory
PEAK_OPS = {"int8": 1979e12,             # tensor-core dense rates
            "bfloat16": 989e12,
            "float32": 67e12}            # float32 outside the tensor cores
ADD_OPS_PER_S = 67e12                    # gather-sum adds on the CUDA cores
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-3      # float32 sums of ≤ 2176 terms, in
                                         # another order, then ×≤0.02 scale
DEPTH = 4
SHAPES = {"gate_up": (640, 8704), "down": (2176, 5120)}
CASES = [("gate_up", 4, "int8"), ("down", 4, "int8"),
         ("gate_up", 32, "int8"), ("down", 32, "int8"),
         ("gate_up", 4, "float32"), ("down", 32, "bfloat16")]
JSON_CASE = ("down", 4, "int8")          # the case each kernel's JSON entry reports


def ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """CUDA-event times of single calls, queued behind a device sleep so the
    host's enqueue cost never shows, with the 50 MB L2 cache flushed before
    each call as the caller (a different layer's tables) would leave it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        torch.cuda._sleep(50_000_000)  # ~25 ms: the host enqueues meanwhile
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_checks(torch, timer, mods):
    FL, ME, LA, ref = mods
    dt = {"int8": torch.int8, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    g = 2**DEPTH
    results = {"fused_lutmu": {}, "encode_onehot": {}, "lut_aggregate": {}}
    for proj, b, lut_name in CASES:
        c, n = SHAPES[proj]
        lut_dtype = dt[lut_name]
        x = torch.randn((b, c, DEPTH), generator=gen, device="cuda")
        thr = torch.randn((c, g - 1), generator=gen, device="cuda")
        if lut_dtype == torch.int8:
            lut = torch.randint(-128, 128, (c, g, n), generator=gen,
                                dtype=torch.int8, device="cuda")
        else:
            lut = torch.randn((c, g, n), generator=gen, device="cuda").to(lut_dtype)
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.015 + 0.005
        offset = torch.randn((n,), generator=gen, device="cuda")
        itemsize = lut.element_size()
        codes = ref.encode_codes_ref(x, thr).to(torch.int64)
        rows_needed = torch.unique(
            codes + g * torch.arange(c, device="cuda")[None]).numel()
        onehot = ME.encode_onehot_plain(x, thr)  # (B, C, G) float32
        lhs_f32 = onehot.reshape(b, -1)
        rhs_f32 = lut.reshape(-1, n).float()
        library = lambda: torch.matmul(lhs_f32, rhs_f32)  # noqa: E731
        library_ms = timer.ms(library, 5)
        io_bytes = 2 * n * 4 + b * n * 4  # epilogue vectors + output
        exact = lut_dtype == torch.int8

        def compare(name, got, want, exact_):
            torch.cuda.synchronize()
            ensure(got.shape == want.shape and got.dtype == want.dtype,
                   f"{name}: {got.shape}/{got.dtype} != {want.shape}/{want.dtype}")
            ensure(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
            err = (got.float() - want.float()).abs().max().item()
            if exact_:
                ensure(torch.equal(got, want), f"{name}: not bit-equal (max err {err})")
            else:
                torch.testing.assert_close(got, want, rtol=FLOAT_RTOL,
                                           atol=FLOAT_ATOL, msg=name)
            return err

        key = (proj, b, lut_name)
        # kernel 1: fused encode + gather-sum
        args = (x, thr, lut, scale, offset)
        err = compare("fused_lutmu", FL.fused_lutmu(*args),
                      FL.fused_lutmu_plain(*args), exact)
        nbytes = (x.numel() * 4 + thr.numel() * 4 + rows_needed * n * itemsize
                  + io_bytes)
        bms, by = bound_ms(nbytes, b * c * n, ADD_OPS_PER_S)
        results["fused_lutmu"][key] = dict(
            max_abs_err=err, ms=timer.ms(lambda: FL.fused_lutmu(*args), 20),
            plain_ms=timer.ms(lambda: FL.fused_lutmu_plain(*args), 3),
            bound_ms=bms, bound_by=by, library_ms=library_ms)
        # kernel 2: encode to a one-hot (float32 out, as the unfused path)
        err = compare("encode_onehot", ME.encode_onehot(x, thr), onehot, True)
        nbytes = x.numel() * 4 + thr.numel() * 4 + onehot.numel() * 4
        bms, by = bound_ms(nbytes, b * c * (g - 1), ADD_OPS_PER_S)
        results["encode_onehot"][key] = dict(
            max_abs_err=err, ms=timer.ms(lambda: ME.encode_onehot(x, thr), 20),
            plain_ms=timer.ms(lambda: ME.encode_onehot_plain(x, thr), 3),
            bound_ms=bms, bound_by=by, library_ms=None)
        # kernel 3: one-hot × LUT product (one LUT row per nonzero is needed)
        agg = (onehot, lut, scale, offset)
        err = compare("lut_aggregate", LA.lut_aggregate(*agg),
                      LA.lut_aggregate_plain(*agg), exact)
        nbytes = onehot.numel() * 4 + rows_needed * n * itemsize + io_bytes
        bms, by = bound_ms(nbytes, 2 * b * c * n, PEAK_OPS[lut_name])
        results["lut_aggregate"][key] = dict(
            max_abs_err=err, ms=timer.ms(lambda: LA.lut_aggregate(*agg), 10),
            plain_ms=timer.ms(lambda: LA.lut_aggregate_plain(*agg), 3),
            bound_ms=bms, bound_by=by, library_ms=library_ms)
        for name in results:
            r = results[name][key]
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"[kernel] {name:13s} {proj:7s} B={b:<2d} {lut_name:8s} "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"library_ms={lib} max_abs_err={r['max_abs_err']:.3g}",
                  flush=True)
        del x, thr, lut, onehot, lhs_f32, rhs_f32, codes
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the model
# ---------------------------------------------------------------------------


def prompts(vocab: int, n: int):
    from repro_torch.launch.serve import cli_prompts
    return cli_prompts(None, n, vocab)


def reset_counts(counters):
    for c in counters:
        c.reset()


def agree_phase(torch, cfg, params, MD):
    """Kernels vs the plain ``ref`` LUT-MU path inside the full model: the
    int8 sums are exact and the epilogue rounds the same way, so a prefill
    chunk's and a decode step's logits must be bit-identical."""
    out = {}
    for backend in ("fused", "ref"):
        c = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                             backend=backend))
        cache = MD.init_paged_cache(c, 3, 16, torch.bfloat16, "cuda")
        toks = torch.tensor([prompts(cfg.vocab_size, 1)[0] + [0] * 24],
                            dtype=torch.int32, device="cuda")  # 8 real of 32
        row = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        pf = MD.paged_prefill_chunk(params, toks, 0, 8, row, cache, c,
                                    compute_dtype=torch.bfloat16)
        nxt = int(pf[0, -1].argmax())
        dec = MD.paged_decode_step(
            params, torch.tensor([[nxt], [0]], dtype=torch.int32, device="cuda"),
            torch.tensor([8, 0], dtype=torch.int32, device="cuda"),
            torch.tensor([[0, 1], [2, 2]], dtype=torch.int32, device="cuda"),
            cache, c, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ensure(tuple(pf.shape) == (1, 1, cfg.vocab_size)
               and tuple(dec.shape) == (2, 1, cfg.vocab_size),
               f"logit shapes {tuple(pf.shape)} {tuple(dec.shape)}")
        ensure(bool(torch.isfinite(pf).all() and torch.isfinite(dec[0]).all()),
               f"{backend}: non-finite logits")
        out[backend] = (pf, dec[0])
        del cache
    ensure(torch.equal(out["fused"][0], out["ref"][0]),
           "prefill logits: kernels != plain path")
    ensure(torch.equal(out["fused"][1], out["ref"][1]),
           "decode logits: kernels != plain path")
    print("[agree] full-width prefill chunk + decode step: kernel logits "
          "bit-identical to the plain LUT-MU path", flush=True)


def serve(torch, cfg, params, load_engine, n_requests: int, max_new: int):
    """Drive the engine; returns (requests, seconds, ttft list, engine)."""
    engine = load_engine(None, params, cfg, max_batch=4, max_len=128,
                         page_size=16, prefill_chunk=32,
                         compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=max_new)
               for p in prompts(cfg.vocab_size, n_requests)]
    ttft = {}
    while engine.has_work:
        engine.step()  # sampling pulls the tokens to the host: a sync
        now = time.perf_counter()
        for h in handles:
            if h.generated and h.request_id not in ttft:
                ttft[h.request_id] = now - t0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return handles, dt, [ttft[h.request_id] for h in handles], engine


def profile_phase(torch, cfg, params, load_engine, steps: int = 6):
    """Where a decode step's time goes: host-clock step time without the
    profiler, then device busy time per step from ``torch.profiler`` kernel
    events over the same number of steps (4 rows decoding)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = load_engine(None, params, cfg, max_batch=4, max_len=128,
                         page_size=16, prefill_chunk=32,
                         compute_dtype=torch.bfloat16, device="cuda")
    for p in prompts(cfg.vocab_size, 4):
        engine.submit(p, max_new_tokens=4 + 2 * steps + 2)
    for _ in range(4):  # one prefill chunk per step: all 4 rows admitted
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 / steps
    print(f"[profile] decode step (4 rows, {cfg.num_layers} layers): "
          f"{wall * 1e3:.2f} ms/step unprofiled; device busy "
          f"{busy * 1e3:.2f} ms/step = {100 * busy / wall:.1f}% "
          f"(idle {100 - 100 * busy / wall:.1f}%)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"x{e.count / steps:6.0f}  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import fused_lutmu as FL
    from repro_torch.kernels import lut_aggregate as LA
    from repro_torch.kernels import maddness_encode as ME
    from repro_torch.kernels import ref
    from repro_torch.models import model as MD
    from repro_torch.serving import load_engine

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"[build] {len(_build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f}s ({' '.join(_build.NVCC_FLAGS)})",
          flush=True)

    # 3. kernels
    timer = Timer(torch)
    kres = kernel_checks(torch, timer, (FL, ME, LA, ref))
    del timer
    torch.cuda.empty_cache()

    # 4. + 5. full-width qwen3-14b, 40 layers, bf16, random int8 LUTs
    cfg = get_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(
        cfg.amm, enabled=True, backend="auto"))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MD.init_params(cfg, gen, torch.bfloat16, serving=True)
    torch.cuda.synchronize()
    print(f"[serve] qwen3-14b init: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of params in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    agree_phase(torch, cfg, params, MD)
    counters = (FL.LAUNCHES, ME.LAUNCHES, LA.LAUNCHES, dispatch.REF_ON_CUDA)
    serve(torch, cfg, params, load_engine, 1, 2)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    handles, dt, ttft, engine = serve(torch, cfg, params, load_engine, 6, 16)
    launches = {"fused_lutmu": FL.LAUNCHES.n, "encode_onehot": ME.LAUNCHES.n,
                "lut_aggregate": LA.LAUNCHES.n}
    calls = engine.stats["prefill_calls"] + engine.stats["decode_calls"]
    for h in handles:
        ensure(h.done and len(h.generated) == 16,
               f"request {h.request_id}: {len(h.generated)} tokens")
        ensure(all(0 <= t < cfg.vocab_size for t in h.generated),
               f"request {h.request_id}: token out of vocabulary")
    per_call = 3 * cfg.num_layers
    ensure(launches["fused_lutmu"] == per_call * calls,
           f"fused_lutmu launches {launches['fused_lutmu']} != "
           f"{per_call} x {calls} forward calls")
    ensure(dispatch.REF_ON_CUDA.n == 0,
           f"{dispatch.REF_ON_CUDA.n} ref LUT-MU calls ran on CUDA")
    n_tok = sum(len(h.generated) for h in handles)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] 6 requests x 16 tokens: {n_tok} tokens in {dt:.3f}s = "
          f"{n_tok / dt:.2f} tok/s; TTFT mean {sum(ttft) / len(ttft):.4f}s "
          f"min {min(ttft):.4f}s max {max(ttft):.4f}s; forward calls "
          f"{engine.stats['prefill_calls']} prefill + "
          f"{engine.stats['decode_calls']} decode; fused_lutmu launches "
          f"{launches['fused_lutmu']} = {per_call} x {calls}; ref on CUDA 0; "
          f"peak memory {peak / 1e9:.2f} GB", flush=True)
    for h in handles:
        print(f"  req {h.request_id}: {h.prompt} -> {h.generated}")
    del engine, handles
    profile_phase(torch, cfg, params, load_engine)
    del params
    torch.cuda.empty_cache()

    # 6. the unfused path at full width, depth cut to 4 layers
    ucfg = dataclasses.replace(cfg, num_layers=4, amm=dataclasses.replace(
        cfg.amm, backend="unfused"))
    uparams = MD.init_params(ucfg, torch.Generator(device="cuda").manual_seed(1),
                             torch.bfloat16, serving=True)
    reset_counts(counters)
    uh, udt, _, ueng = serve(torch, ucfg, uparams, load_engine, 2, 4)
    ucalls = ueng.stats["prefill_calls"] + ueng.stats["decode_calls"]
    for h in uh:
        ensure(h.done and len(h.generated) == 4
               and all(0 <= t < ucfg.vocab_size for t in h.generated),
               f"unfused request {h.request_id}: {h.generated}")
    ensure(ME.LAUNCHES.n == 3 * ucfg.num_layers * ucalls
           and LA.LAUNCHES.n == ME.LAUNCHES.n and FL.LAUNCHES.n == 0
           and dispatch.REF_ON_CUDA.n == 0,
           f"unfused launches: encode {ME.LAUNCHES.n} aggregate "
           f"{LA.LAUNCHES.n} fused {FL.LAUNCHES.n} ref {dispatch.REF_ON_CUDA.n}"
           f" for {ucalls} calls")
    launches["encode_onehot"] = ME.LAUNCHES.n
    launches["lut_aggregate"] = LA.LAUNCHES.n
    print(f"[unfused] 4 layers, 2 requests x 4 tokens in {udt:.3f}s; "
          f"encode_onehot {ME.LAUNCHES.n} + lut_aggregate {LA.LAUNCHES.n} "
          f"launches = 12 x {ucalls} calls", flush=True)
    del ueng, uparams

    sources = {"fused_lutmu": ("src/repro_torch/csrc/fused_lutmu.cu",
                               "src/repro/kernels/fused_lutmu.py:124", "auto"),
               "encode_onehot": ("src/repro_torch/csrc/maddness_encode.cu",
                                 "src/repro/kernels/maddness_encode.py:85",
                                 "unfused"),
               "lut_aggregate": ("src/repro_torch/csrc/lut_aggregate.cu",
                                 "src/repro/kernels/lut_aggregate.py:96",
                                 "unfused")}
    entries = []
    for name, (src, replaces, path) in sources.items():
        r = kres[name][JSON_CASE]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name], "path": path,
            "shape": "down C=2176 N=5120, B=4, int8",
            "max_abs_err": max(v["max_abs_err"] for v in kres[name].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    ensure(all(math.isfinite(e["ms"]) and e["launches"] > 0 for e in entries),
           "a kernel has no time or no launches")
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
