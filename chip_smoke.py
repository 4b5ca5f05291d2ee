#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each fatal on failure:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — the four CUDA kernels from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (gate/up C=640 N=8704, down C=2176 N=5120; B=4 decode and
   B=32 prefill chunk; int8, plus one float32 and one bfloat16 LUT case;
   int16 at gate/up B=4 and at the SFC chain's layer 0, C=98 N=128
   B=256; the ResNet-9 shapes of phase 23: a Kn2col conv1 tap C=8 N=128
   B=262,144 float32 and int8, a res2a tap C=64 N=512 B=4096 and the
   Im2col res1a C=128 N=128 B=65,536, float32): int8 and int16 bit for
   bit, float within the stated tolerance;
   kernel, plain, bound and library (one ``torch.matmul`` of the float32
   one-hot × LUT) times; the encode with float32 and (int8 cases) int8
   output, each also with its profiler device time per call, beside the
   launch floor (one ``zero_()`` of a 4-byte tensor under the same timer);
4. agree — at full width, a prefill chunk and a decode step through the
   kernels give bit-identical logits to the same calls through the plain
   ``ref`` LUT-MU path;
5. serve — qwen3-14b at full width and depth (40 layers, bf16, random int8
   LUTs from a seeded generator on the card) through
   ``load_engine(None, ...)``: one short request captures the engine's
   step programs (CUDA graphs; capture seconds and graph nodes printed on
   their own line), then 6 greedy requests, 16 new tokens each, with every
   launch counter set to 0 just before (every engine run below starts the
   same way); ``fused_lutmu`` must launch 120 times per forward call,
   replays counted, and the ``ref`` path never; then a decode step's host
   time and device busy time (``torch.profiler``), where each
   ``fused_lutmu`` call must be one kernel launch, and the decode program
   replayed against its eager twin (``MD.paged_decode_step`` on a copy of
   the cache, the same inputs): host enqueue and wall ms, device ms from
   CUDA events and from the profiler;
6. unfused — the ``--amm-backend unfused`` path (encode + aggregate
   kernels) at full width, depth cut to 4 layers, 2 requests, whose
   streams must equal the same requests' through the plain ``ref`` path;
7. verify-kernel (runs after 3) — the verify-window kernel against its
   plain version at the full-width shape (B=4, W=5, n_kv=8, g=5, hd=128,
   page_size 16, rows of S=128 and S=4096; bf16, float32 and int8 KV)
   within ``VERIFY_TOL``; kernel, plain, bound and library (one
   ``scaled_dot_product_attention`` over the gathered view with the same
   boolean mask, float only) times;
8. verify-agree (after 5) — at full width, one ``paged_verify_step``
   ``fused`` (the kernel, 40 launches) against ``scan`` on copies of one
   cache: logits within ``LOGIT_TOL``, the argmax equal wherever the top-2
   margin exceeds it;
9. spec — speculative serve at full width and depth, bf16, ``spec_k=4``,
   identical draft, 6 requests × 16 tokens: with ``verify_backend="scan"``
   the streams equal phase 5's and acceptance is exactly 1.0; then with
   ``fused``, counts set to 0 just before, the verify kernel launches 40
   times per round and the plain version never on CUDA; tok/s, TTFT,
   acceptance and peak memory.  A fused stream that differs from the
   plain engine's is reported with its first differing position and the
   plain path's top-2 margin there, and fails only if that margin exceeds
   ``STREAM_MARGIN_TOL``;
10. spec-4layer (after 6) — depth cut to 4 layers, a garbage draft (other
    LUT tables, same backbone) through rejection and rollback, on bf16 KV
    and on the int8 KV cache, held to the plain engine's streams by the
    same rule;
11. artifact — full width, depth cut to ``ART_LAYERS``: seeded int8 target
    tables and their int4 draft written as a bundle with ``save_bundle``;
    its target half served from disk (``load_engine(dir, ...,
    speculative=False)``) gives the streams of the same tables spliced in
    memory, with ``fused_lutmu`` at 3 × layers launches per forward and the
    ``ref`` path never; write and load seconds;
12. bundle — ``load_engine(dir, ...)`` serves the bundle speculatively
    (``fused`` verify, one launch per layer per round), held to the target
    half's streams by the ``STREAM_MARGIN_TOL`` rule; acceptance, tok/s,
    TTFT, peak memory;
13. chain — the paper's SFC MLP (784 → 256 → 256 → 256 → 10, d_sub 8,
    depth 4, pruned hand-off, ReLU) as an ``amm_chain`` artifact at int16
    and int8, written with ``save_artifact`` and loaded with
    ``AMMChain.load``, run at batch 256 on ``auto`` (int16 also
    ``unfused``): every layer bit-equal, on the chain's own inputs, to the
    same layer with ``backend="ref"``;
14. graphs (after 5) — the graph gate at the serve configuration: every
    call of a live engine's decode and prefill programs (3 or more
    consecutive decode steps; a chunk at start 32 with 8 of 32 valid), then
    of the speculative engine's greedy round and prefill pair on ``fused`` and
    on ``scan``, bit-equal to its model function called eagerly on a copy
    of the caches: outputs, and every KV page but the trash page; then
    sampled requests through the same engines: every sampler replay bit-
    equal to ``sample_tokens`` on the same logits, every sampled round's
    replay to ``sampled_round`` (``accepted``, ``emit`` up to ``accepted +
    1``, both caches);
15. threefry (after 2) — ``sampling.stream_key``/``stream_uniform`` on the
    card bit-equal to the same functions on the CPU for 4,096 (seed, t,
    role) triples;
16. sampled (after 5) — the serve of phase 5 at T 0.8, top-k 50, top-p
    0.95 (request ``i`` seeded 1000 + i): two runs on fresh engines give
    the same streams, request 3 alone gives its stream in the batch, tok/s
    beside phase 5's greedy tok/s; the sampler program's device ms per
    replay (CUDA events, profiler) against a sampled decode step's device
    busy time;
17. spec-sampled (after 9) — the same sampled requests through the
    speculative engine with an identical draft: on ``scan`` (p = q
    bitwise) acceptance at least ``MIN_SAMPLED_ACCEPTANCE``; on ``fused``
    acceptance printed, 40 verify launches per round; the ``round``
    program's capture seconds and graph nodes; one sampled round replayed
    alone against the greedy round at the same inputs (device ms);
18. observed — (after 16) phase 5's serve with the recorder off, then on
    (a tracing ``Recorder``, ``KernelProfiler(every=4)``, the dispatch
    hook) in one call: the same streams, tok/s and host ms per
    ``engine.step()``, the profiled ``serve.decode`` p50 beside the profile
    phase's device ms; phase 16's sampled requests through the observed
    engine give phase 16's streams; both exports validate, the trace has a
    kernels lane, ``serve_generated_tokens_total`` is the tokens emitted,
    each program built once.  Then ``AsyncServer`` on ``127.0.0.1:0`` over
    that engine: 4 concurrent streaming clients get phase 5's streams,
    ``/metrics`` validates, ``/slo`` and ``/healthz`` answer, a client that
    disconnects is cancelled; served tok/s.  (After 9) the fused
    speculative serve observed: ``spec_rounds_total``, proposed and
    accepted equal ``stats`` and ``acceptance_rate``.  (After 6) the
    4-layer unfused serve with a quality probe at rate 1.0 and dense bf16
    reference weights: the probe-off streams, no probe errors, rel-error
    histograms for gate, up and down.

19. compile (after 13) — the offline compiler on the card: qwen3-14b at
    full width, depth cut to ``ART_LAYERS`` (a 40-layer float32 model
    leaves no room for the fit's workspace), float32 dense params from a
    seeded generator on the card, ``compile_lm_bundle`` (int8 target, int4
    draft) from ``TokenStream`` tokens ``CALIB_BATCH`` × ``CALIB_SEQ``,
    written to a temporary directory: seconds per layer by stage (capture,
    trees, up and down prototype solves, LUT build, quantize, write), peak
    memory, both halves' LUT bytes and ``draft_vs_target_stored``.  The
    fitted target's MLP output on the calibration activations is closer to
    the dense MLP's than random int8 tables' (relative errors printed,
    also on held-out tokens); the
    target half served from disk through the kernels gives the streams of
    the plain ``ref`` path called eagerly; the bundle served speculatively
    (``fused`` verify) is held to them by the ``STREAM_MARGIN_TOL`` rule,
    its acceptance printed.  Then one AMM-MLP layer fit at reduced width on
    the card and on the CPU with the same code (``fit_card_vs_cpu``):
    split dims and thresholds equal except near-ties (printed), prototypes
    within ``PROTO_TOL``, int8 codes equal but for a printed count of ±1
    steps;
20. compile-chain — ``compile_chain`` of the SFC MLP (784 → 256 → 256 →
    256 → 10, d_sub 8, depth 4, pruned, ReLU) from seeded dense weights and
    synthetic calibration rows, int8, ``autotune=True``: reloaded from
    disk, every layer carries its measured plan and is bit-equal to
    ``backend="ref"``;
21. autotune — ``fused_lutmu`` cluster sizes measured at the gate/up and
    down decode and prefill shapes (int8) and ``verify_window`` split
    counts at S = 128 and 4096 (bf16 KV) into a temporary cache, re-read
    from disk; each measured plan's output bit-equal to the heuristic's
    (int8) or within ``VERIFY_TOL`` (bf16); the measured plan's ms beside
    the heuristic's.  Every phase before 20 reads an empty cache of its
    own (``REPRO_AUTOTUNE_CACHE``), so every launch on the serve path is
    the one its wrapper plans;
22. case-mlp — the paper's SFC MLP (784 → 256 → 256 → 256 → 10) trained
    on synthetic MNIST on the card, ``mlp_to_amm`` at int8 and float32,
    the float32 chain retrained by ``retrain_chain`` (one encode launch per
    stage, one aggregate launch per step); exact, chain and retrained
    accuracies; layer by layer against ``backend="ref"``: int8 bit-equal,
    retrained within ``FLOAT_RTOL``/``FLOAT_ATOL``; the int8 forward's
    ``fused_lutmu`` launches (one per layer) and ms;
23. case-resnet9 — ResNet-9 at (64, 128, 256, 512) on synthetic CIFAR, 150
    SGD steps; Kn2col LUT-MUs for conv1 … res2b (63 taps) and Im2col for
    res1a/res1b; one forward of 256 images through the kernels: 63
    ``fused_lutmu`` launches (conv1's taps are 262,144 rows each), no
    ``ref`` call on CUDA; each substituted conv on the same input within
    the float tolerance of ``backend="ref"``; accuracies, LUT bytes Kn2col
    vs Im2col, ms per forward; conv1's tap 0 at int8 through ``unfused``
    at B = 262,144, bit-equal to ``ref``;
24. train — qwen3-14b at full width, depth cut to 2 layers, bf16 compute,
    ``grad_accum`` 2, 4 × 128 ``TokenStream`` tokens, 3 steps of
    ``make_train_step``: ms per step, tokens/s, peak memory, losses; then
    ``Trainer.run`` at reduced width under deterministic algorithms,
    checkpoints every 5 steps, one injected failure: one recovery, losses
    bitwise equal to an uninjected run's, the last checkpoint restored by
    ``restore_into`` equal to the live state.

The line before the last is ``{"kernels": [...]}`` (the ``fused_lutmu``
and ``verify_window`` entries also carry the heuristic and measured plans
and their ms at their reported case; the LUT-MU entries their ResNet-9
cases and launches in phases 22-23), the last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repo's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                # H100 SXM device memory
PEAK_OPS = {"int8": 1979e12,             # tensor-core dense rates
            "bfloat16": 989e12,
            "float32": 67e12,            # float32 outside the tensor cores
            "int16": 67e12}              # int16 tables: float32 sums on the
                                         # CUDA cores (no int16 tensor core)
ADD_OPS_PER_S = 67e12                    # gather-sum adds on the CUDA cores
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-3      # float32 sums of ≤ 2176 terms, in
                                         # another order, then ×≤0.02 scale
DEPTH = 4
# (C, N): qwen3-14b's projections, and layer 0 of the SFC chain
# (784 → 256 pruned to the next layer's 4 · 32 split dims)
SHAPES = {"gate_up": (640, 8704), "down": (2176, 5120), "chain": (98, 128),
          # ResNet-9 at widths (64, 128, 256, 512), 256 images: a Kn2col tap
          # of conv1 (d_sub 8) and of res2a, and the Im2col res1a (C = cin)
          "kn2col_conv1": (8, 128), "kn2col_res2a": (64, 512),
          "im2col_res1a": (128, 128)}
CASES = [("gate_up", 4, "int8"), ("down", 4, "int8"),
         ("gate_up", 32, "int8"), ("down", 32, "int8"),
         ("gate_up", 4, "float32"), ("down", 32, "bfloat16"),
         ("gate_up", 4, "int16"), ("chain", 256, "int16"),
         ("kn2col_conv1", 262_144, "float32"), ("kn2col_conv1", 262_144, "int8"),
         ("kn2col_res2a", 4096, "float32"), ("im2col_res1a", 65_536, "float32")]
CNN_PROJ = ("kn2col_conv1", "kn2col_res2a", "im2col_res1a")
JSON_CASE = ("down", 4, "int8")          # the case each kernel's JSON entry reports
INT16_JSON_CASE = ("chain", 256, "int16")  # ... and each int16 instance's
# the SFC MLP of the paper's case study (src/repro/models/cnn.py): widths,
# codebook length, tree depth, batch
CHAIN_WIDTHS = (784, 256, 256, 256, 10)
CHAIN_D_SUB, CHAIN_DEPTH, CHAIN_BATCH = 8, 4, 256
# depth of the artifact phase's qwen3-14b (the writer is
# np.savez_compressed, as the JAX package's: tens of MB/s on random tables)
ART_LAYERS = 2
VERIFY_SHAPE = (4, 5, 8, 5, 128, 16)     # B, W=k+1, n_kv, g, hd, page_size
VERIFY_S = (128, 4096)                   # cache positions of a row's table
VERIFY_JSON_CASE = ("bfloat16", 128)     # the serve path's verify call
# verify window against its plain version, max abs error (as
# tests/test_torch_cuda_kernels): float32 — sums in another order, expf:
# atol 1e-5 + rtol 1e-5 on outputs ≤ 4;
# bfloat16 — a weight one ulp apart may round to the neighbouring bfloat16
# before the value product (2**-8 relative); int8 — exact integer sums, a
# weight may round to the neighbouring int8 step (≤ 0.05 per weight, two
# allowed), and ≥ 99 % of the outputs bit-equal
VERIFY_TOL = {"float32": 5e-5, "bfloat16": 2e-2, "int8": 2 * 0.05}
INT8_MIN_EQUAL_SHARE = 0.99
# logits of the full-width model (bf16 head: ulp 2**-6 at |x| ≈ 4) through
# the verify kernel against the scan oracle, one step from one cache: a few
# bf16 ulps
LOGIT_TOL = 0.25
# a speculative stream through the kernel against the plain engine's: the
# kernel's float sums differ from the oracle's in the last bits, which can
# move a bf16 rounding of an attention output; the LUT-MU MLP's tree encode
# turns such a difference into another LUT row (ROADMAP C2), and the K/V
# written from it feed every later step, so once streams drift the logits
# move by far more than one step's error.  A first difference is accepted
# where the plain top-2 margin is at most this; a faulty kernel diverges at
# margins well above it
STREAM_MARGIN_TOL = 1.0
SPEC_K = 4
# the sampled phases' requests
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# an identical draft's sampled acceptance on the scan oracle, where the
# verify step's logits are bitwise the draft's decode logits (p = q): a
# proposal is rejected only when its uniform rounds to 1
MIN_SAMPLED_ACCEPTANCE = 0.9
THREEFRY_TRIPLES = 4096
DEVICE = "cuda"  # where the engines serve
# the compile phase's calibration tokens (the compiler CLI's defaults)
CALIB_BATCH, CALIB_SEQ = 8, 32
# the reduced-width fit, card against CPU: rows; a pick whose two best
# losses lie within NEAR_TIE relative may resolve either way under the
# other device's rounding; prototypes within PROTO_TOL (float64 sums and
# solves in another order, rounded to float32)
FIT_ROWS = 256
NEAR_TIE = 1e-12
PROTO_TOL = dict(rtol=1e-5, atol=1e-6)
# calibration rows of the SFC chain compile
CHAIN_CALIB = 1024


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


def device_ms(torch, fn, names, iters: int, flush) -> float:
    """The device time per call of the kernels whose names contain one of
    ``names`` (``torch.profiler``), L2 flushed before each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(n in e.key for n in names))
    return total / 1e3 / iters


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_checks(torch, timer, mods):
    FL, ME, LA, ref = mods
    dt = {"int8": torch.int8, "int16": torch.int16, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    g = 2**DEPTH
    results = {"fused_lutmu": {}, "encode_onehot": {},
               "encode_onehot_int8": {}, "lut_aggregate": {}}
    tiny = torch.zeros(1, device="cuda")
    timer.ms(tiny.zero_, 20)  # the process's first timed calls read high
    floor_ms = timer.ms(tiny.zero_, 20)  # what any launch costs here
    print(f"[kernel] launch floor (zero_ of 4 bytes) {floor_ms:.4f} ms",
          flush=True)
    for proj, b, lut_name in CASES:
        c, n = SHAPES[proj]
        lut_dtype = dt[lut_name]
        x = torch.randn((b, c, DEPTH), generator=gen, device="cuda")
        thr = torch.randn((c, g - 1), generator=gen, device="cuda")
        if lut_dtype == torch.int8:
            lut = torch.randint(-128, 128, (c, g, n), generator=gen,
                                dtype=torch.int8, device="cuda")
        elif lut_dtype == torch.int16:
            lut = torch.randint(-2**15, 2**15, (c, g, n), generator=gen,
                                dtype=torch.int16, device="cuda")
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
        exact = lut_dtype in (torch.int8, torch.int16)
        if lut_dtype == torch.int16:
            # the plain version sums int16 entries in float32: exact in any
            # order while every row's sum of |entries| stays below 2**24
            # (any table at C ≤ 512; this run's data at C = 640)
            ar = torch.arange(c, device="cuda")
            absum = lut[ar[None, :], codes].float().abs().sum(dim=1).max().item()
            ensure(absum < 2**24, f"int16 case {proj} B={b}: sums of "
                   f"{absum} reach 2**24, the plain version rounds")

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
        # kernel 2: encode to a one-hot, float32 out (float and int16
        # tables on the unfused path) and int8 out (int8 tables)
        outs = ("float32", "int8") if lut_dtype == torch.int8 else ("float32",)
        for out_name in outs:
            od = dt[out_name]
            want = (onehot if od == torch.float32
                    else ME.encode_onehot_plain(x, thr, od))
            enc = lambda od=od: ME.encode_onehot(x, thr, out_dtype=od)  # noqa: E731
            err = compare(f"encode_onehot {out_name}", enc(), want, True)
            nbytes = (x.numel() * 4 + thr.numel() * 4
                      + want.numel() * want.element_size())
            bms, by = bound_ms(nbytes, b * c * (g - 1), ADD_OPS_PER_S)
            res = "encode_onehot" if out_name == "float32" else "encode_onehot_int8"
            results[res][key] = dict(
                max_abs_err=err, ms=timer.ms(enc, 20),
                plain_ms=timer.ms(lambda od=od: ME.encode_onehot_plain(x, thr, od), 3),
                bound_ms=bms, bound_by=by, library_ms=None, floor_ms=floor_ms,
                device_ms=device_ms(torch, enc, ["encode_onehot"], 20, timer.flush))
            del want
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
            r = results[name].get(key)
            if r is None:
                continue
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            extra = (f" floor_ms={r['floor_ms']:.4f} device_ms="
                     f"{r['device_ms']:.4f}" if "floor_ms" in r else "")
            print(f"[kernel] {name:13s} {proj:7s} B={b:<2d} {lut_name:8s} "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
                  f"library_ms={lib} max_abs_err={r['max_abs_err']:.3g}"
                  + extra, flush=True)
        del x, thr, lut, onehot, lhs_f32, rhs_f32, codes
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 7: the verify-window kernel against its plain version
# ---------------------------------------------------------------------------


def verify_inputs(torch, s_len: int, kv_name: str, gen):
    """Full-width verify-window inputs: B=4 rows whose windows end near the
    end of an S-position table, pages in random order."""
    b, w, nkv, g, hd, ps = VERIFY_SHAPE
    mp = s_len // ps
    n_pages = b * mp + 1
    shape = (n_pages, ps, nkv, hd)
    if kv_name == "int8":
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
    else:
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[kv_name]
        kp = torch.randn(shape, generator=gen, device="cuda").to(dt)
        vp = torch.randn(shape, generator=gen, device="cuda").to(dt)
    pt = torch.randperm(b * mp, generator=gen, device="cuda").to(
        torch.int32).reshape(b, mp)
    pos = torch.tensor([max(0, s_len - w - d) for d in (0, 3, 9, 17)],
                       dtype=torch.int32, device="cuda")
    q = torch.randn((b, w, nkv, g, hd), generator=gen, device="cuda") * 2.0
    return q, kp, vp, pt, pos


def verify_kernel_checks(torch, timer, FV):
    """``verify_window_attend_cuda`` against its plain version at the
    full-width shapes (global window, as qwen3-14b's layers); kernel,
    plain, bound and library (one ``scaled_dot_product_attention`` over
    the pre-gathered view with the same boolean mask, float caches only)
    times."""
    import torch.nn.functional as F
    b, w, nkv, g, hd, ps = VERIFY_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for s_len in VERIFY_S:
        for kv_name in ("bfloat16", "float32", "int8"):
            q, kp, vp, pt, pos = verify_inputs(torch, s_len, kv_name, gen)
            args = (q, kp, vp, pt, pos, None)
            got = FV.verify_window_attend_cuda(*args)
            want = FV.verify_window_attend_plain(*args)
            torch.cuda.synchronize()
            ensure(bool(torch.isfinite(got).all()), f"verify {kv_name}: non-finite")
            err = (got - want).abs().max().item()
            tol = VERIFY_TOL[kv_name]
            ensure(err <= tol, f"verify_window {kv_name} S={s_len}: max abs "
                   f"err {err} > {tol}")
            share = (got == want).float().mean().item()
            if kv_name == "int8":
                ensure(share >= INT8_MIN_EQUAL_SHARE,
                       f"verify_window int8 S={s_len}: only {share:.4f} of the "
                       "outputs bit-equal")
            reach = [FV.reach(int(p), w, FV.GLOBAL_WINDOW, s_len)
                     for p in pos.tolist()]
            positions = sum(hi - lo for lo, hi in reach)
            item = kp.element_size()
            nbytes = (2 * positions * nkv * hd * item + 2 * q.numel() * 4
                      + pt.numel() * 4 + pos.numel() * 4)
            ops = 2 * 2 * w * g * hd * positions * nkv
            bms, by = bound_ms(nbytes, ops, PEAK_OPS[kv_name])
            library_ms = None
            if kv_name != "int8":
                k_view, v_view = FV.paged_view(kp, vp, pt)
                kq = k_view.permute(0, 2, 1, 3).contiguous()  # (B, nkv, S, hd)
                vq = v_view.permute(0, 2, 1, 3).contiguous()
                qq = q.permute(0, 2, 1, 3, 4).reshape(b, nkv, w * g, hd).to(kp.dtype)
                kv_pos = torch.arange(s_len, device="cuda")
                pj = (pos[:, None].long() + torch.arange(w, device="cuda")[None])
                mask = (kv_pos[None, None, :] <= pj[:, :, None])  # (B, W, S)
                mask = mask[:, :, None, :].expand(b, w, g, s_len).reshape(
                    b, 1, w * g, s_len)
                library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                    qq, kq, vq, attn_mask=mask), 20)
                del k_view, v_view, kq, vq, qq, mask
            r = dict(max_abs_err=err, equal_share=share,
                     ms=timer.ms(lambda: FV.verify_window_attend_cuda(*args), 20),
                     plain_ms=timer.ms(lambda: FV.verify_window_attend_plain(*args), 3),
                     bound_ms=bms, bound_by=by, library_ms=library_ms)
            results[(kv_name, s_len)] = r
            lib = "null" if library_ms is None else f"{library_ms:.4f}"
            print(f"[verify-kernel] B={b} W={w} n_kv={nkv} g={g} hd={hd} "
                  f"S={s_len:<4d} {kv_name:8s} kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={bms:.4f} ({by}) "
                  f"library_ms={lib} max_abs_err={err:.3g} "
                  f"bit_equal={share:.4f}", flush=True)
            del q, kp, vp, pt, pos, got, want
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


ENGINE_KNOBS = dict(max_batch=4, max_len=128, page_size=16, prefill_chunk=32)


def serve(torch, cfg, params, load_engine, n_requests: int, max_new: int,
          sampling=None):
    """Drive the engine; returns (requests, seconds, ttft list, engine)."""
    engine = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                         device=DEVICE, **ENGINE_KNOBS)
    return drive(torch, engine, cfg, n_requests, max_new, sampling)


def sampled(i: int):
    """Request ``i``'s sampling in the sampled phases."""
    from repro_torch.serving import SamplingParams
    return SamplingParams(seed=1000 + i, **SAMPLED)


def drive(torch, engine, cfg, n_requests: int, max_new: int, sampling=None,
          after_warm_up=None, step_ms=None):
    """One short request first, which captures ``engine``'s step programs;
    then, with its call counters, every launch count and the peak memory
    set to 0 (and ``after_warm_up()`` called), submit the CLI prompts and
    step until it drains.  Request ``i`` samples with ``sampling(i)`` where
    given, else greedily; the first request samples the same way with a
    seed no other uses.  ``step_ms``, a list, gets each ``engine.step()``'s
    host ms, whether a kernel profiler timed it and whether it ran a
    prefill chunk.  Returns (requests, seconds, ttft list, engine)."""
    from repro_torch.kernels import _build

    def params(i):
        return sampling(i) if sampling is not None else None

    engine.submit(prompts(cfg.vocab_size, 1)[0], params(n_requests),
                  max_new_tokens=2)
    engine.run_until_drained()
    if after_warm_up is not None:
        after_warm_up()
    prof = getattr(engine.obs, "profiler", None) if engine.obs else None
    for k, v in engine.stats.items():
        if isinstance(v, int):
            engine.stats[k] = 0
    reset_counts(_build.launch_counts())
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(p, params(i), max_new_tokens=max_new)
               for i, p in enumerate(prompts(cfg.vocab_size, n_requests))]
    ttft = {}
    while engine.has_work:
        t1, chunks = time.perf_counter(), engine.stats["prefill_calls"]
        engine.step()  # sampling pulls the tokens to the host: a sync
        now = time.perf_counter()
        if step_ms is not None:
            step_ms.append((1e3 * (now - t1),
                            prof is not None and prof.active,
                            engine.stats["prefill_calls"] > chunks))
        for h in handles:
            if h.generated and h.request_id not in ttft:
                ttft[h.request_id] = now - t0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return handles, dt, [ttft[h.request_id] for h in handles], engine


def eager_streams(torch, MD, params, cfg, reqs, max_new: int):
    """Greedy streams of ``reqs``, each request alone through the model
    functions called eagerly, at the engine's shapes (ENGINE_KNOBS): prompt
    chunks of ``prefill_chunk`` tokens, then decode steps of ``max_batch``
    rows, the other rows on the trash page.  A row's logits do not depend
    on the other rows, so these are the engine's streams.  The ``ref``
    LUT-MU path takes this way on the card: its plain contraction reads
    ``nonzero`` on the host, which no captured program may."""
    ps, cs, mb = (ENGINE_KNOBS["page_size"], ENGINE_KNOBS["prefill_chunk"],
                  ENGINE_KNOBS["max_batch"])
    mp = -(-ENGINE_KNOBS["max_len"] // ps)
    dev, cd = "cuda", torch.bfloat16
    out = []
    for prompt in reqs:
        cache = MD.init_paged_cache(cfg, mp + 1, ps, cd, dev)
        table = torch.full((mb, mp), mp, dtype=torch.int32, device=dev)
        table[0] = torch.arange(mp, dtype=torch.int32, device=dev)
        for start in range(0, len(prompt), cs):
            chunk = prompt[start:start + cs]
            toks = torch.tensor([chunk + [0] * (cs - len(chunk))],
                                dtype=torch.int32, device=dev)
            logits = MD.paged_prefill_chunk(params, toks, start, len(chunk),
                                            table[0], cache, cfg,
                                            compute_dtype=cd)
        gen = [int(logits[0, -1].argmax())]
        while len(gen) < max_new:
            token = torch.zeros((mb, 1), dtype=torch.int32, device=dev)
            token[0, 0] = gen[-1]
            pos = torch.zeros((mb,), dtype=torch.int32, device=dev)
            pos[0] = len(prompt) + len(gen) - 1
            logits = MD.paged_decode_step(params, token, pos, table, cache,
                                          cfg, compute_dtype=cd)
            gen.append(int(logits[0, 0].argmax()))
        out.append(gen)
    return out


def plain_margin(torch, make_plain, prompt, at: int) -> float:
    """The plain engine's top-2 logit margin at generated position ``at``
    of ``prompt``'s greedy stream (the request served alone).  The logits
    are a program's static output, rewritten by its next replay: copied."""
    seen = []
    eng = make_plain()
    orig = eng._sample

    def spy(logits, rows_reqs, program):
        seen.append(logits[rows_reqs[0][0]].clone())
        return orig(logits, rows_reqs, program)

    eng._sample = spy
    eng.submit(prompt, max_new_tokens=at + 1)
    eng.run_until_drained()
    top = torch.topk(seen[at], 2).values
    return (top[0] - top[1]).item()


def compare_streams(torch, label, handles, want, make_plain) -> int:
    """Speculative streams through the verify kernel against the plain
    engine's: a stream that differs is reported with its first differing
    position and the plain path's top-2 margin there, and fails only when
    that margin exceeds STREAM_MARGIN_TOL (the kernel's float path is
    allclose to the oracle, not bitwise).  Returns the number of differing
    streams."""
    differ = 0
    for h, ref_stream in zip(handles, want):
        if h.generated == ref_stream:
            continue
        differ += 1
        at = next(i for i, (a, b) in enumerate(zip(h.generated, ref_stream))
                  if a != b)
        margin = plain_margin(torch, make_plain, h.prompt, at)
        print(f"[{label}] req {h.request_id}: first difference at generated "
              f"position {at} ({h.generated[at]} vs plain {ref_stream[at]}); "
              f"plain top-2 margin {margin:.4f} (tolerance "
              f"{STREAM_MARGIN_TOL})", flush=True)
        ensure(margin <= STREAM_MARGIN_TOL,
               f"{label}: req {h.request_id} differs at {at} where the plain "
               f"margin {margin} exceeds {STREAM_MARGIN_TOL}")
    return differ


def verify_agree_phase(torch, cfg, params, MD, FV):
    """At full width, one ``paged_verify_step`` through the verify kernel
    (``fused``) against the ``scan`` oracle on copies of one prefilled
    cache: logits within LOGIT_TOL, the argmax equal wherever the oracle's
    top-2 margin exceeds it, and layer 0's K/V pages bit-equal (the
    projections run at the oracle's shapes)."""
    ps, mp, w = 16, 8, SPEC_K + 1
    cache = MD.init_paged_cache(cfg, 2 * mp + 1, ps, torch.bfloat16, "cuda")
    rows = torch.arange(2 * mp, dtype=torch.int32, device="cuda").reshape(2, mp)
    pos = []
    for i, p in enumerate(prompts(cfg.vocab_size, 2)):
        toks = torch.tensor([p + [0] * (32 - len(p))], dtype=torch.int32,
                            device="cuda")
        MD.paged_prefill_chunk(params, toks, 0, len(p), rows[i], cache, cfg,
                               compute_dtype=torch.bfloat16)
        pos.append(len(p))
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, w), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    n_valid = torch.tensor([w, w - 2], dtype=torch.int32, device="cuda")
    out = {}
    for backend in ("scan", "fused"):
        c = {k: v.clone() for k, v in cache.items()}
        before = FV.LAUNCHES.n
        logits = MD.paged_verify_step(params, tokens, pos_t, n_valid, rows, c,
                                      cfg, compute_dtype=torch.bfloat16,
                                      backend=backend)
        torch.cuda.synchronize()
        out[backend] = (logits, c, FV.LAUNCHES.n - before)
    (ls, cs, ns), (lf, cf, nf) = out["scan"], out["fused"]
    ensure(ns == 0 and nf == cfg.num_layers,
           f"verify kernel launches: scan {ns}, fused {nf}")
    err, flips, checked = 0.0, 0, 0
    for i, nv in enumerate(n_valid.tolist()):
        a, b = ls[i, :nv], lf[i, :nv]
        ensure(bool(torch.isfinite(b).all()), "fused verify: non-finite logits")
        err = max(err, (a - b).abs().max().item())
        top = torch.topk(a, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > LOGIT_TOL
        checked += int(sure.sum())
        flips += int((a.argmax(-1) != b.argmax(-1))[sure].sum())
    ensure(err <= LOGIT_TOL, f"fused verify logits off by {err} > {LOGIT_TOL}")
    ensure(flips == 0, f"{flips} argmax flips where the margin exceeds the "
           "tolerance")
    for name in ("k", "v"):
        ensure(torch.equal(cs[name][0, :-1], cf[name][0, :-1]),
               f"layer-0 {name} pages differ between scan and fused")
    print(f"[verify-agree] full-width paged_verify_step (W={w}, "
          f"{cfg.num_layers} layers): fused (kernel, {nf} launches) vs scan "
          f"max abs logit diff {err:.4g} (tolerance {LOGIT_TOL}); argmax "
          f"equal at all {checked} positions with margin > tolerance; layer-0 "
          "pages bit-equal", flush=True)
    del cache, out


def spec_serve(torch, cfg, params, draft_params, SpeculativeEngine, backend,
               n_requests, max_new, sampling=None):
    engine = SpeculativeEngine(params, cfg, draft_params, spec_k=SPEC_K,
                               verify_backend=backend,
                               compute_dtype=torch.bfloat16, device="cuda",
                               **ENGINE_KNOBS)
    return drive(torch, engine, cfg, n_requests, max_new, sampling)


def spec_line(label, handles, dt, ttft, engine, peak) -> str:
    n_tok = sum(len(h.generated) for h in handles)
    return (f"[{label}] {len(handles)} requests: {n_tok} tokens in {dt:.3f}s "
            f"= {n_tok / dt:.2f} tok/s; TTFT mean {sum(ttft) / len(ttft):.4f}s "
            f"max {max(ttft):.4f}s; rounds {engine.stats['decode_calls']}; "
            f"acceptance {engine.acceptance_rate:.4f}; emitted/round "
            f"{engine.mean_emitted_per_round:.3f}; stats {engine.stats}; "
            f"peak memory {peak / 1e9:.2f} GB")


def kernel_busy_ms(torch, prof, steps: int):
    """Device kernel time per step from a ``torch.profiler`` run, and the
    kernel events (none when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in kernels) / 1e3 / steps, kernels


def profile_phase(torch, cfg, params, MD, load_engine, steps: int = 6):
    """Where a decode step's time goes (4 rows decoding): the engine's step
    on the host clock (scheduler, staging, one replay, sampling); the
    decode program alone, replayed with one step's inputs, against the
    eager twin (``MD.paged_decode_step`` on a copy of the cache, the same
    inputs): host enqueue and wall ms per call, device ms per call from
    ``torch.profiler`` kernel time and from CUDA events around the call;
    then device busy per engine step and the idle share.  Replaying one
    step's inputs rewrites the same K/V at the same position, so the
    engine's state does not move."""
    from torch.profiler import ProfilerActivity, profile

    engine = load_engine(None, params, cfg, max_batch=4, max_len=128,
                         page_size=16, prefill_chunk=32,
                         compute_dtype=torch.bfloat16, device="cuda")
    for p in prompts(cfg.vocab_size, 4):
        engine.submit(p, max_new_tokens=4 + 3 * steps + 2)
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
    busy, kernels = kernel_busy_ms(torch, prof, steps)

    prog, seen = engine._decode, []
    engine._decode = lambda **a: seen.append(a) or prog(**a)
    engine.step()
    engine._decode = prog
    arrays = seen[0]
    dev_in = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    twin_cache = {n: b.clone() for n, b in engine.kv.buffers.items()}

    def replay():
        return prog(**arrays)

    def eager():
        return MD.paged_decode_step(params, dev_in["token"], dev_in["pos"],
                                    dev_in["table"], twin_cache, cfg,
                                    compute_dtype=torch.bfloat16)

    times = {}
    for name, fn in (("replay", replay), ("eager", eager)):
        fn()
        torch.cuda.synchronize()
        enq, walls, events = [], [], []
        for _ in range(steps):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            s.record()
            fn()
            e.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq.append(t1 - t0)
            walls.append(time.perf_counter() - t0)
            events.append(s.elapsed_time(e))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p2:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        dev, _ = kernel_busy_ms(torch, p2, steps)
        times[name] = dict(enqueue=1e3 * sum(enq) / steps,
                           wall=1e3 * sum(walls) / steps,
                           events=sum(events) / steps, profiler=dev)
    same = torch.equal(replay()[:, 0], eager()[:, 0])
    ensure(same, "decode replay logits != eager twin's from the same state")
    for name, t in times.items():
        label = ("decode program replayed" if name == "replay" else
                 "eager twin (MD.paged_decode_step)")
        prof_s = ("not measured (the profiler saw no kernels)"
                  if t["profiler"] == 0 else f"{t['profiler']:.2f} ms")
        print(f"[profile] {label}: host enqueue {t['enqueue']:.3f} ms, wall "
              f"{t['wall']:.3f} ms per call; device {t['events']:.3f} ms (CUDA"
              f" events around the call), kernel time {prof_s} (profiler)",
              flush=True)
    source = "profiler kernel time"
    if not kernels:  # the profiler saw nothing inside the graph
        busy, source = times["replay"]["events"], "CUDA events around the replay"
    print(f"[profile] decode step (4 rows, {cfg.num_layers} layers, engine."
          f"step()): {wall * 1e3:.2f} ms/step host clock unprofiled; device "
          f"busy {busy:.2f} ms/step ({source}) = {100 * busy / (wall * 1e3):.1f}%"
          f" (idle {100 - 100 * busy / (wall * 1e3):.1f}%); eager twin idle "
          f"{100 - 100 * times['eager']['profiler'] / times['eager']['wall']:.1f}"
          f"% of its wall; graph nodes {engine.stats['graph_nodes']}",
          flush=True)
    out = {"step_host_ms": wall * 1e3,
           "replay_events_ms": times["replay"]["events"],
           "replay_profiler_ms": times["replay"]["profiler"]}
    if not kernels:
        return out
    lutmu = [e for e in kernels if "fused_lutmu" in e.key]
    print(f"[profile] fused_lutmu: "
          f"{sum(e.self_device_time_total for e in lutmu) / 1e3 / steps:.3f} "
          f"ms/step over {sum(e.count for e in lutmu) / steps:.0f} launches",
          flush=True)
    # each fused_lutmu call is one launch: no second partial-sum pass
    ensure(not any("reduce_epilogue" in e.key for e in kernels),
           "a partial-sum pass ran on the decode path")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"x{e.count / steps:6.0f}  {e.key[:90]}")
    return out


# ---------------------------------------------------------------------------
# phases 15-17: seeded sampling
# ---------------------------------------------------------------------------


def threefry_phase(torch, S):
    """The threefry streams on the card against the same function on the
    CPU: THREEFRY_TRIPLES (seed, t, role) triples, the edge seeds among
    them, key words and uniforms bit for bit."""
    import numpy as np
    rng = np.random.default_rng(15)
    n = THREEFRY_TRIPLES
    seed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    seed[:4] = (0, 1, 2**31, 2**32 - 1)
    t = rng.integers(0, 2**31, n).astype(np.int32)
    t[: n // 2] %= 4096
    role = rng.integers(0, 4, n).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        args = [torch.from_numpy(a).to(dev)
                for a in (seed.view(np.int32), t, role)]
        out[dev] = (S.stream_key(*args).cpu(),
                    S.stream_uniform(*args).cpu().view(torch.int32))
    ensure(torch.equal(out["cpu"][0], out["cuda"][0]),
           "threefry key words: card != CPU")
    ensure(torch.equal(out["cpu"][1], out["cuda"][1]),
           "threefry uniforms: card != CPU")
    print(f"[sampled] threefry: {n} (seed, t, role) triples, key words and "
          "uniforms on the card bit-equal to the CPU's", flush=True)


def sampler_device_ms(torch, fn, steps: int = 20):
    """Device ms per call of ``fn``: CUDA events over ``steps`` calls, and
    the profiler's kernel time (0 when it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(steps):
        fn()
    e.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    busy, _ = kernel_busy_ms(torch, prof, steps)
    return s.elapsed_time(e) / steps, busy


def sampled_serve_phase(torch, cfg, params, load_engine, counters, S,
                        greedy_tok_s: float, steps: int = 6):
    """40-layer sampled serve (6 requests × 16 tokens, SAMPLED): two runs
    on fresh engines give the same streams, and request 3 alone gives its
    stream in the batch; tok/s beside the greedy serve's; then the
    sampler's device time per decode step (its program replayed alone)
    against the step's device busy time (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_lutmu as FL
    runs = []
    for _ in range(2):
        reset_counts(counters)
        h, dt, ttft, eng = serve(torch, cfg, params, load_engine, 6, 16,
                                 sampled)
        calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
        ensure(FL.LAUNCHES.n == 3 * cfg.num_layers * calls,
               f"sampled serve: fused_lutmu launches {FL.LAUNCHES.n} for "
               f"{calls} calls")
        ensure(all(x.done and len(x.generated) == 16
                   and all(0 <= t < cfg.vocab_size for t in x.generated)
                   for x in h), "sampled requests did not finish")
        runs.append(([list(x.generated) for x in h], dt, ttft, eng.stats))
        del eng
    (streams, dt, ttft, stats), (again, dt2, _, _) = runs
    ensure(again == streams, "sampled serve: a second run gave other streams")
    # greedy once more after the sampled runs: greedy, sampled, sampled,
    # greedy in one process
    gh, gdt, _, geng = serve(torch, cfg, params, load_engine, 6, 16)
    greedy_after = sum(len(x.generated) for x in gh) / gdt
    del geng, gh
    alone = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                        device="cuda", **ENGINE_KNOBS)
    r = alone.submit(prompts(cfg.vocab_size, 6)[3], sampled(3),
                     max_new_tokens=16)
    alone.run_until_drained()
    ensure(r.generated == streams[3],
           "sampled serve: request 3 alone gave another stream")
    ensure(len({tuple(x) for x in streams}) == len(streams),
           "sampled serve: two requests gave the same stream")
    n_tok = sum(map(len, streams))
    print(f"[sampled] serve (T {SAMPLED['temperature']}, top-k "
          f"{SAMPLED['top_k']}, top-p {SAMPLED['top_p']}, seeds 1000-1005), 6 "
          f"requests x 16 tokens: {n_tok / dt:.2f} / {n_tok / dt2:.2f} tok/s "
          f"(two runs) against greedy {greedy_tok_s:.2f} / "
          f"{greedy_after:.2f} tok/s (phase 5, and after the sampled runs);"
          f" TTFT mean {sum(ttft) / len(ttft):.4f}s; streams equal in both "
          f"runs, request 3 alone equal to its stream in the batch; "
          f"capture_s {fmt(stats['capture_s'])}; graph nodes "
          f"{stats['graph_nodes']}", flush=True)
    del alone
    # the sampler's share of a decode step: 4 sampled rows decoding
    eng = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                      device="cuda", **ENGINE_KNOBS)
    for i, p in enumerate(prompts(cfg.vocab_size, 4)):
        eng.submit(p, sampled(i), max_new_tokens=4 + 3 * steps + 2)
    for _ in range(4):
        eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    busy, _ = kernel_busy_ms(torch, prof, steps)
    prog, seen = eng._sample_decode, []
    eng._sample_decode = lambda **a: seen.append(a) or prog(**a)
    eng.step()
    eng._sample_decode = prog
    ev_ms, prof_ms = sampler_device_ms(torch, lambda: prog(**seen[0]))
    share = ("not measured (the profiler saw no kernels)" if not busy else
             f"{100 * prof_ms / busy:.1f}% of the step's {busy:.2f} ms")
    print(f"[sampled] sampler (sample_decode replay, 4 rows x "
          f"{cfg.vocab_size}): {ev_ms:.4f} device ms per replay (CUDA "
          f"events), kernel time {prof_ms:.4f} ms (profiler) = {share} "
          f"(profiler, sampled decode steps)", flush=True)
    del eng
    torch.cuda.empty_cache()
    return n_tok / dt, streams


def sampled_spec_phase(torch, cfg, params, SpeculativeEngine, FV, counters):
    """40-layer sampled speculative serve, identical draft, 6 × 16 tokens:
    on ``scan`` (p = q bitwise) acceptance at least MIN_SAMPLED_ACCEPTANCE;
    on ``fused`` (the verify kernel, 40 launches per round) acceptance
    printed; the round program's capture seconds and graph nodes; the
    round's device ms replayed alone against the greedy round's at the same
    inputs (the sampler's cost inside a round)."""
    out = {}
    for backend in ("scan", "fused"):
        reset_counts(counters)
        h, dt, ttft, eng = spec_serve(torch, cfg, params, params,
                                      SpeculativeEngine, backend, 6, 16,
                                      sampled)
        rounds = eng.stats["decode_calls"]
        ensure(all(x.done and len(x.generated) == 16 for x in h),
               f"sampled spec {backend}: requests did not finish")
        ensure(FV.LAUNCHES.n == (cfg.num_layers * rounds
                                 if backend == "fused" else 0)
               and FV.PLAIN_ON_CUDA.n == 0,
               f"sampled spec {backend}: verify launches {FV.LAUNCHES.n} "
               f"for {rounds} rounds")
        if backend == "scan":
            ensure(eng.acceptance_rate >= MIN_SAMPLED_ACCEPTANCE,
                   f"identical draft, sampled, scan: acceptance "
                   f"{eng.acceptance_rate} < {MIN_SAMPLED_ACCEPTANCE}")
        ensure(eng.stats["emitted"] == eng.stats["accepted"]
               + eng.stats["corrections"] + eng.stats["bonuses"],
               f"sampled spec {backend}: counters {eng.stats}")
        print(spec_line(f"spec-sampled-{backend}", h, dt, ttft, eng,
                        torch.cuda.max_memory_allocated())
              + f"; round capture {eng.stats['capture_s']['round']:.3f}s, "
              f"{eng.stats['graph_nodes']['round']} graph nodes", flush=True)
        out[backend] = eng
    # the round replayed alone, sampled against greedy, at one round's
    # inputs (a replay rewrites the same K/V at the same positions)
    eng = out["fused"]
    for i, p in enumerate(prompts(cfg.vocab_size, 4)):
        eng.submit(p, sampled(i), max_new_tokens=40)
    for _ in range(5):
        eng.step()
    prog, seen = eng._round, []
    eng._round = lambda **a: seen.append(a) or prog(**a)
    eng.step()
    eng._round = prog
    a = seen[0]
    greedy_in = {k: a[k] for k in ("token", "pos", "n_valid", "table")}
    eng._round_greedy(**greedy_in)  # captured here if not yet
    times = {"round": sampler_device_ms(torch, lambda: prog(**a), 5),
             "round_greedy": sampler_device_ms(
                 torch, lambda: eng._round_greedy(**greedy_in), 5)}
    print(f"[sampled] fused round replayed alone (4 rows, k {SPEC_K}): "
          f"sampled {times['round'][0]:.3f} / greedy "
          f"{times['round_greedy'][0]:.3f} device ms (CUDA events), kernel "
          f"time {times['round'][1]:.3f} / {times['round_greedy'][1]:.3f} ms"
          f" (profiler); graph nodes {eng.stats['graph_nodes']}", flush=True)
    del out, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: the graph gate — captured step programs against the eager
# model functions
# ---------------------------------------------------------------------------


def twin(torch, prog, eager, caches, keep, log):
    """Wrap the step program ``prog`` so that every call is checked as it
    happens: the outputs ``keep(arrays, outputs)`` picks and every KV page
    but the trash page (written in no fixed order by padding rows and
    masked window slots, read by nothing) must be bit-equal to
    ``eager(caches, **inputs)`` on copies of ``caches`` taken just before
    the call.  ``log`` gets one entry per call."""
    import numpy as np

    def call(**arrays):
        before = [{n: b.clone() for n, b in c.items()} for c in caches]
        out = prog(**arrays)
        got = keep(arrays, [o.clone() for o in (
            out if isinstance(out, tuple) else (out,))])
        want = eager(before, **{k: torch.from_numpy(
            np.asarray(v, np.int32)).cuda() for k, v in arrays.items()})
        want = keep(arrays, want if isinstance(want, tuple) else (want,))
        torch.cuda.synchronize()
        ensure(prog.graph is not None, f"{prog.name}: no graph captured")
        for g, w in zip(got, want):
            ensure(g.shape == w.shape and torch.equal(g, w),
                   f"{prog.name}: replayed outputs != eager (max diff "
                   f"{(g.float() - w.float()).abs().max().item()})")
        for c, b in zip(caches, before):
            for n in c:
                ensure(torch.equal(c[n][:, :-1], b[n][:, :-1]),
                       f"{prog.name}: replayed {n} pages != eager")
        log.append({k: np.asarray(v).copy() for k, v in arrays.items()})
        return out

    return call


def keep_rows(trash):
    """Decode logits of the rows that hold a request (the others read only
    the trash page)."""
    return lambda a, outs: [outs[0][(a["table"][:, 0] != trash).nonzero()[0]]]


def keep_round(a, outs):
    """``accepted`` of the rows in the round, and each one's ``target``
    window up to its ``n_valid`` (later slots read the trash page)."""
    accepted, target = outs
    rows = (a["n_valid"] > 0).nonzero()[0]
    return [accepted[rows]] + [target[r, :a["n_valid"][r]] for r in rows]


def keep_sampled_round(a, outs):
    """``accepted`` of the rows in the round, and each one's ``emit`` up to
    ``accepted + 1`` (later slots hold proposals past the live window)."""
    accepted, emit = outs
    rows = (a["n_valid"] > 0).nonzero()[0]
    return [accepted[rows]] + [emit[r, :int(accepted[r]) + 1] for r in rows]


def keep_all(a, outs):
    return list(outs)


def sampler_twin(torch, prog, S, log):
    """A sampler program checked call by call: its replay bit-equal to
    ``S.sample_tokens`` called eagerly on the same logits and inputs."""
    import numpy as np

    def call(logits, **arrays):
        out = prog(logits=logits, **arrays).clone()
        want = S.sample_tokens(logits, *S.from_staged(*(
            torch.from_numpy(np.asarray(arrays[k], np.int32)).cuda()
            for k in S.STAGED)))
        torch.cuda.synchronize()
        ensure(prog.graph is not None, f"{prog.name}: no graph captured")
        ensure(torch.equal(out, want), f"{prog.name}: replayed tokens "
               f"{out.tolist()} != eager {want.tolist()}")
        log.append(prog.name)
        return out

    return call


def graph_gate_phase(torch, cfg, params, MD, load_engine, SpeculativeEngine,
                     SPEC, S):
    """At full width and depth, the serve configuration: consecutive decode
    steps and prefill chunks of a live engine (one prompt of 40 tokens, so
    a chunk starts at 32 with 8 of 32 valid), then greedy rounds and
    prefill pairs on ``fused`` and on ``scan`` (identical draft), each
    replay bit-equal to the model function called eagerly on a copy of the
    caches; then sampled requests through the same engines: each sampler
    replay (plain decode and prefill) bit-equal to ``sample_tokens`` on the
    same logits, each sampled round's replay to ``sampled_round``.  Prints
    each program's capture seconds and graph nodes."""
    long_prompt = [(7 * i + 3) % cfg.vocab_size for i in range(40)]
    reqs = prompts(cfg.vocab_size, 3) + [long_prompt]
    eng = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                      device="cuda", **ENGINE_KNOBS)
    kv, cd = eng.kv.buffers, torch.bfloat16
    dec_log, pf_log = [], []
    eng._decode = twin(torch, eng._decode, lambda c, token, pos, table:
                       MD.paged_decode_step(params, token, pos, table, c[0],
                                            cfg, compute_dtype=cd),
                       [kv], keep_rows(eng.kv.trash), dec_log)
    eng._prefill = twin(torch, eng._prefill, lambda c, tokens, start, n_valid,
                        row: MD.paged_prefill_chunk(params, tokens, start,
                                                    n_valid, row, c[0], cfg,
                                                    compute_dtype=cd),
                        [kv], keep_all, pf_log)
    for p in reqs:
        eng.submit(p, max_new_tokens=4)
    eng.run_until_drained()
    n_greedy_dec = len(dec_log)
    s_log = []
    eng._sample_decode = sampler_twin(torch, eng._sample_decode, S, s_log)
    eng._sample_prefill = sampler_twin(torch, eng._sample_prefill, S, s_log)
    for i, p in enumerate(reqs[1:]):  # one sampled request with a greedy one
        eng.submit(p, sampled(i) if i != 1 else None, max_new_tokens=4)
    eng.run_until_drained()
    ensure(s_log.count("sample_decode") >= 3
           and s_log.count("sample_prefill") == 2,
           f"sampler calls checked: {s_log}")
    partial = [(int(a["start"]), int(a["n_valid"])) for a in pf_log
               if int(a["start"]) > 0]
    ensure(len(dec_log) >= 3, f"only {len(dec_log)} decode steps checked")
    ensure(any(nv < eng.prefill_chunk for _, nv in partial),
           f"no partial chunk past start 0 was checked: {partial}")
    print(f"[graphs] decode: {len(dec_log)} consecutive steps of a live "
          f"engine bit-equal to eager MD.paged_decode_step (logits of the "
          f"live rows, every page but the trash page), {n_greedy_dec} of "
          f"them greedy; prefill: {len(pf_log)} chunks bit-equal to eager "
          f"MD.paged_prefill_chunk, (start, n_valid) past 0: {partial}; "
          f"sampled decode: {s_log.count('sample_decode')} sampler replays "
          f"bit-equal to eager S.sample_tokens on the replayed logits "
          f"(with the decode check: replay + sampler = eager twin), "
          f"{s_log.count('sample_prefill')} first tokens after prefill",
          flush=True)
    print(f"[graphs] plain engine: capture_s "
          f"{fmt(eng.stats['capture_s'])}; graph nodes "
          f"{eng.stats['graph_nodes']}", flush=True)
    del eng
    for backend in ("fused", "scan"):
        seng = SpeculativeEngine(params, cfg, params, spec_k=SPEC_K,
                                 verify_backend=backend, compute_dtype=cd,
                                 device="cuda", **ENGINE_KNOBS)
        caches = [seng.kv.buffers, seng.kv_draft.buffers]
        r_log, p_log = [], []
        seng._round_greedy = twin(
            torch, seng._round_greedy, lambda c, token, pos, n_valid, table,
            b=backend: SPEC.greedy_round(
                params, params, token, pos, n_valid, table, c[0], c[1], cfg,
                cfg, SPEC_K, compute_dtype=cd, backend=b),
            caches, keep_round, r_log)
        seng._prefill = twin(
            torch, seng._prefill, lambda c, tokens, start, n_valid, row:
            SPEC.prefill_pair(params, params, tokens, start, n_valid, row,
                              c[0], c[1], cfg, cfg, compute_dtype=cd),
            caches, keep_all, p_log)
        for p in reqs[:2]:
            seng.submit(p, max_new_tokens=10)
        seng.run_until_drained()
        # an identical draft accepts everything on the scan oracle; fused
        # sums in another order (PERF.md, the verify findings), so it may
        # reject
        ensure(len(r_log) >= 2 and (backend == "fused"
                                    or seng.acceptance_rate == 1.0),
               f"{backend}: {len(r_log)} rounds, acceptance "
               f"{seng.acceptance_rate}")
        sr_log = []
        seng._round = twin(
            torch, seng._round, lambda c, token, pos, n_valid, table, seed,
            t, temperature, top_k, top_p, b=backend: SPEC.sampled_round(
                params, params, token, pos, n_valid, table,
                *S.from_staged(seed, t, temperature, top_k, top_p), c[0],
                c[1], cfg, cfg, SPEC_K, compute_dtype=cd, backend=b),
            caches, keep_sampled_round, sr_log)
        for i, p in enumerate(reqs[:2]):
            seng.submit(p, sampled(i), max_new_tokens=10)
        seng.run_until_drained()
        ensure(len(sr_log) >= 2, f"{backend}: {len(sr_log)} sampled rounds")
        print(f"[graphs] greedy round ({backend}): {len(r_log)} rounds "
              f"bit-equal to eager greedy_round (accepted, target up to "
              f"n_valid, both caches); sampled round: {len(sr_log)} rounds "
              f"bit-equal to eager sampled_round (accepted, emit up to "
              f"accepted + 1, both caches); {len(p_log)} prefill pairs to "
              f"eager prefill_pair; capture_s {fmt(seng.stats['capture_s'])};"
              f" graph nodes {seng.stats['graph_nodes']}", flush=True)
        del seng
    torch.cuda.empty_cache()


def fmt(d):
    return "{" + ", ".join(f"{k}: {v:.3f}" for k, v in d.items()) + "}"


# ---------------------------------------------------------------------------
# phases 11-12: an amm_lm bundle written to disk and served from it
# ---------------------------------------------------------------------------


def bundle_tables(np, cfg, gen):
    """Seeded per-layer tables of a target+draft bundle: int8 target LUTs
    (``init_amm_mlp_params``) and the draft as their int4 quantisation, as
    the bundle compiler bakes one fit at two widths: codes ``q >> 4`` in
    [-8, 7] on the same trees, scale × 16, and the dropped low nibble's
    mean (7.5 per codebook) folded into the offset."""
    from repro_torch.models.amm_mlp import init_amm_mlp_params
    target, draft = [], []
    for _ in range(cfg.num_layers):
        t = {k: v.cpu().numpy()
             for k, v in init_amm_mlp_params(cfg, gen).items()}
        d = dict(t)
        for proj in ("gate", "up", "down"):
            q, sc = t[f"lut_{proj}"], t[f"lut_{proj}_scale"]
            d[f"lut_{proj}"] = q >> 4
            d[f"lut_{proj}_scale"] = sc * np.float32(16)
            d[f"lut_{proj}_offset"] = (t[f"lut_{proj}_offset"]
                                       + np.float32(7.5 * q.shape[0]) * sc)
        target.append(t)
        draft.append(d)
    return target, draft


def artifact_phase(torch, cfg, MD, mods, counters, load_engine,
                   SpeculativeEngine):
    """qwen3-14b at full width, depth cut to ART_LAYERS: a bundle (int8
    target, int4 draft) written with ``save_bundle``; its target half
    served from disk (``speculative=False``) must give the same streams as
    the same tables spliced in memory, with ``fused_lutmu`` at 3 × layers
    launches per forward and the ``ref`` path never; then the bundle
    served speculatively (``fused`` verify) is held to those streams by
    the ``STREAM_MARGIN_TOL`` rule, with one verify launch per layer per
    round.  Returns the launches of the two runs."""
    import tempfile

    import numpy as np

    from repro_torch.compiler import pack_amm_lm, save_bundle
    FL, FV, dispatch = mods
    acfg = dataclasses.replace(cfg, num_layers=ART_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dense = MD.init_params(acfg, gen, torch.bfloat16, serving=False)
    t_layers, d_layers = bundle_tables(np, acfg, gen)
    target = pack_amm_lm(t_layers, acfg, "int8", name="smoke-target")
    draft = pack_amm_lm(d_layers, acfg, "int4", name="smoke-draft")
    del t_layers, d_layers
    opts = dict(compute_dtype=torch.bfloat16, device="cuda", **ENGINE_KNOBS)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bundle"
        t0 = time.perf_counter()
        save_bundle(path, {"name": "smoke", "arch": acfg.name,
                           "num_layers": acfg.num_layers, "spec_k": SPEC_K},
                    target, draft)
        write_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        print(f"[artifact] bundle of {acfg.num_layers} full-width layers "
              f"(int8 target, int4 draft): {nbytes / 1e9:.3f} GB written in "
              f"{write_s:.1f}s ({nbytes / 1e6 / write_s:.1f} MB/s)", flush=True)

        # the same tables spliced in memory: the streams to match
        mem_params = target.splice_lm_params(dense, device="cuda")
        mem_cfg = dataclasses.replace(acfg, amm=dataclasses.replace(
            acfg.amm, enabled=True, **target.manifest["amm"]))
        want, _, _, _ = serve(torch, mem_cfg, mem_params, load_engine, 6, 16)
        want = [list(h.generated) for h in want]

        # the target half from disk, through the paged engine
        t0 = time.perf_counter()
        eng = load_engine(path, dense, acfg, speculative=False, **opts)
        load_s = time.perf_counter() - t0
        ensure(type(eng).__name__ == "ServeEngine", f"got {type(eng)}")
        reset_counts(counters)
        handles, dt, ttft, eng = drive(torch, eng, acfg, 6, 16)
        calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
        t_launches = FL.LAUNCHES.n
        ensure(t_launches == 3 * acfg.num_layers * calls,
               f"artifact fused_lutmu launches {t_launches} != 3 x "
               f"{acfg.num_layers} x {calls}")
        ensure(dispatch.REF_ON_CUDA.n == 0,
               f"{dispatch.REF_ON_CUDA.n} ref LUT-MU calls ran on CUDA")
        got = [list(h.generated) for h in handles]
        ensure(all(len(s) == 16 for s in got), f"artifact streams {got}")
        ensure(got == want, "streams served from the artifact differ from "
               "the in-memory splice's")
        n_tok = sum(len(s) for s in got)
        print(f"[artifact] target half from disk: load {load_s:.1f}s; 6 "
              f"requests x 16 tokens in {dt:.3f}s = {n_tok / dt:.2f} tok/s; "
              f"TTFT mean {sum(ttft) / len(ttft):.4f}s; fused_lutmu launches "
              f"{t_launches} = 3 x {acfg.num_layers} x {calls} forward calls; "
              "ref on CUDA 0; streams equal to the in-memory splice's",
              flush=True)
        del eng, handles

        # the bundle, speculative, through the verify kernel
        t0 = time.perf_counter()
        seng = load_engine(path, dense, acfg, verify_backend="fused", **opts)
        bundle_load_s = time.perf_counter() - t0
    ensure(isinstance(seng, SpeculativeEngine) and seng.spec_k == SPEC_K,
           f"bundle engine {type(seng).__name__}, spec_k {seng.spec_k}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    sh, sdt, sttft, seng = drive(torch, seng, acfg, 6, 16)
    rounds = seng.stats["decode_calls"]
    s_launches = {"fused_lutmu": FL.LAUNCHES.n, "verify_window": FV.LAUNCHES.n}
    ensure(FV.LAUNCHES.n == acfg.num_layers * rounds,
           f"bundle verify launches {FV.LAUNCHES.n} != {acfg.num_layers} x "
           f"{rounds} rounds")
    ensure(FV.PLAIN_ON_CUDA.n == 0 and dispatch.REF_ON_CUDA.n == 0,
           f"plain verify on CUDA {FV.PLAIN_ON_CUDA.n}, ref LUT-MU "
           f"{dispatch.REF_ON_CUDA.n}")
    ensure(all(h.done and len(h.generated) == 16 for h in sh),
           "bundle speculative requests did not finish")
    differ = compare_streams(
        torch, "bundle-spec", sh, want,
        lambda: load_engine(None, mem_params, mem_cfg, **opts))
    print(spec_line("bundle-spec", sh, sdt, sttft, seng,
                    torch.cuda.max_memory_allocated()) +
          f"; bundle load {bundle_load_s:.1f}s; verify_window launches "
          f"{FV.LAUNCHES.n} = {acfg.num_layers} x {rounds} rounds; "
          f"fused_lutmu launches {FL.LAUNCHES.n}; {differ} of {len(sh)} "
          "streams differ from the target's", flush=True)
    del seng, sh, mem_params, dense
    torch.cuda.empty_cache()
    return {"artifact_fused_lutmu": t_launches, **{
        f"bundle_{k}": v for k, v in s_launches.items()}}


# ---------------------------------------------------------------------------
# phase 13: the paper's SFC MLP as an amm_chain artifact
# ---------------------------------------------------------------------------


def chain_artifact(np, res: str, rng, platform: str):
    """A seeded ``amm_chain`` artifact at the SFC widths: d_sub 8, depth 4,
    every hand-off pruned to the next layer's split dims, ReLU between
    layers, ``res`` ("int16" or "int8") LUTs scaled so each output has
    unit variance, recorded backends the port's dispatch picks at
    ``CHAIN_BATCH`` rows."""
    import torch

    from repro_torch.compiler import ARTIFACT_FORMAT, ARTIFACT_VERSION, Artifact
    from repro_torch.core.maddness import HashTree
    from repro_torch.core.pruning import plan_from_consumer_tree
    from repro_torch.kernels.dispatch import select_backend
    g = 2**CHAIN_DEPTH
    n_layers = len(CHAIN_WIDTHS) - 1
    books = [w // CHAIN_D_SUB for w in CHAIN_WIDTHS[:-1]]
    split = [rng.integers(0, CHAIN_D_SUB, (c, CHAIN_DEPTH)).astype(np.int32)
             for c in books]
    hi = {"int16": 2**15, "int8": 2**7}[res]
    tensors, recs = {}, []
    for i in range(n_layers):
        c, full = books[i], CHAIN_WIDTHS[i + 1]
        plan = None
        if i < n_layers - 1:
            nxt = HashTree(torch.from_numpy(split[i + 1]),
                           torch.zeros((books[i + 1], g - 1)))
            plan = plan_from_consumer_tree(nxt, consumer_in_dim=full)
            tensors[f"layer{i}/keep_idx"] = plan.keep_idx.numpy().astype(np.int32)
        cols = plan.num_kept if plan is not None else full
        lut = rng.integers(-hi, hi, (c, g, cols)).astype(
            np.int16 if res == "int16" else np.int8)
        centre = 0.0 if i == 0 else 0.4  # ReLU'd inputs after layer 0
        tensors.update({
            f"layer{i}/split_dims": split[i],
            f"layer{i}/thresholds": (centre + 0.5 * rng.standard_normal(
                (c, g - 1))).astype(np.float32),
            f"layer{i}/lut": lut,
            f"layer{i}/lut_scale": np.full(
                (cols,), 1.0 / (hi / np.sqrt(3) * np.sqrt(c)), np.float32),
            f"layer{i}/lut_offset": (0.1 * rng.standard_normal(cols)).astype(
                np.float32)})
        recs.append({
            "num_codebooks": c, "depth": CHAIN_DEPTH, "in_features":
            CHAIN_WIDTHS[i], "out_features_full": full, "cols": cols,
            "pruned": plan is not None,
            "consumer_codebooks": plan.consumer_codebooks if plan else None,
            "consumer_depth": plan.consumer_depth if plan else None,
            "backend": select_backend(CHAIN_BATCH, c, cols, CHAIN_DEPTH,
                                      getattr(torch, res), platform),
            "tiles": None, "lut_dtype": res, "int4_packed": False})
    manifest = {"format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
                "kind": "amm_chain", "name": f"sfc-mlp-{res}",
                "platform": platform, "resolution": res,
                "activations": ["relu"] * (n_layers - 1), "layers": recs,
                "resource_report": {"lut_bytes": int(sum(
                    tensors[f"layer{i}/lut"].nbytes for i in range(n_layers)))}}
    return Artifact(manifest=manifest, tensors=tensors)


def chain_phase(torch, timer, mods, counters):
    """The SFC chain at int16 and int8: written with ``save_artifact``,
    loaded with ``AMMChain.load``, run at batch CHAIN_BATCH on ``auto``
    (counts set to 0 just before, read just after); then each layer on the
    chain's own inputs against the same layer with ``backend="ref"``:
    bit-equal.  int16 also runs ``backend="unfused"`` (encode + aggregate
    kernels), bit-equal to the fused run.  Returns the launches by run."""
    import tempfile

    import numpy as np

    from repro_torch.compiler import PLATFORM, save_artifact
    from repro_torch.core.lut_mu import AMMChain
    FL, ME, LA, dispatch = mods
    launches = {}
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(
        (CHAIN_BATCH, CHAIN_WIDTHS[0])).astype(np.float32)).cuda()
    for res in ("int16", "int8"):
        art = chain_artifact(np, res, rng, PLATFORM)
        with tempfile.TemporaryDirectory() as tmp:
            save_artifact(Path(tmp) / res, art)
            chain = AMMChain.load(Path(tmp) / res, device="cuda")
        reset_counts(counters)
        y = chain(x)
        torch.cuda.synchronize()
        n = len(chain.layers)
        launches[f"{res}_fused_lutmu"] = FL.LAUNCHES.n
        ensure(FL.LAUNCHES.n == n and dispatch.REF_ON_CUDA.n == 0,
               f"{res} chain: fused_lutmu {FL.LAUNCHES.n}, ref "
               f"{dispatch.REF_ON_CUDA.n} for {n} layers")
        ensure(tuple(y.shape) == (CHAIN_BATCH, CHAIN_WIDTHS[-1])
               and bool(torch.isfinite(y).all()), f"{res} chain output")
        if res == "int16":
            reset_counts(counters)
            yu = chain(x, backend="unfused")
            torch.cuda.synchronize()
            launches["int16_lut_aggregate"] = LA.LAUNCHES.n
            ensure(LA.LAUNCHES.n == n and ME.LAUNCHES.n == n
                   and FL.LAUNCHES.n == 0,
                   f"int16 unfused chain: aggregate {LA.LAUNCHES.n}, encode "
                   f"{ME.LAUNCHES.n}, fused {FL.LAUNCHES.n}")
            ensure(torch.equal(yu, y), "int16 chain: unfused != fused")
        # layer by layer on the chain's own inputs, against backend="ref"
        h = x
        for i, layer in enumerate(chain.layers):
            apply = layer.apply_package if i > 0 else layer.__call__
            got = apply(h, backend=chain.backends[i])
            want = apply(h, backend="ref")
            if res == "int16":
                ensure(torch.equal(apply(h, backend="unfused"), want),
                       f"int16 layer {i}: unfused != ref")
            torch.cuda.synchronize()
            ensure(torch.equal(got, want), f"{res} layer {i}: "
                   f"{chain.backends[i]} != ref (max err "
                   f"{(got - want).abs().max().item()})")
            h = torch.relu(got) if i < n - 1 else got
        ensure(torch.equal(h, y), f"{res} chain: layer by layer != chain")
        ms = timer.ms(lambda: chain(x), 20)
        ref_ms = timer.ms(lambda: chain(x, backend="ref"), 3)
        print(f"[chain] SFC {'-'.join(map(str, CHAIN_WIDTHS))} {res}, batch "
              f"{CHAIN_BATCH}: backends {chain.backends}; {n} layers "
              f"bit-equal to backend='ref' on shared inputs; forward "
              f"{ms:.4f} ms (ref {ref_ms:.4f} ms); LUT {chain.lut_bytes()} "
              f"bytes, {chain.workload_ops()} ops per row", flush=True)
        del chain
    return launches


# ---------------------------------------------------------------------------
# phases 19-21: the offline compiler on the card, and autotuned plans
# ---------------------------------------------------------------------------


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def fit_card_vs_cpu(torch):
    """One AMM-MLP layer fit at qwen3-14b's reduced widths (d_model 128,
    d_ff 256, ``FIT_ROWS`` seeded rows) on the card and on the CPU with the
    same code: split dims and thresholds equal except at near-ties
    (``maddness.compare_trees``, each printed); prototypes from the same
    trees within ``PROTO_TOL``; int8 codes equal but for a counted number
    of ±1 steps (the float tables' sums in another order).  Returns the
    counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import maddness as M
    from repro_torch.models import amm_mlp as AMM
    cfg = get_config("qwen3-14b", reduced=True)
    d, ff, depth = cfg.d_model, cfg.d_ff, cfg.amm.depth
    rng = np.random.default_rng(31)
    x = rng.standard_normal((FIT_ROWS, d))
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((d, ff), (d, ff), (ff, d))]
    fits = {}
    for dev in ("cpu", "cuda"):
        fits[dev] = AMM.fit_from_dense_float(
            torch.from_numpy(x).to(dev),
            *[torch.from_numpy(w).to(dev) for w in ws], cfg)
    cpu = fits["cpu"]
    card = {k: v.cpu() for k, v in fits["cuda"].items()}
    g = torch.from_numpy(x @ ws[0]).float()
    h = (torch.nn.functional.silu(g.double()).float()
         * torch.from_numpy(x @ ws[1]).float())
    out = {"excused": {}, "codes_off_by_one": {}}
    for tree, src in (("up", torch.from_numpy(x)), ("down", h)):
        trees = {k: M.HashTree(f[f"{tree}_split_dims"], f[f"{tree}_thresholds"])
                 for k, f in (("cpu", cpu), ("card", card))}
        _, margins = M.learn_hash_trees(src, trees["cpu"].num_codebooks, depth,
                                        margins=True)
        excused, unexcused = M.compare_trees(trees["card"], trees["cpu"],
                                             margins, NEAR_TIE)
        ensure(not unexcused, f"fit {tree} tree: card != CPU beyond a "
               f"near-tie at (codebook, level) {unexcused}")
        out["excused"][tree] = excused
        for c, level in excused:
            print(f"[fit] {tree} tree codebook {c} level {level}: a near-tie "
                  f"(within {NEAR_TIE} relative) picked apart", flush=True)
        p_cpu = M.learn_prototypes(src, trees["cpu"])
        p_card = M.learn_prototypes(src.cuda(), M.HashTree(
            fits["cpu"][f"{tree}_split_dims"].cuda(),
            fits["cpu"][f"{tree}_thresholds"].cuda())).cpu()
        torch.testing.assert_close(p_card, p_cpu, **PROTO_TOL,
                                   msg=f"{tree} prototypes, card vs CPU")
    q_cpu = AMM.quantize_amm_layer(cpu, "int8")
    q_card = AMM.quantize_amm_layer(card, "int8")
    for proj in ("gate", "up", "down"):
        tree = "down" if proj == "down" else "up"
        if out["excused"][tree] or out["excused"]["down"]:
            print(f"[fit] lut_{proj}: codes not compared (a tree picked "
                  "apart)", flush=True)
            continue
        diff = (q_card[f"lut_{proj}"].int() - q_cpu[f"lut_{proj}"].int()).abs()
        ensure(int(diff.max()) <= 1, f"lut_{proj} int8 codes card vs CPU "
               f"differ by {int(diff.max())} steps")
        out["codes_off_by_one"][proj] = (int((diff == 1).sum()), diff.numel())
    print(f"[fit] reduced width (d_model {d}, d_ff {ff}, {FIT_ROWS} rows), "
          f"card vs CPU: trees equal (near-ties excused: "
          f"{ {k: len(v) for k, v in out['excused'].items()} }); prototypes "
          f"within {PROTO_TOL}; int8 codes ±1 steps (count, of): "
          f"{out['codes_off_by_one']}", flush=True)
    return out


def compile_phase(torch, cfg, MD, mods, counters, load_engine,
                  SpeculativeEngine):
    """qwen3-14b at full width, depth cut to ART_LAYERS, float32 dense params
    from a seeded generator on the card: ``compile_lm_bundle`` (int8
    target, int4 draft) from ``TokenStream`` calibration tokens, written to
    a temporary directory; stage seconds and peak memory printed.  Gates:
    the fitted target's MLP is closer to the dense MLP on the calibration
    activations than random int8 tables of the same shape; the target half
    served from disk through the kernels gives the plain ``ref`` path's
    streams; the bundle served speculatively is held to them by the
    ``STREAM_MARGIN_TOL`` rule (its acceptance printed).  Returns the
    launches and the numbers for the summary."""
    import tempfile

    from repro_torch.compiler import compile_lm_bundle
    from repro_torch.data import TokenStream
    from repro_torch.device import StageClock
    from repro_torch.models import amm_mlp as AMM
    from repro_torch.models import layers as L
    FL, FV, dispatch = mods
    acfg = dataclasses.replace(cfg, num_layers=ART_LAYERS,
                               amm=dataclasses.replace(cfg.amm, enabled=True,
                                                       backend="auto"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = MD.init_params(acfg, torch.Generator(device="cuda").manual_seed(21),
                           torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = TokenStream(vocab_size=acfg.vocab_size, batch_size=CALIB_BATCH,
                         seq_len=CALIB_SEQ).batch(0)["tokens"]
    clock = StageClock()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bundle"
        t0 = time.perf_counter()
        res = compile_lm_bundle(dense, acfg, tokens, target_resolution="int8",
                                draft_resolution="int4", spec_k=SPEC_K,
                                out=str(path), clock=clock)
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rep = res.report
        per_layer = {k: v / acfg.num_layers for k, v in clock.seconds.items()}
        out.update(compile_s=total, per_layer_s=per_layer, peak_gb=peak / 1e9,
                   report=rep)
        print(f"[compile] qwen3-14b full width, {acfg.num_layers} layers, "
              f"float32 dense params ({init_s:.1f}s to init), calibration "
              f"{CALIB_BATCH} x {CALIB_SEQ} tokens: compile_lm_bundle in "
              f"{total:.1f}s; seconds per layer {fmt(per_layer)}; peak memory "
              f"{peak / 1e9:.2f} GB; LUT bytes target "
              f"{rep['target']['lut_bytes']} ({rep['target']['resolution']}), "
              f"draft {rep['draft']['lut_bytes']} "
              f"({rep['draft']['resolution']}), draft_vs_target_stored "
              f"{rep['draft_vs_target_stored']}", flush=True)

        # the fitted MLP against the dense one and against random tables,
        # on the calibration activations (the gate) and on held-out tokens
        # (printed: the fit has more unknowns than calibration rows)
        held_out = TokenStream(vocab_size=acfg.vocab_size,
                               batch_size=CALIB_BATCH,
                               seq_len=CALIB_SEQ).batch(1)["tokens"]
        target_layers = res.target.lm_layer_params(device="cuda")
        rand = AMM.init_amm_mlp_params(
            acfg, torch.Generator(device="cuda").manual_seed(22))
        errs = {}
        for which, toks in (("calibration", tokens), ("held-out", held_out)):
            caps = MD.capture_mlp_inputs(dense, toks, acfg,
                                         compute_dtype=torch.float32)
            errs[which] = []
            for l, x in enumerate(caps):
                m = MD.layer_params(dense["layers"], l)["mlp"]
                want = L.gated_mlp(x, m["w_gate"], m["w_up"], m["w_down"],
                                   acfg.act)
                fit = AMM.amm_mlp_apply(target_layers[l], x[None], acfg)[0]
                rnd = AMM.amm_mlp_apply(rand, x[None], acfg)[0]
                errs[which].append((_rel_err(fit, want), _rel_err(rnd, want)))
        for l, (fit_err, rnd_err) in enumerate(errs["calibration"]):
            ensure(fit_err < rnd_err, f"layer {l}: fitted int8 MLP rel. error "
                   f"{fit_err} not below random tables' {rnd_err}")
        out["mlp_rel_err"] = errs
        print(f"[compile] MLP output, relative error to the dense MLP "
              f"(fitted int8, random int8) per layer: on the calibration "
              f"activations {[(round(a, 4), round(b, 4)) for a, b in errs['calibration']]}; "
              f"on held-out tokens "
              f"{[(round(a, 4), round(b, 4)) for a, b in errs['held-out']]}",
              flush=True)
        del caps, target_layers, rand, res

        # the target half from disk through the kernels, against the plain
        # ref path called eagerly on the same tables
        def to_bf16(tree):
            return ({k: to_bf16(v) for k, v in tree.items()}
                    if isinstance(tree, dict) else tree.to(torch.bfloat16))

        dense_bf = to_bf16(dense)
        del dense
        torch.cuda.empty_cache()
        opts = dict(compute_dtype=torch.bfloat16, device="cuda", **ENGINE_KNOBS)
        eng = load_engine(path, dense_bf, acfg, speculative=False, **opts)
        reset_counts(counters)
        handles, dt, ttft, eng = drive(torch, eng, acfg, 6, 16)
        calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
        t_launches = FL.LAUNCHES.n
        ensure(t_launches == 3 * acfg.num_layers * calls
               and dispatch.REF_ON_CUDA.n == 0,
               f"fitted target: fused_lutmu {t_launches} for {calls} calls, "
               f"ref {dispatch.REF_ON_CUDA.n}")
        got = [list(h.generated) for h in handles]
        mem_params = eng.params
        mem_cfg = eng.cfg
        rcfg = dataclasses.replace(mem_cfg, amm=dataclasses.replace(
            mem_cfg.amm, backend="ref"))
        want = eager_streams(torch, MD, mem_params, rcfg,
                             prompts(acfg.vocab_size, 6), 16)
        ensure(got == want, "fitted target served from disk: streams differ "
               "from the plain ref path's")
        n_tok = sum(len(s) for s in got)
        out.update(target_tok_s=n_tok / dt, target_launches=t_launches)
        print(f"[compile] fitted int8 target from disk: 6 x 16 tokens, "
              f"{n_tok / dt:.2f} tok/s; fused_lutmu launches {t_launches} = "
              f"3 x {acfg.num_layers} x {calls}; streams equal to the plain "
              "ref path's (called eagerly)", flush=True)
        del eng, handles

        # the fitted bundle, speculative, through the verify kernel
        seng = load_engine(path, dense_bf, acfg, verify_backend="fused", **opts)
    ensure(isinstance(seng, SpeculativeEngine), f"got {type(seng)}")
    reset_counts(counters)
    sh, sdt, sttft, seng = drive(torch, seng, acfg, 6, 16)
    rounds = seng.stats["decode_calls"]
    ensure(FV.LAUNCHES.n == acfg.num_layers * rounds
           and FV.PLAIN_ON_CUDA.n == 0 and dispatch.REF_ON_CUDA.n == 0,
           f"fitted bundle: verify launches {FV.LAUNCHES.n} for {rounds} rounds")
    ensure(all(h.done and len(h.generated) == 16 for h in sh),
           "fitted bundle requests did not finish")
    differ = compare_streams(
        torch, "fitted-bundle-spec", sh, want,
        lambda: load_engine(None, mem_params, mem_cfg, **opts))
    out.update(acceptance=seng.acceptance_rate, spec_tok_s=96 / sdt,
               verify_launches=FV.LAUNCHES.n)
    print(spec_line("fitted-bundle-spec", sh, sdt, sttft, seng,
                    torch.cuda.max_memory_allocated()) +
          f"; verify_window launches {FV.LAUNCHES.n} = {acfg.num_layers} x "
          f"{rounds} rounds; {differ} of {len(sh)} streams differ from the "
          "target's", flush=True)
    del seng, sh, mem_params, dense_bf
    torch.cuda.empty_cache()
    return out


def compile_chain_phase(torch, mods, counters):
    """``compile_chain`` of the SFC MLP (784 → 256 → 256 → 256 → 10, d_sub
    8, depth 4, pruned, ReLU) on the card from seeded dense weights and
    ``CHAIN_CALIB`` synthetic calibration rows, int8, ``autotune=True``
    (each layer's ``fused_lutmu`` cluster size measured at batch 256 into
    the current autotune cache); reloaded from disk, its recorded plans
    reach every layer, and every layer is bit-equal to ``backend="ref"``
    on the chain's own inputs.  Returns the launches of the reloaded
    chain's forward."""
    import tempfile

    import numpy as np

    from repro_torch.compiler import compile_chain
    from repro_torch.core.lut_mu import AMMChain
    from repro_torch.kernels import autotune as AT
    FL, dispatch = mods
    rng = np.random.default_rng(17)
    dims = list(zip(CHAIN_WIDTHS[:-1], CHAIN_WIDTHS[1:]))
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in dims]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32) for s in dims]
    centres = rng.standard_normal((32, CHAIN_WIDTHS[0]))
    calib = torch.from_numpy((centres[rng.integers(0, 32, CHAIN_CALIB)]
                              + 0.3 * rng.standard_normal(
                                  (CHAIN_CALIB, CHAIN_WIDTHS[0]))).astype(
        np.float32)).cuda()
    books = [w // CHAIN_D_SUB for w in CHAIN_WIDTHS[:-1]]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = compile_chain(ws, bs, calib, num_codebooks=books,
                            depths=[CHAIN_DEPTH] * len(books),
                            activations=["relu"] * (len(books) - 1),
                            resolution="int8", autotune=True,
                            name="sfc-mlp", out=str(Path(tmp) / "sfc"))
        compile_s = time.perf_counter() - t0
        chain = AMMChain.load(Path(tmp) / "sfc", device="cuda")
    recs = res.artifact.manifest["layers"]
    plans = [AT.TileConfig.from_dict(r["tiles"]) for r in recs]
    ensure([l.tiles for l in chain.layers] == plans
           and chain.backends == tuple(r["backend"] for r in recs),
           "reloaded chain lost its recorded plans")
    heur = [AT.heuristic_tiles(256, r["num_codebooks"], r["cols"], CHAIN_DEPTH,
                               torch.int8, device="cuda") for r in recs]
    x = calib[:CHAIN_BATCH]
    reset_counts(counters)
    y = chain(x)
    torch.cuda.synchronize()
    n = len(chain.layers)
    launches = FL.LAUNCHES.n
    ensure(launches == n and dispatch.REF_ON_CUDA.n == 0,
           f"compiled chain: fused_lutmu {launches}, ref "
           f"{dispatch.REF_ON_CUDA.n} for {n} layers")
    ensure(torch.equal(res.chain(x), y), "in-memory chain != reloaded chain")
    h = x
    for i, layer in enumerate(chain.layers):
        apply = layer.apply_package if i > 0 else layer.__call__
        got = apply(h, backend=chain.backends[i])
        want = apply(h, backend="ref")
        torch.cuda.synchronize()
        ensure(torch.equal(got, want), f"compiled chain layer {i}: "
               f"{chain.backends[i]} != ref")
        h = torch.relu(got) if i < n - 1 else got
    dense = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        dense = dense @ torch.from_numpy(w).cuda() + torch.from_numpy(b).cuda()
        dense = torch.relu(dense) if i < n - 1 else dense
    print(f"[compile-chain] SFC {'-'.join(map(str, CHAIN_WIDTHS))} int8 from "
          f"{CHAIN_CALIB} calibration rows on the card, autotune=True: "
          f"{compile_s:.1f}s; backends {chain.backends}; measured clusters "
          f"{[p.cluster for p in plans]} (heuristic "
          f"{[p.cluster for p in heur]}); reloaded: {n} layers bit-equal to "
          f"backend='ref', fused_lutmu launches {launches}; output rel. "
          f"error to the dense MLP {_rel_err(y, dense):.4f}; LUT "
          f"{chain.lut_bytes()} bytes", flush=True)
    return {"fused_lutmu": launches, "compile_s": compile_s,
            "clusters": [p.cluster for p in plans]}


def autotune_phase(torch, timer, mods, cache_path):
    """``fused_lutmu`` cluster sizes measured at the four gate/up and down
    decode (B=4) and prefill (B=32) int8 shapes, and ``verify_window`` split
    counts at S = 128 and 4096 (bf16 KV), into the cache at ``cache_path``;
    the cache re-read from disk gives the same plans; each measured plan's
    output is bit-equal to the heuristic's (int8) or within ``VERIFY_TOL``
    of it (bf16 verify); the measured plan's ms beside the heuristic's
    (CUDA events, L2 flushed).  The heuristic on the card is the plan the
    wrapper picks by itself.  Returns both plans and times by case."""
    from repro_torch.kernels import autotune as AT
    FL, FV = mods
    gen = torch.Generator(device="cuda").manual_seed(41)
    g = 2**DEPTH
    cache = AT.AutotuneCache(cache_path)
    results, keys = {}, {}
    for proj, b in (("gate_up", 4), ("down", 4), ("gate_up", 32), ("down", 32)):
        c, n = SHAPES[proj]
        x = torch.randn((b, c, DEPTH), generator=gen, device="cuda")
        thr = torch.randn((c, g - 1), generator=gen, device="cuda")
        lut = torch.randint(-128, 128, (c, g, n), generator=gen,
                            dtype=torch.int8, device="cuda")
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.015 + 0.005
        offset = torch.randn((n,), generator=gen, device="cuda")
        args = (x, thr, lut, scale, offset)
        heur = AT.heuristic_tiles(b, c, n, DEPTH, torch.int8, device="cuda")
        hplan = AT.fused_plan(heur, b, c, DEPTH, torch.int8)
        ensure(hplan == FL._plan_for(b, c, n, DEPTH, torch.int8, 0),
               f"{proj} B={b}: heuristic {hplan} != the wrapper's plan")
        n_cands = len(AT.candidate_tiles(b, c, n, DEPTH, torch.int8, "cuda"))
        best = AT.get_tiles(b, c, n, DEPTH, torch.int8, allow_measure=True,
                            cache=cache, device="cuda")
        keys[AT.shape_key("cuda", "fused", b, c, n, DEPTH, torch.int8)] = best
        mplan = AT.fused_plan(best, b, c, DEPTH, torch.int8)
        want = FL.fused_lutmu(*args)
        got = FL.fused_lutmu(*args, launch_plan=mplan)
        torch.cuda.synchronize()
        ensure(torch.equal(got, want), f"{proj} B={b}: measured plan "
               f"(cluster {best.cluster}) != heuristic's output")
        r = dict(heuristic=heur.cluster, measured=best.cluster,
                 candidates=n_cands,
                 heuristic_ms=timer.ms(lambda: FL.fused_lutmu(*args), 20),
                 measured_ms=timer.ms(
                     lambda: FL.fused_lutmu(*args, launch_plan=mplan), 20))
        results[("fused_lutmu", proj, b)] = r
        print(f"[autotune] fused_lutmu {proj:7s} B={b:<2d} int8: cluster "
              f"measured {best.cluster} (of {n_cands} candidates) vs "
              f"heuristic {heur.cluster}: {r['measured_ms']:.4f} vs "
              f"{r['heuristic_ms']:.4f} ms; output bit-equal", flush=True)
        del args, x, thr, lut
    b, w, nkv, gq, hd, ps = VERIFY_SHAPE
    for s_len in VERIFY_S:
        q, kp, vp, pt, pos = verify_inputs(torch, s_len, "bfloat16", gen)
        heur = AT.verify_heuristic_tiles(s_len, w, nkv, gq, hd, torch.bfloat16,
                                         b=b, page_size=ps, device="cuda")
        best = AT.get_verify_tiles(s_len, w, nkv, gq, hd, torch.bfloat16, b=b,
                                   page_size=ps, allow_measure=True,
                                   cache=cache, device="cuda")
        keys[AT.verify_shape_key("cuda", s_len, w, nkv, gq, hd,
                                 torch.bfloat16, b)] = best
        args = (q, kp, vp, pt, pos, None)
        want = FV.verify_window_attend_cuda(*args, splits=heur.splits)
        got = FV.verify_window_attend_cuda(*args, splits=best.splits)
        plain = FV.verify_window_attend_plain(*args)
        torch.cuda.synchronize()
        err = max((got - want).abs().max().item(),
                  (got - plain).abs().max().item())
        ensure(err <= VERIFY_TOL["bfloat16"], f"verify S={s_len}: measured "
               f"{best.splits} splits off by {err}")
        r = dict(heuristic=heur.splits, measured=best.splits, max_abs_err=err,
                 heuristic_ms=timer.ms(lambda: FV.verify_window_attend_cuda(
                     *args, splits=heur.splits), 20),
                 measured_ms=timer.ms(lambda: FV.verify_window_attend_cuda(
                     *args, splits=best.splits), 20))
        results[("verify_window", s_len)] = r
        print(f"[autotune] verify_window S={s_len:<4d} bf16: splits measured "
              f"{best.splits} vs heuristic {heur.splits}: "
              f"{r['measured_ms']:.4f} vs {r['heuristic_ms']:.4f} ms; max abs "
              f"err {err:.3g} (tolerance {VERIFY_TOL['bfloat16']})", flush=True)
        del q, kp, vp, pt, pos, args
    reread = AT.AutotuneCache(cache_path)
    for key, plan in keys.items():
        cls = AT.VerifyTileConfig if "|verify|" in key else AT.TileConfig
        ensure(reread.get(key, cls=cls) == plan,
               f"cache re-read: {key} gives {reread.get(key, cls=cls)}")
    print(f"[autotune] cache {len(reread)} entries re-read from disk: every "
          "measured plan found", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 18: observed — recorder, kernel profiler, HTTP, quality probe
# ---------------------------------------------------------------------------


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def observed_serve(torch, cfg, params, load_engine, counters, plain_streams,
                   sampled_streams, profile):
    """The 40-layer serve of phase 5 four times in one call, the recorder
    off, on, on, off (on: a tracing ``Recorder``, a
    ``KernelProfiler(every=4)`` and the dispatch hook; the recorder reset
    after each warm-up request): the same streams, tok/s and host ms per
    ``engine.step()`` (decode-only and prefill steps, profiled and
    unprofiled, apart), the profiled ``serve.decode`` p50 beside the
    profile phase's device ms; then the same engine serves phase 16's
    sampled requests, with phase 16's streams.  Both exports validate, the
    trace has a kernels lane, ``serve_generated_tokens_total`` is the
    tokens emitted, and every step program built once.  Returns the
    observed engine and its recorder."""
    from repro_torch.kernels import fused_lutmu as FL
    from repro_torch.serving import (KernelProfiler, Recorder,
                                     attach_dispatch_hook,
                                     validate_chrome_trace,
                                     validate_prometheus)
    off = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                      device=DEVICE, **ENGINE_KNOBS)
    rec = Recorder(trace=True)
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=4)
    detach = attach_dispatch_hook(rec.registry)
    eng = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                      device=DEVICE, recorder=rec, **ENGINE_KNOBS)
    dispatched = []

    def warmed_up():
        # by the first warm-up both engines had built their decode and
        # prefill programs: the hook fired 3 times per layer for each, at
        # capture only
        dispatched.append(rec.registry.sum_values("lutmu_dispatch_total"))
        rec.reset()

    runs = {"off": [], "on": []}  # (tok/s, [(host ms, profiled, prefill)])
    for label in ("off", "on", "on", "off"):
        ms = []
        reset_counts(counters)
        hs, dt, _, e = drive(torch, eng if label == "on" else off, cfg, 6,
                             16, step_ms=ms,
                             after_warm_up=warmed_up if label == "on" else None)
        ensure([x.generated for x in hs] == plain_streams,
               f"recorder {label}: streams differ from phase 5's")
        calls = e.stats["prefill_calls"] + e.stats["decode_calls"]
        ensure(FL.LAUNCHES.n == 3 * cfg.num_layers * calls,
               f"recorder {label}: fused_lutmu launches {FL.LAUNCHES.n} for "
               f"{calls} calls")
        n_tok = sum(len(x.generated) for x in hs)
        runs[label].append((n_tok / dt, ms))
        if label == "on":  # the recorder holds this run since its reset
            generated = rec.registry.value("serve_generated_tokens_total")
            ensure(generated == n_tok,
                   f"serve_generated_tokens_total {generated} != {n_tok} "
                   "tokens emitted")
    del off
    ensure(dispatched == [2 * 2 * 3 * cfg.num_layers, 0]
           and rec.registry.sum_values("lutmu_dispatch_total") == 0,
           f"dispatch hook: {dispatched} at the warm-ups, "
           f"{rec.registry.sum_values('lutmu_dispatch_total')} after")
    prof = rec.profiler.snapshot()
    dec = prof["sites"].get("serve.decode")
    ensure(dec is not None and dec["count"] > 0, "no profiled serve.decode")
    # the sampled requests of phase 16 through the same observed engine
    sh, sdt, _, eng = drive(torch, eng, cfg, 6, 16, sampled)
    ensure([x.generated for x in sh] == sampled_streams,
           "observed sampled serve: streams differ from phase 16's")
    detach()
    text, trace = rec.to_prometheus(), rec.to_chrome()
    ensure(validate_prometheus(text) == [],
           f"metrics invalid: {validate_prometheus(text)[:3]}")
    ensure(validate_chrome_trace(trace) == [],
           f"trace invalid: {validate_chrome_trace(trace)[:3]}")
    lanes = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    ensure("kernels" in lanes, f"no kernels lane in the trace: {lanes}")
    builds = {p.name: p.builds for p in (eng._decode, eng._prefill,
                                         eng._sample_decode,
                                         eng._sample_prefill)}
    ensure(all(b == 1 for b in builds.values()), f"program builds {builds}")
    misses = {dict(m.labels)["site"]: m.value
              for m in rec.registry.find("jit_cache_misses_total")}
    def by_kind(steps, profiled):
        # mean host ms of decode-only steps and of steps with a prefill
        # chunk, (count), among the steps profiled or not as asked
        out = []
        for pre in (False, True):
            ms = [t for t, a, p in steps if a == profiled and p == pre]
            out.append(f"{_mean(ms):.3f} ({len(ms)})")
        return " / ".join(out)

    off_ms = [x for _, ms in runs["off"] for x in ms]
    on_ms = [x for _, ms in runs["on"] for x in ms]
    tok_s = {k: " / ".join(f"{t:.2f}" for t, _ in r) for k, r in runs.items()}
    print(f"[observed] 40-layer serve, 6 x 16 greedy, in turns off, on, on, "
          f"off: recorder off {tok_s['off']} tok/s, "
          f"{_mean([t for t, _, _ in off_ms]):.3f} host ms per "
          f"engine.step() ({len(off_ms)} steps); recorder on (trace, profiler "
          f"every 4, dispatch hook) {tok_s['on']} tok/s, "
          f"{_mean([t for t, _, _ in on_ms]):.3f} ms per step; host ms of "
          f"decode-only / prefill steps (count): off {by_kind(off_ms, False)}"
          f", on unprofiled {by_kind(on_ms, False)}, on profiled "
          f"{by_kind(on_ms, True)}; streams equal phase 5's", flush=True)
    print(f"[observed] profiled serve.decode p50 {1e3 * dec['p50_s']:.3f} ms "
          f"mean {1e3 * dec['mean_s']:.3f} ms (n={dec['count']}; host clock "
          f"between device syncs) against the profile phase's decode replay "
          f"{profile['replay_events_ms']:.3f} device ms (CUDA events), "
          f"{profile['replay_profiler_ms']:.3f} ms of kernels (profiler); "
          f"serve.decode flops, bytes {eng._decode_cost({'token': [0] * 4})}"
          f" (the port's count); sites {sorted(prof['sites'])}", flush=True)
    print(f"[observed] sampled serve through the observed engine: "
          f"{sum(len(x.generated) for x in sh) / sdt:.2f} tok/s, streams "
          f"equal phase 16's; builds {builds}; jit_cache_misses_total "
          f"{misses} (reset after the warm-up); lutmu_dispatch_total "
          f"{dispatched[0]:.0f} at the two engines' four captures, 0 after; "
          f"exports "
          f"valid ({len(text.splitlines())} lines, "
          f"{len(trace['traceEvents'])} trace events, lanes include kernels)",
          flush=True)
    return eng, rec


def observed_spec(torch, cfg, params, SpeculativeEngine, FV, counters):
    """The 40-layer speculative serve on ``fused`` (identical draft)
    observed: the recorder's speculative counters against ``stats`` and
    ``acceptance_rate``, 40 verify launches per round."""
    from repro_torch.serving import Recorder, validate_prometheus
    rec = Recorder(trace=False)
    eng = SpeculativeEngine(params, cfg, params, spec_k=SPEC_K,
                            verify_backend="fused", recorder=rec,
                            compute_dtype=torch.bfloat16, device=DEVICE,
                            **ENGINE_KNOBS)
    reset_counts(counters)
    h, dt, _, eng = drive(torch, eng, cfg, 6, 16, after_warm_up=rec.reset)
    v, st = rec.registry.value, eng.stats
    rounds = v("spec_rounds_total", path="greedy") + v("spec_rounds_total",
                                                       path="sampled")
    ensure(rounds == st["decode_calls"]
           and v("spec_proposed_total") == st["proposed"]
           and v("spec_accepted_total") == st["accepted"]
           and v("spec_request_rounds_total") == st["rounds"],
           f"spec counters {rec.registry.find('spec_rounds_total')} vs "
           f"{st}")
    rate = v("spec_accepted_total") / max(1, v("spec_proposed_total"))
    ensure(rate == eng.acceptance_rate,
           f"recorded acceptance {rate} != {eng.acceptance_rate}")
    ensure(FV.LAUNCHES.n == cfg.num_layers * st["decode_calls"],
           f"observed spec: verify launches {FV.LAUNCHES.n}")
    ensure(validate_prometheus(rec.to_prometheus()) == [],
           "spec metrics invalid")
    n_tok = sum(len(x.generated) for x in h)
    print(f"[observed] spec fused, 6 x 16 greedy: {n_tok / dt:.2f} tok/s; "
          f"spec_rounds_total {rounds:.0f} = stats decode_calls; proposed "
          f"{v('spec_proposed_total'):.0f}, accepted "
          f"{v('spec_accepted_total'):.0f} = stats; acceptance {rate:.4f} = "
          f"engine.acceptance_rate; rollback pages "
          f"{v('serve_pages_rollback_total'):.0f}", flush=True)
    del eng
    torch.cuda.empty_cache()


def http_phase(torch, eng, rec, cfg, plain_streams, counters):
    """``AsyncServer`` on 127.0.0.1:0 over the observed 40-layer engine: 4
    concurrent streaming clients give phase 5's streams, ``/metrics``
    validates, ``/slo`` and ``/healthz`` answer, and a client that walks
    away mid-stream has its request cancelled."""
    import asyncio
    from repro_torch.serving import AsyncServer, validate_prometheus

    async def request(port, method, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps(body).encode() if body is not None else b""
        head = f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
        if payload:
            head += f"Content-Length: {len(payload)}\r\n"
        writer.write(head.encode() + b"\r\n" + payload)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, val = line.decode().partition(":")
            hdrs[k.strip().lower()] = val.strip()
        return reader, writer, status, hdrs

    async def chunk(reader):
        n = int((await reader.readline()).strip() or b"0", 16)
        if n == 0:
            return None
        data = await reader.readexactly(n)
        await reader.readline()
        return data

    async def body(reader, hdrs):
        if hdrs.get("transfer-encoding") != "chunked":
            return await reader.readexactly(int(hdrs["content-length"]))
        out = b""
        while (c := await chunk(reader)) is not None:
            out += c
        return out

    async def generate(port, prompt):
        r, w, status, hdrs = await request(
            port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new_tokens": 16})
        ensure(status == 200, f"generate: HTTP {status}")
        recs = [json.loads(x) for x in (await body(r, hdrs)).splitlines()]
        w.close()
        ensure(recs[-1].get("done") is True
               and [x["token"] for x in recs[:-1]] == recs[-1]["tokens"],
               "generate: the stream and its final record differ")
        return recs[-1]["tokens"]

    server = AsyncServer(eng, host="127.0.0.1", port=0)
    reps = prompts(cfg.vocab_size, 4)

    async def main():
        await server.start()  # raises if the socket cannot bind
        try:
            t0 = time.perf_counter()
            got = await asyncio.gather(*(generate(server.port, p)
                                         for p in reps))
            dt = time.perf_counter() - t0
            r, w, status, hdrs = await request(server.port, "GET", "/metrics")
            text = (await body(r, hdrs)).decode()
            w.close()
            ensure(status == 200 and validate_prometheus(text) == [],
                   f"GET /metrics: {status}")
            r, w, status, hdrs = await request(server.port, "GET", "/slo")
            slo = json.loads(await body(r, hdrs))
            w.close()
            ensure(status == 200 and slo["ttft_samples"] > 0,
                   f"GET /slo: {status}")
            r, w, status, hdrs = await request(server.port, "GET",
                                               "/healthz")
            ensure(status == 200 and await body(r, hdrs) == b"ok\n",
                   f"GET /healthz: {status}")
            w.close()
            before = rec.registry.value("serve_requests_cancelled_total")
            r, w, status, _ = await request(
                server.port, "POST", "/v1/generate",
                {"prompt": reps[0], "max_new_tokens": 100})
            ensure(status == 200 and await chunk(r) is not None,
                   "disconnect: no first token")
            w.close()  # walk away mid-stream
            for _ in range(1000):
                if not eng.has_work:
                    break
                await asyncio.sleep(0.01)
            cancelled = (rec.registry.value("serve_requests_cancelled_total")
                         - before)
            return got, dt, slo, cancelled
        finally:
            await server.stop()

    from repro_torch.kernels import fused_lutmu as FL
    reset_counts(counters)
    calls0 = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
    got, dt, slo, cancelled = asyncio.run(main())
    calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"] - calls0
    ensure(FL.LAUNCHES.n == 3 * cfg.num_layers * calls,
           f"HTTP serve: fused_lutmu launches {FL.LAUNCHES.n} for {calls} "
           "calls")
    ensure(got == plain_streams[:4],
           "HTTP streams differ from the offline streams")
    ensure(cancelled == 1 and not eng.has_work,
           f"disconnect: {cancelled} requests cancelled, work left "
           f"{eng.has_work}")
    n_tok = sum(map(len, got))
    print(f"[http] AsyncServer on 127.0.0.1:{server.port}, 4 concurrent "
          f"streaming clients x 16 tokens over the 40-layer engine: "
          f"{n_tok / dt:.2f} tok/s served ({dt:.3f}s); streams equal the "
          f"offline ones; /metrics valid, /slo (window tok/s "
          f"{slo['tok_s']:.2f}, TTFT p50 {1e3 * slo['ttft_p50_s']:.1f} ms) "
          f"and /healthz answer; a client that disconnected was cancelled",
          flush=True)


def quality_phase(torch, ucfg, uparams, load_engine, counters, ME, LA):
    """The 4-layer unfused serve (full width) with a quality probe at rate
    1.0 holding dense bf16 MLP weights: the streams of the same run with
    the probe off, no probe errors, rel-error histograms for gate, up and
    down.  The probe's replays launch the encode and aggregate kernels
    eagerly, counted here and reset after."""
    from repro_torch.serving import QualityProbe, Recorder
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    L, d, ff = ucfg.num_layers, ucfg.d_model, ucfg.d_ff
    dense = {"layers": {"mlp": {
        name: torch.randn(shape, generator=gen, device=DEVICE,
                          dtype=torch.bfloat16).mul_(shape[1] ** -0.5)
        for name, shape in (("w_gate", (L, d, ff)), ("w_up", (L, d, ff)),
                            ("w_down", (L, ff, d)))}}}
    want, _, _, eng = serve(torch, ucfg, uparams, load_engine, 3, 8)
    want = [list(x.generated) for x in want]
    del eng
    rec = Recorder(trace=False)
    rec.quality = QualityProbe(rec.registry, rate=1.0, dense_params=dense)
    eng = load_engine(None, uparams, ucfg, compute_dtype=torch.bfloat16,
                      device=DEVICE, recorder=rec, **ENGINE_KNOBS)
    reset_counts(counters)
    h, dt, _, eng = drive(torch, eng, ucfg, 3, 8, after_warm_up=rec.reset)
    calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
    v = rec.registry.value
    probes = v("quality_probes_total")
    ensure([x.generated for x in h] == want,
           "probe on: streams differ from the probe-off run")
    ensure(v("quality_probe_errors_total") == 0 and probes == 3,
           f"quality probe: {v('quality_probe_errors_total')} errors, "
           f"{probes} probes")
    rel = {dict(m.labels)["proj"]: m for m in rec.registry.find(
        "quality_rel_error") if m.count}
    ensure(set(rel) == {"gate", "up", "down"},
           f"rel-error histograms cover {sorted(rel)}")
    # 3 projections per layer per forward: the engine's calls, replayed,
    # and the probes' eager forwards
    ensure(ME.LAUNCHES.n == LA.LAUNCHES.n == 3 * L * (calls + probes),
           f"quality: encode {ME.LAUNCHES.n} aggregate {LA.LAUNCHES.n} for "
           f"{calls} calls + {probes:.0f} probes")
    snap = rec.quality.snapshot()
    sat = {k: round(x["fraction"], 5) for k, x in snap["saturation"].items()
           if k.startswith("0/")}
    means = {p: round(m.mean, 4) for p, m in sorted(rel.items())}
    print(f"[quality] 4 layers, unfused, probe rate 1.0 with dense bf16 "
          f"reference: streams equal the probe-off run; {probes:.0f} probes, "
          f"{v('quality_probe_tokens_total'):.0f} tokens, 0 errors; mean "
          f"rel error {means} (random tables); layer 0 buckets "
          f"{snap['layers']['0']['buckets']}, saturation {sat}; encode + "
          f"aggregate launches {ME.LAUNCHES.n} + {LA.LAUNCHES.n} = 12 x "
          f"({calls} calls + {probes:.0f} probes)", flush=True)
    reset_counts(counters)
    del eng, dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 22-24: the paper's case studies and the training runtime
# ---------------------------------------------------------------------------


def _events_ms(torch, fn, iters: int = 3) -> float:
    """Mean CUDA-event ms of ``fn`` over ``iters`` calls after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def case_mlp_phase(torch, mods, counters):
    """22. The SFC MLP of the paper's Table I on synthetic MNIST, on the
    card: trained, compiled at int8 and float32 (``mlp_to_amm``), the
    float32 chain retrained (``retrain_chain``: the encode kernel once and
    the aggregate kernel every step of each stage); accuracies; the int8
    chain layer by layer bit-equal to ``backend="ref"``, the retrained
    chain within ``FLOAT_RTOL``/``FLOAT_ATOL``; the int8 chain's forward
    through ``fused_lutmu`` (one launch per layer, counts set to 0 just
    before)."""
    from repro_torch.core import lut_mu as LM
    from repro_torch.data import synthetic_mnist
    from repro_torch.models import cnn
    FL, ME, LA, dispatch = mods
    t0 = time.perf_counter()
    x, y = synthetic_mnist(4096, seed=0)
    xt, yt, x, y = x[3072:], y[3072:], x[:3072], y[:3072]
    cfg = cnn.MLPConfig(sizes=CHAIN_WIDTHS)
    n = len(cfg.sizes) - 1
    params = cnn.mlp_train(cfg, x, y, steps=300, lr=0.1, device="cuda")
    books = [s // CHAIN_D_SUB for s in cfg.sizes[:-1]]
    depths = [CHAIN_DEPTH] * n
    t_train = time.perf_counter() - t0
    chains = {q: cnn.mlp_to_amm(params, cfg, x[:CHAIN_CALIB], books, depths,
                                quantize_int8=q) for q in (True, False)}
    t_fit = time.perf_counter() - t0 - t_train
    ws = [params[f"w{i}"] for i in range(n)]
    bs = [params[f"b{i}"] for i in range(n)]
    reset_counts(counters)
    retrained = LM.retrain_chain(chains[False], ws, bs, x[:CHAIN_CALIB],
                                 steps=150)
    torch.cuda.synchronize()
    ensure(ME.LAUNCHES.n == n and LA.LAUNCHES.n == n * 150 + n - 1
           and dispatch.REF_ON_CUDA.n == 0,
           f"retrain_chain launches: encode {ME.LAUNCHES.n}, aggregate "
           f"{LA.LAUNCHES.n} for {n} stages x 150 steps")
    retrain_launches = (ME.LAUNCHES.n, LA.LAUNCHES.n)
    t_retrain = time.perf_counter() - t0 - t_train - t_fit
    acc = {"exact": cnn.mlp_accuracy(lambda b: cnn.mlp_forward(params, b, n),
                                 xt, yt),
           "int8": cnn.mlp_accuracy(lambda b: chains[True](b), xt, yt),
           "float32": cnn.mlp_accuracy(lambda b: chains[False](b), xt, yt),
           "retrained": cnn.mlp_accuracy(lambda b: retrained(b), xt, yt)}
    ensure(acc["exact"] > 0.9, f"exact SFC MLP accuracy {acc['exact']}")
    xb = torch.from_numpy(xt[:CHAIN_BATCH]).cuda()
    errs = {}
    for label, chain, exact in (("int8", chains[True], True),
                                ("retrained", retrained, False)):
        h = xb
        worst = 0.0
        for i, layer in enumerate(chain.layers):
            apply = layer.apply_package if i > 0 else layer.__call__
            got, want = apply(h), apply(h, backend="ref")
            torch.cuda.synchronize()
            worst = max(worst, (got - want).abs().max().item())
            if exact:
                ensure(torch.equal(got, want),
                       f"{label} layer {i}: kernel != ref (max err {worst})")
            else:
                torch.testing.assert_close(got, want, rtol=FLOAT_RTOL,
                                           atol=FLOAT_ATOL,
                                           msg=f"{label} layer {i}")
            h = torch.relu(want) if i < n - 1 else want
        errs[label] = worst
    reset_counts(counters)
    out = chains[True](xb)
    torch.cuda.synchronize()
    launches = FL.LAUNCHES.n
    ensure(launches == n and dispatch.REF_ON_CUDA.n == 0
           and tuple(out.shape) == (CHAIN_BATCH, 10)
           and bool(torch.isfinite(out).all()),
           f"SFC int8 forward: fused_lutmu {launches}, ref "
           f"{dispatch.REF_ON_CUDA.n}")
    ms = _events_ms(torch, lambda: chains[True](xb), 10)
    print(f"[case-mlp] SFC {'-'.join(map(str, CHAIN_WIDTHS))} on synthetic "
          f"MNIST: train {t_train:.2f}s (300 SGD steps), mlp_to_amm int8 + "
          f"float32 {t_fit:.2f}s, retrain_chain 150 steps/stage "
          f"{t_retrain:.2f}s (encode {retrain_launches[0]}, aggregate "
          f"{retrain_launches[1]} launches); accuracy exact "
          f"{acc['exact']:.4f} int8 {acc['int8']:.4f} float32 "
          f"{acc['float32']:.4f} retrained {acc['retrained']:.4f}; layer by "
          f"layer vs ref: int8 bit-equal, retrained max err "
          f"{errs['retrained']:.3g}; int8 forward B={CHAIN_BATCH}: "
          f"fused_lutmu {launches} launches, {ms:.4f} ms; LUT bytes int8 "
          f"{chains[True].lut_bytes()} retrained {retrained.lut_bytes()}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"fused_lutmu": launches, "encode_onehot": retrain_launches[0],
            "lut_aggregate": retrain_launches[1]}


RESNET_IMAGES = 256            # images of the phase's forward
RESNET_CALIB = 32              # calibration images of the fit
RESNET_STEPS = 150             # SGD steps, batch 64


def case_resnet9_phase(torch, mods, counters):
    """23. ResNet-9 at its published widths on synthetic CIFAR, on the
    card: a few SGD steps; Kn2col LUT-MUs for conv1 … res2b (7 layers × 9
    taps) and Im2col for res1a/res1b; one forward of ``RESNET_IMAGES``
    images through the kernels (conv1's taps are 262,144 rows: past the
    old grid.y limit of ``lut_aggregate``) with 63 ``fused_lutmu``
    launches and no ``ref`` call (counts set to 0 just before); each
    substituted conv on the same input within ``FLOAT_RTOL``/
    ``FLOAT_ATOL`` of ``backend="ref"``; conv1's tap 0 quantised to int8
    on ``unfused`` at B = 262,144 bit-equal to ``ref``."""
    from repro_torch.core import conv as CV
    from repro_torch.core import maddness as M
    from repro_torch.data import synthetic_cifar
    from repro_torch.kernels.dispatch import lutmu_matmul
    from repro_torch.models import cnn
    FL, ME, LA, dispatch = mods
    t0 = time.perf_counter()
    x, y = synthetic_cifar(768 + RESNET_IMAGES, seed=0)
    xt, yt, x, y = x[768:], y[768:], x[:768], y[:768]
    cfg = cnn.ResNet9Config()
    params = cnn.resnet9_train(cfg, x, y, steps=RESNET_STEPS, batch=64,
                               device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    fns, fitted = cnn.resnet9_amm_conv_fns(params, x[:RESNET_CALIB])
    torch.cuda.synchronize()
    t_kn = time.perf_counter() - t0 - t_train
    im_layers = ["res1a", "res1b"]
    ifns, ifitted = cnn.resnet9_amm_conv_fns(params, x[:RESNET_CALIB],
                                             mode="im2col", layers=im_layers)
    torch.cuda.synchronize()
    t_im = time.perf_counter() - t0 - t_train - t_kn
    n_taps = sum(len(v) for v in fitted.values())
    ensure(n_taps == 63, f"{n_taps} Kn2col taps fitted, not 63")
    xd = torch.from_numpy(xt).cuda()
    reset_counts(counters)
    logits = cnn.resnet9_forward(params, xd, fns)
    torch.cuda.synchronize()
    launches = FL.LAUNCHES.n
    ensure(launches == 63 and dispatch.REF_ON_CUDA.n == 0
           and ME.LAUNCHES.n == 0 and LA.LAUNCHES.n == 0,
           f"Kn2col forward: fused_lutmu {launches}, ref "
           f"{dispatch.REF_ON_CUDA.n}, encode {ME.LAUNCHES.n}, aggregate "
           f"{LA.LAUNCHES.n}")
    ensure(tuple(logits.shape) == (RESNET_IMAGES, 10)
           and bool(torch.isfinite(logits).all()), "Kn2col logits")
    ms = _events_ms(torch, lambda: cnn.resnet9_forward(params, xd, fns))
    exact_ms = _events_ms(torch, lambda: cnn.resnet9_forward(params, xd))
    im_ms = _events_ms(torch, lambda: cnn.resnet9_forward(params, xd, ifns))
    acc = {"exact": cnn.mlp_accuracy(lambda b: cnn.resnet9_forward(params, b),
                                 xt, yt),
           "kn2col": float((logits.argmax(-1).cpu().numpy() == yt).mean()),
           "im2col": cnn.mlp_accuracy(
               lambda b: cnn.resnet9_forward(params, b, ifns), xt, yt)}
    # each substituted conv against the same taps on backend="ref", on the
    # exact network's input of that layer
    cap = cnn.capture_conv_inputs(params, xd)
    worst = {}
    for name, taps in list(fitted.items()) + [("im2col " + k, v) for k, v in
                                              ifitted.items()]:
        layer = name.split()[-1]
        h = cap[layer]
        if name.startswith("im2col"):
            got = ifns[layer](h, params[layer])
            want = CV.conv_im2col(h, params[layer], matmul=lambda a, _w, l=taps[0]:
                                  l(a, backend="ref"))
        else:
            got = fns[layer](h, params[layer])
            want = CV.conv_kn2col(h, params[layer], tap_matmuls=[
                lambda a, l=l: l(a, backend="ref") for l in taps])
        torch.cuda.synchronize()
        worst[name] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL, msg=name)
    # conv1's tap 0 at int8 on unfused: 262,144 rows
    tap = fitted["conv1"][0].params
    q, scale, offset = M.quantize_lut_bits(tap.lut, 8, tap.lut_offset)
    qp = M.MaddnessParams(tap.tree, None, q.contiguous(), scale, offset)
    rows = CV.im2col_patches(cap["conv1"], 3)[..., :cap["conv1"].shape[-1]]
    rows = rows.reshape(-1, cap["conv1"].shape[-1]).contiguous()
    reset_counts(counters)
    got = lutmu_matmul(rows, qp, backend="unfused")
    torch.cuda.synchronize()
    agg = (ME.LAUNCHES.n, LA.LAUNCHES.n)
    want = lutmu_matmul(rows, qp, backend="ref")
    ensure(rows.shape[0] == 262_144 and agg == (1, 1)
           and torch.equal(got, want),
           f"lut_aggregate at B={rows.shape[0]}: launches {agg}, max err "
           f"{(got - want).abs().max().item()}")
    kn_bytes = sum(l.lut_bytes() for k in im_layers for l in fitted[k])
    im_bytes = sum(l.lut_bytes() for v in ifitted.values() for l in v)
    print(f"[case-resnet9] widths {cfg.channels}, synthetic CIFAR: train "
          f"{t_train:.2f}s ({RESNET_STEPS} SGD steps, batch 64); fit Kn2col 63 taps "
          f"{t_kn:.2f}s, Im2col res1a/res1b {t_im:.2f}s; accuracy exact "
          f"{acc['exact']:.4f} kn2col {acc['kn2col']:.4f} im2col "
          f"{acc['im2col']:.4f} ({RESNET_IMAGES} held-out images); forward "
          f"of {RESNET_IMAGES} images: kn2col {ms:.3f} ms (fused_lutmu "
          f"{launches} launches, ref on CUDA 0), im2col {im_ms:.3f} ms, exact "
          f"{exact_ms:.3f} ms; res1a+res1b LUT bytes kn2col {kn_bytes} im2col "
          f"{im_bytes}; each conv vs ref max err "
          f"{max(worst.values()):.3g}; lut_aggregate int8 B=262144 on "
          f"unfused bit-equal to ref; {time.perf_counter() - t0:.1f}s",
          flush=True)
    return {"fused_lutmu": launches, "lut_aggregate": agg[1],
            "encode_onehot": agg[0]}


TRAIN_LAYERS = 2               # full-width training depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3


def train_phase(torch):
    """24. qwen3-14b at full width, depth cut to ``TRAIN_LAYERS``, bf16
    compute, ``grad_accum`` 2: ``TRAIN_STEPS`` steps of ``make_train_step``
    on ``TokenStream`` batches (ms per step, tokens/s, peak memory, loss);
    then ``Trainer.run`` at reduced width under deterministic algorithms,
    checkpoints every 5 steps, with and without one injected failure:
    ``recoveries == 1``, the losses bitwise equal, and the last checkpoint
    restored through ``restore_into`` equals the live state."""
    from repro_torch import pytree as T
    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-14b"), num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in T.leaves(state.params))
    step_fn = make_train_step(cfg, cosine_schedule(1e-4, 10, 100),
                              compute_dtype=torch.bfloat16)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_size=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ)
    times, losses = [], []
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in stream.batch(step).items()}
        torch.cuda.synchronize()
        s = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - s)
    ensure(all(math.isfinite(v) for v in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] qwen3-14b full width, {TRAIN_LAYERS} layers "
          f"({n_params / 1e9:.3f} B params), bf16 compute, grad_accum "
          f"{cfg.grad_accum}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"{step_ms:.1f} ms/step after the first ({1e3 * times[0]:.1f} ms), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB, losses {[round(v, 4) for v in losses]}",
          flush=True)
    del state, step_fn, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()

    rcfg = get_config("qwen3-14b", reduced=True)
    rstream = TokenStream(vocab_size=rcfg.vocab_size, batch_size=4, seq_len=32)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def run(name, hook=None):
                tr = Trainer(rcfg, TrainerConfig(
                    str(Path(tmp) / name), ckpt_every=5, lr=3e-3,
                    warmup_steps=2, compute_dtype=torch.float32),
                    rstream.batch, failure_hook=hook, device="cuda")
                return tr, tr.run(12)

            crashed = {"done": False}

            def hook(step):
                if step == 7 and not crashed["done"]:
                    crashed["done"] = True
                    raise RuntimeError("injected node failure")

            t1, o1 = run("clean")
            t2, o2 = run("failed", hook)
            ensure(o2["recoveries"] == 1 and o1["recoveries"] == 0
                   and o2["final_step"] == 12,
                   f"recoveries {o2['recoveries']}, final {o2['final_step']}")
            replayed = [m["loss"] for m in t2.metrics_log if "loss" in m]
            ensure(len(replayed) == 12 + 2, f"{len(replayed)} losses logged")
            ensure(replayed[7:9] == replayed[5:7],
                   "replayed steps 5-6 differ from their first pass")
            final = replayed[:7] + replayed[9:]
            ensure(final == o1["losses"],
                   f"losses after recovery {final} != {o1['losses']}")
            ensure(o1["losses"][-1] < o1["losses"][0], "loss did not fall")
            back = restore_into(t2.state, Path(tmp) / "failed" /
                                "step_00000012")
            ensure(all(torch.equal(a, b) for a, b in zip(
                T.leaves(back), T.leaves(t2.state))),
                   "restored checkpoint != live state")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[train] Trainer.run at reduced width, 12 steps, checkpoint every "
          f"5: one injected failure at step 7, recoveries "
          f"{o2['recoveries']}, replayed from step 5; losses bitwise equal "
          f"to the uninjected run's "
          f"{o1['losses'][0]:.4f} -> {o1['losses'][-1]:.4f}; restore_into of "
          f"step 12 equals the live state; {time.perf_counter() - t0:.1f}s",
          flush=True)
    return {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gb": peak / 1e9}


def main() -> int:
    # cuBLAS reads this when it makes its first handle; the trainer's phase
    # (24) runs under deterministic algorithms, which raise without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.kernels import fused_verify as FV
    from repro_torch.kernels import lut_aggregate as LA
    from repro_torch.kernels import maddness_encode as ME
    from repro_torch.kernels import ref
    from repro_torch.models import model as MD
    from repro_torch.serving import SpeculativeEngine, load_engine
    from repro_torch.serving import sampling as S
    from repro_torch.serving import speculative as SPEC

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # every phase up to the compile phases reads an empty autotune cache of
    # its own, so each launch is the one its wrapper plans; nothing measures
    tune_dir = tempfile.TemporaryDirectory()
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(Path(tune_dir.name) / "serve.json")
    os.environ.pop("REPRO_AUTOTUNE", None)

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

    # 15. the threefry streams, card against CPU
    threefry_phase(torch, S)

    # 3. kernels
    timer = Timer(torch)
    kres = kernel_checks(torch, timer, (FL, ME, LA, ref))
    # 7. the verify-window kernel at the full-width shapes
    vres = verify_kernel_checks(torch, timer, FV)
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
    counters = (FL.LAUNCHES, ME.LAUNCHES, LA.LAUNCHES, dispatch.REF_ON_CUDA,
                FV.LAUNCHES, FV.PLAIN_ON_CUDA)
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
    print(f"[serve] step programs, captured by a first short request (not "
          f"timed): capture_s {fmt(engine.stats['capture_s'])}; graph nodes "
          f"{engine.stats['graph_nodes']}", flush=True)
    for h in handles:
        print(f"  req {h.request_id}: {h.prompt} -> {h.generated}")
    plain_streams = [list(h.generated) for h in handles]
    del engine, handles
    profile = profile_phase(torch, cfg, params, MD, load_engine)
    # 16. the same serve sampled, and the sampler's share of a step
    _, sampled_streams = sampled_serve_phase(torch, cfg, params, load_engine,
                                             counters, S, n_tok / dt)
    # 18. the serve observed (recorder, kernel profiler, dispatch hook), then
    # served over HTTP
    oeng, orec = observed_serve(torch, cfg, params, load_engine, counters,
                                plain_streams, sampled_streams, profile)
    http_phase(torch, oeng, orec, cfg, plain_streams, counters)
    del oeng, orec
    torch.cuda.empty_cache()
    # 14. each captured program against its eager model function
    graph_gate_phase(torch, cfg, params, MD, load_engine, SpeculativeEngine,
                     SPEC, S)

    # 8. fused verify step (kernel) against the scan oracle at full width
    verify_agree_phase(torch, cfg, params, MD, FV)

    # 9. speculative serve, 40 layers, bf16, spec_k=4, identical draft:
    # the scan oracle first (streams equal to plain, acceptance 1.0), then
    # the fused path through the verify kernel
    reset_counts(counters)
    sh, sdt, sttft, seng = spec_serve(torch, cfg, params, params,
                                      SpeculativeEngine, "scan", 6, 16)
    ensure([h.generated for h in sh] == plain_streams,
           "scan speculative streams differ from the plain engine's")
    ensure(seng.acceptance_rate == 1.0,
           f"identical draft accepted {seng.acceptance_rate}, not 1.0")
    ensure(FV.LAUNCHES.n == 0, "the scan oracle launched the verify kernel")
    print(spec_line("spec-scan", sh, sdt, sttft, seng,
                    torch.cuda.max_memory_allocated()) +
          "; streams equal to the plain engine's", flush=True)
    del seng, sh
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    fh, fdt, fttft, feng = spec_serve(torch, cfg, params, params,
                                      SpeculativeEngine, "fused", 6, 16)
    rounds = feng.stats["decode_calls"]
    launches["verify_window"] = FV.LAUNCHES.n
    ensure(FV.LAUNCHES.n == cfg.num_layers * rounds,
           f"verify kernel launches {FV.LAUNCHES.n} != {cfg.num_layers} x "
           f"{rounds} rounds")
    ensure(FV.PLAIN_ON_CUDA.n == 0 and dispatch.REF_ON_CUDA.n == 0,
           f"plain verify on CUDA {FV.PLAIN_ON_CUDA.n}, ref LUT-MU on CUDA "
           f"{dispatch.REF_ON_CUDA.n}")
    ensure(all(h.done and len(h.generated) == 16 for h in fh),
           "fused speculative requests did not finish")

    def make_plain(c=cfg, p=params):
        return load_engine(None, p, c, compute_dtype=torch.bfloat16,
                           device="cuda", **ENGINE_KNOBS)

    differ = compare_streams(torch, "spec-fused", fh, plain_streams, make_plain)
    print(spec_line("spec-fused", fh, fdt, fttft, feng,
                    torch.cuda.max_memory_allocated()) +
          f"; verify_window launches {FV.LAUNCHES.n} = {cfg.num_layers} x "
          f"{rounds} rounds; plain verify on CUDA 0; {differ} of {len(fh)} "
          "streams differ from the plain engine's", flush=True)
    del feng, fh
    # 18. the fused speculative serve observed
    observed_spec(torch, cfg, params, SpeculativeEngine, FV, counters)
    # 17. sampled speculative serve, identical draft, scan then fused
    sampled_spec_phase(torch, cfg, params, SpeculativeEngine, FV, counters)
    del params, make_plain  # the closure holds the 40-layer params too
    gc.collect()
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
    # the same requests through the plain LUT-MU path: int8 sums are exact,
    # so the streams must be equal
    rcfg = dataclasses.replace(ucfg, amm=dataclasses.replace(ucfg.amm,
                                                             backend="ref"))
    rh = eager_streams(torch, MD, uparams, rcfg, prompts(ucfg.vocab_size, 2),
                       4)
    ensure([h.generated for h in uh] == rh,
           "unfused streams differ from the plain LUT-MU path's")
    print(f"[unfused] 4 layers, 2 requests x 4 tokens in {udt:.3f}s; "
          f"encode_onehot {launches['encode_onehot']} + lut_aggregate "
          f"{launches['lut_aggregate']} launches = 12 x {ucalls} calls; "
          "streams equal to the plain LUT-MU path's (called eagerly)",
          flush=True)
    del ueng
    # 18. the quality probe on the unfused 4-layer serve
    quality_phase(torch, ucfg, uparams, load_engine, counters, ME, LA)

    # 10. speculative rounds with rejection and rollback, full width, depth
    # cut to 4 layers: a garbage draft (other LUT tables, same backbone) on
    # bf16 KV, then on the int8 KV cache
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    other = MD.init_params(cfg4, torch.Generator(device="cuda").manual_seed(2),
                           torch.bfloat16, serving=True)
    dparams = dict(uparams, layers=dict(uparams["layers"],
                                        amm_mlp=other["layers"]["amm_mlp"]))
    del other
    cfg4_int8 = dataclasses.replace(cfg4, amm=dataclasses.replace(
        cfg4.amm, kv_int8=True))
    for label, c in (("spec-4layer-garbage", cfg4),
                     ("spec-4layer-int8kv", cfg4_int8)):
        ph, _, _, _ = serve(torch, c, uparams, load_engine, 4, 12)
        want = [list(h.generated) for h in ph]
        reset_counts(counters)
        gh, gdt, gttft, geng = spec_serve(torch, c, uparams, dparams,
                                          SpeculativeEngine, "fused", 4, 12)
        grounds = geng.stats["decode_calls"]
        ensure(FV.LAUNCHES.n == c.num_layers * grounds
               and FV.PLAIN_ON_CUDA.n == 0,
               f"{label}: verify launches {FV.LAUNCHES.n} for {grounds} rounds")
        ensure(geng.stats["corrections"] > 0,
               f"{label}: the garbage draft was never rejected")
        ensure(geng.kv.buffers["k"].dtype == (torch.int8 if c.amm.kv_int8
                                              else torch.bfloat16),
               f"{label}: cache dtype {geng.kv.buffers['k'].dtype}")
        differ = compare_streams(
            torch, label, gh, want,
            lambda c=c: load_engine(None, uparams, c, compute_dtype=torch.bfloat16,
                                    device="cuda", **ENGINE_KNOBS))
        print(spec_line(label, gh, gdt, gttft, geng,
                        torch.cuda.max_memory_allocated()) +
              f"; verify_window launches {FV.LAUNCHES.n}; {differ} of "
              f"{len(gh)} streams differ from the plain engine's", flush=True)
        del geng, gh
    del uparams, dparams
    torch.cuda.empty_cache()

    # 11. + 12. a bundle written to disk, its target half and the bundle
    # served from it
    alaunch = artifact_phase(torch, cfg, MD, (FL, FV, dispatch), counters,
                             load_engine, SpeculativeEngine)
    # 13. the SFC chain as an amm_chain artifact, int16 and int8
    timer = Timer(torch)
    claunch = chain_phase(torch, timer, (FL, ME, LA, dispatch), counters)
    del timer
    launches["fused_lutmu_int16"] = claunch["int16_fused_lutmu"]
    launches["lut_aggregate_int16"] = claunch["int16_lut_aggregate"]
    print(f"[launches] artifact/bundle/chain runs: {alaunch} {claunch}",
          flush=True)

    # 19. the offline compiler on the card: a fitted full-width bundle,
    # compiled, written, served; the same fit at reduced width, card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[compile] device memory in use before the compile: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    comp = compile_phase(torch, cfg, MD, (FL, FV, dispatch), counters,
                         load_engine, SpeculativeEngine)
    fit_card_vs_cpu(torch)
    # 20. + 21. measured plans, each phase into a cache of its own
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(Path(tune_dir.name) / "chain.json")
    chain_comp = compile_chain_phase(torch, (FL, dispatch), counters)
    timer = Timer(torch)
    tuned = autotune_phase(torch, timer, (FL, FV),
                           Path(tune_dir.name) / "autotune.json")
    del timer
    tune_dir.cleanup()
    print(f"[launches] compile runs: fitted target fused_lutmu "
          f"{comp['target_launches']}, fitted bundle verify_window "
          f"{comp['verify_launches']}, compiled chain fused_lutmu "
          f"{chain_comp['fused_lutmu']}", flush=True)

    # 22. + 23. the paper's case studies through the kernels; 24. training
    gc.collect()
    torch.cuda.empty_cache()
    t_case = time.perf_counter()
    case_mlp = case_mlp_phase(torch, (FL, ME, LA, dispatch), counters)
    case_res = case_resnet9_phase(torch, (FL, ME, LA, dispatch), counters)
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(torch)
    print(f"[case] phases 22-24 in {time.perf_counter() - t_case:.1f}s",
          flush=True)

    lutmu_shape = "down C=2176 N=5120, B=4, int8"
    int16_shape = "chain C=98 N=128, B=256, int16"

    def by_lut(res, int16):
        return {k: v for k, v in res.items() if (k[2] == "int16") == int16}

    # name: (source, TPU kernel, path, shape, results by case, reported case)
    sources = {"fused_lutmu": ("src/repro_torch/csrc/fused_lutmu.cu",
                               "src/repro/kernels/fused_lutmu.py:124", "auto",
                               lutmu_shape,
                               by_lut(kres["fused_lutmu"], False), JSON_CASE),
               "encode_onehot": ("src/repro_torch/csrc/maddness_encode.cu",
                                 "src/repro/kernels/maddness_encode.py:85",
                                 "unfused", lutmu_shape + " one-hot",
                                 kres["encode_onehot_int8"], JSON_CASE),
               "lut_aggregate": ("src/repro_torch/csrc/lut_aggregate.cu",
                                 "src/repro/kernels/lut_aggregate.py:96",
                                 "unfused", lutmu_shape,
                                 by_lut(kres["lut_aggregate"], False),
                                 JSON_CASE),
               "fused_lutmu_int16": ("src/repro_torch/csrc/fused_lutmu.cu",
                                     "src/repro/kernels/fused_lutmu.py:124",
                                     "amm_chain auto", int16_shape,
                                     by_lut(kres["fused_lutmu"], True),
                                     INT16_JSON_CASE),
               "lut_aggregate_int16": ("src/repro_torch/csrc/lut_aggregate.cu",
                                       "src/repro/kernels/lut_aggregate.py:96",
                                       "amm_chain unfused", int16_shape,
                                       by_lut(kres["lut_aggregate"], True),
                                       INT16_JSON_CASE),
               "verify_window": ("src/repro_torch/csrc/verify_window.cu",
                                 "src/repro/kernels/fused_verify.py:281",
                                 "speculative",
                                 "B=4 W=5 n_kv=8 g=5 hd=128, S=128 (page_size "
                                 "16), bf16 KV", vres, VERIFY_JSON_CASE)}
    # the measured plan beside the heuristic's at the reported case
    measured = {"fused_lutmu": tuned[("fused_lutmu", "down", 4)],
                "verify_window": tuned[("verify_window", 128)]}
    # the case studies' shapes, and their launches per forward
    case_launches = {
        "fused_lutmu": {"sfc_int8_forward": case_mlp["fused_lutmu"],
                        "resnet9_kn2col_forward": case_res["fused_lutmu"]},
        "encode_onehot": {"sfc_retrain_chain": case_mlp["encode_onehot"],
                          "conv1_tap_unfused": case_res["encode_onehot"]},
        "lut_aggregate": {"sfc_retrain_chain": case_mlp["lut_aggregate"],
                          "conv1_tap_unfused": case_res["lut_aggregate"]}}
    entries = []
    for name, (src, replaces, path, shape, res, case) in sources.items():
        r = res[case]
        m = measured.get(name)
        cnn = {}
        if name in case_launches:
            cnn = {"cnn_cases": {
                f"{k[0]} B={k[1]} {k[2]}": {
                    f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "max_abs_err")}
                for k, v in kres[name].items() if k[0] in CNN_PROJ},
                "case_launches": case_launches[name]}
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name], "path": path,
            "shape": shape,
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("floor_ms", "device_ms") if k in r},
            **({} if m is None else {
                "heuristic_plan": m["heuristic"], "measured_plan": m["measured"],
                "heuristic_plan_ms": m["heuristic_ms"],
                "measured_plan_ms": m["measured_ms"]}), **cnn})
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
