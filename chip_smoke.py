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
   ``ref`` LUT-MU path; whether the decode step's logits with its
   attention through the plain read (``paged_view`` + ``decode_attend``)
   are bit-identical to the kernel read's is printed;
5. serve — qwen3-14b at full width and depth (40 layers, bf16, random int8
   LUTs from a seeded generator on the card) through
   ``load_engine(None, ...)``: one short request captures the engine's
   step programs (CUDA graphs; capture seconds and graph nodes printed on
   their own line), then 6 greedy requests, 16 new tokens each, with every
   launch counter set to 0 just before (every engine run below starts the
   same way); ``fused_lutmu`` must launch 120 times per forward call,
   replays counted, and the ``ref`` path never; the decode read's kernel
   40 times per decode call and the plain decode read never on CUDA;
   then a decode step's host
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
   boolean mask, float only) times; (b) the paged decode read, the kernel
   at W = 1, at B=32, n_kv=8, g=5, hd=128 and rows of S=1,024 and 1,536
   (``DECODE_SHAPE``, ``DECODE_S``) under every split count the card runs,
   against the plain read on the CPU: int8 bit for bit, float within
   ``VERIFY_TOL``, and at the split count the decode path takes float bit
   for bit the plain read on the card; kernel, plain, bound and SDPA times
   (bf16);
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
24. train — under deterministic algorithms: qwen3-14b at full width,
    depth cut to 2 layers, bf16 compute, 4 × 128 ``TokenStream`` tokens, 3
    steps of ``make_train_step``: ms per step, tokens/s, peak memory,
    losses (the final state kept on the host for phase 27); then
    ``Trainer.run`` at reduced width, checkpoints every 5 steps, one
    injected failure: one recovery, losses bitwise equal to an uninjected
    run's, the last checkpoint restored by ``restore_into`` equal to the
    live state.

25. families — (a, after 5) the fixed-slot engine on phase 5's 40-layer
    params: ``load_engine(None, ..., engine="fixed", max_batch=4)`` serves
    phase 5's 6 requests x 16 tokens, held to phase 5's streams by the
    ``STREAM_MARGIN_TOL`` rule, ``fused_lutmu`` 120 launches per forward
    (prefills eager, decodes replayed), ``ref`` never on CUDA; then 3+
    consecutive decode replays bit-equal to eager ``MD.decode_step`` on a
    copy of the cache (every slot's logits, the whole cache); tok/s, TTFT,
    capture seconds and graph nodes beside phase 5's.  (After 24:) (b)
    mamba2-370m at full width and depth, bf16, through the fixed engine
    (4 slots, 6 x 16 greedy, staggered): each stream equal to the request
    served alone through eager ``prefill`` + ``decode_step`` by the same
    rule, decode replays bit-equal to eager, and a 2,048-token chunked-SSD
    prefill of layer 0 (float32) against 2,048 ``mamba_decode_step``
    calls within ``SSD_STATE_TOL``; (c) qwen3-moe-30b-a3b at full width
    (128 experts, top-8), depth cut to ``MOE_LAYERS``, through the paged
    and the fixed engine (6 x 16 greedy each; their streams are not
    compared: capacity drops depend on the group size), every decode
    replay bit-equal to its eager model function, an eager decode step
    under ``set_sync_debug_mode("error")``, the MoE share of a replay's
    kernel time; (d) whisper-tiny whole (1,500 seeded frames) and
    internvl2-26b at full width, 2 layers (256 seeded patch embeddings),
    float32: ``make_prefill_step`` then 16 ``make_decode_step`` steps
    within ``TEACHER_REL`` of ``forward`` teacher-forced; (e) jamba-1.5-
    large at reduced width (a full-width period is ≈ 90 GB) with LUT-MU
    serving params through the fixed engine: ``fused_lutmu`` 3 launches
    per dense layer per forward, decode replays bit-equal to eager.  The
    phase's seconds on a line of their own.

26. mesh — (a, after 25 (a)) the sharded serving path on one card:
    ``make_serve_mesh("1x1", "cuda")`` (NCCL, world of one, a file store
    in a temporary directory), ``load_engine(None, ..., mesh=mesh)`` serves
    phase 5's 6 requests x 16 tokens: streams equal phase 5's,
    ``fused_lutmu`` 120 launches per forward, 3+ decode replays bit-equal
    to eager ``MD.paged_decode_step(..., par=...)``, the captured decode
    program's graph nodes beside phase 5's and the NCCL kernels of one
    replay (profiler); tok/s and TTFT beside phase 5's from the same call;
    in phase 25 (c) qwen3-moe-30b-a3b through the fixed engine on the same
    mesh, its replays bit-equal to eager.  (b, after 7) the per-shard
    LUT-MU problem at tp 2, 4, 8 at the main path's shapes (gate/up
    C=640 N=8704, down C=2176 N=5120; B 4 and 32; int8 and float32): each
    codebook shard through ``fused_lutmu`` and through ``encode_onehot`` +
    ``lut_aggregate`` with a unit epilogue, the partials summed on the card
    in rank order, then one epilogue: int8 bit-equal to the unsharded
    kernel, float32 within FLOAT_RTOL/ATOL; each per-shard kernel's ms
    (CUDA events, L2 flushed) beside the unsharded kernel's, the
    per-shard bound and the library call's (one ``torch.matmul`` of the
    shard's float32 one-hot × its LUT).

27. mesh-train — (after 24) (a) phase 24's full-width step through a 1×1
    NCCL mesh (``make_train_step(..., par=...)`` on ``shard_state``'s
    shards): the losses and the state after 3 steps bitwise phase 24's,
    both under deterministic algorithms; ms per step, tokens/s, peak
    memory of both, the collectives a step; then the one-device step once
    more (its ms beside the mesh's; its losses bitwise phase 24's); (b) the reduced ``Trainer`` on
    the mesh with one injected failure: one recovery, the losses bitwise
    phase 24's uninjected run's; ``remesh(mesh, shardings_fn)`` with
    ``state_shardings`` and the mesh's last checkpoint through
    ``restore_into`` equal the live state; (c) the dry-run of (a)'s cell
    on an abstract 1×1 mesh (``launch/dryrun.py``): its state bytes equal
    the live state's, arguments + temp beside (a)'s peak memory, its FLOPs
    over (a)'s step time as TFLOP/s and a share of the 989 TFLOP/s bf16
    peak; then one line per qwen3-14b cell on 16×16 from the dry-run run
    on the host in a process of its own (started after (a)): per-rank
    GiB against 80, FLOPs, collective bytes, the roofline's bound.

28. mamba-tp — (after 25 (b)-(e)) tensor parallelism inside the Mamba
    block: (a) mamba2-370m at full width and depth, bf16, through the
    fixed engine on a 1×1 NCCL mesh (the block's stages and collectives
    at tp 1): streams equal 25 (b)'s, 3+ decode replays bit-equal to
    eager ``decode_step(..., par=)``, 146 collectives a decode step; tok/s,
    graph nodes, the decode replay's ms and an 8-token eager prefill
    through the mesh and without it, beside 25 (b)'s; then reduced jamba
    with LUT-MU on the mesh: 25 (e)'s streams, ``fused_lutmu`` 3 launches
    per dense layer per forward, replays bit-equal; (b) one full-width
    mamba2-370m layer and one full-width jamba Mamba layer cut for tp 2,
    4, 8 and 16 (``shard_params`` on an abstract mesh, rank by rank), the
    ranks' stages chained in rank order (``mamba_forward_split`` /
    ``mamba_decode_split``): a 2,048-token prefill and 3 decode steps of
    8 rows against the whole block, float32 within ``MTP_F32_REL``
    (the prefill's outputs ``MTP_F32_SSD_REL``) and bf16 within the whole
    bf16 block's own distance plus ``MTP_BF16_STEP`` a rounding the split
    adds; each rank's state bytes exactly whole/tp; rank 0's bf16 decode
    step alone (``RankAlone``) and the whole block's, each one replayed
    CUDA graph (CUDA events, L2 flushed), in turns, beside bytes ÷ 3.35
    TB/s; (c) the 4-layer full-width mamba2-370m train step, bf16
    compute, two steps through the 1×1 mesh beside one device under
    deterministic algorithms: losses and state bitwise; ms per step;
    (d) the 16×16 dry-run of mamba2-370m and jamba (host processes of
    their own, at the lowest priority, started with 27 (c)'s): per-rank
    arguments equal to JAX's rule, beside the figures before Mamba TP.

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
DECODE_SHAPE = (32, 8, 5, 128, 16)       # B, n_kv, g, hd, page_size: the
                                         # paged decode read of batch-decode
DECODE_S = ((1024, 128), (1536, 64))     # (S, lowest pos): batch-decode's
                                         # and chat-open's tables
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


def decode_inputs(torch, s_len: int, lo: int, kv_name: str, gen):
    """The decode read's inputs at batch-decode's shape (DECODE_SHAPE): B
    rows whose positions spread evenly over ``[lo, S)``, every table entry
    a page of the pool in random order, q bf16-valued float32 (the serve
    path's ``qg``)."""
    b, nkv, g, hd, ps = DECODE_SHAPE
    mp = s_len // ps
    shape = (b * mp + 1, ps, nkv, hd)
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
    pos = torch.linspace(lo, s_len - 1, b, device="cuda").round().to(torch.int32)
    q = (torch.randn((b, 1, nkv, g, hd), generator=gen, device="cuda") * 2.0
         ).to(torch.bfloat16).float()
    return q, kp, vp, pt, pos


def decode_read_checks(torch, timer, FV):
    """7 (b): the paged decode step's attention read at batch-decode's and
    chat-open's shapes (DECODE_SHAPE, DECODE_S): the verify kernel at W = 1
    under every split count the card runs against the plain read
    (``paged_view`` + ``decode_attend``) computed on the CPU, bf16,
    float32 and int8 pages: int8 bit for bit (the plain read on the card,
    unlike the CPU's, moves a few int8 weights of long rows by a step),
    float within VERIFY_TOL; max abs difference and share of
    outputs bit-equal to the CPU's and to the card's plain read, the float
    read at the split count taken bit for bit the card's; times.  The bound is the bytes of the positions each row reaches
    (``pos + 1``), q, out, the table and pos; the library column one SDPA
    over the gathered bf16 view with the same mask.  Returns ``{(kv, S):
    row}`` of the split count the decode path takes."""
    import torch.nn.functional as F
    b, nkv, g, hd, ps = DECODE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(31)
    results = {}
    for s_len, lo in DECODE_S:
        for kv_name in ("bfloat16", "float32", "int8"):
            q, kp, vp, pt, pos = decode_inputs(torch, s_len, lo, kv_name, gen)
            pos64 = pos.long()

            def plain():
                return FV.decode_attend(q, *FV.paged_view(kp, vp, pt), pos64,
                                        None)

            on_card = plain()
            want = FV.decode_attend(q.cpu(), *FV.paged_view(
                kp.cpu(), vp.cpu(), pt.cpu()), pos64.cpu(), None).cuda()
            taken = FV.heuristic_splits(b, 1, nkv, g, hd, ps, s_len, kp.dtype)
            positions = int((pos64 + 1).sum())
            nbytes = (2 * positions * nkv * hd * kp.element_size()
                      + 2 * q.numel() * 4 + pt.numel() * 4 + pos.numel() * 4)
            bms, by = bound_ms(nbytes, 2 * 2 * g * hd * positions * nkv,
                               PEAK_OPS[kv_name])
            timed = kv_name == "bfloat16"
            plain_ms = timer.ms(plain, 3) if timed else None
            library_ms = None
            if timed:
                k_view, v_view = FV.paged_view(kp, vp, pt)
                kq = k_view.permute(0, 2, 1, 3).contiguous()
                vq = v_view.permute(0, 2, 1, 3).contiguous()
                qq = q.reshape(b, nkv, g, hd).to(kp.dtype)
                mask = (torch.arange(s_len, device="cuda")[None, :]
                        <= pos64[:, None])[:, None, None, :]
                library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                    qq, kq, vq, attn_mask=mask), 20)
                del k_view, v_view, kq, vq, qq, mask
            for splits in range(1, 9):
                if FV.max_clusters(kp.dtype, 1, g, hd, ps, splits,
                                   FV.split_cap(s_len, splits)) < 1:
                    continue
                if not timed and splits != taken:
                    continue

                def kernel(n=splits):
                    return FV.decode_attend_paged_cuda(q, kp, vp, pt, pos,
                                                       None, splits=n)

                got = kernel()
                torch.cuda.synchronize()
                ensure(bool(torch.isfinite(got).all()),
                       f"decode read {kv_name} S={s_len}: non-finite")
                err = (got - want).abs().max().item()
                if kv_name == "int8":
                    ensure(torch.equal(got, want), f"decode read int8 S={s_len}"
                           f" splits {splits}: not bitwise the plain read, max "
                           f"abs err {err}")
                ensure(err <= VERIFY_TOL[kv_name], f"decode read {kv_name} "
                       f"S={s_len} splits {splits}: max abs err {err}")
                share = (got == want).float().mean().item()
                card_share = (got == on_card).float().mean().item()
                if splits == taken and kv_name != "int8":
                    # the served model's logits are a plain reference's bit
                    # for bit only if this read is the card's plain read's
                    ensure(card_share == 1.0, f"decode read {kv_name} "
                           f"S={s_len}: {card_share:.6f} of the outputs "
                           "bit-equal to the plain read on the card")
                ms = timer.ms(kernel, 20)
                r = dict(splits=splits, taken=splits == taken, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms, max_abs_err=err,
                         equal_share=share, card_equal_share=card_share)
                if splits == taken:
                    results[(kv_name, s_len)] = r
                lib = "null" if library_ms is None else f"{library_ms:.4f}"
                pms = "null" if plain_ms is None else f"{plain_ms:.4f}"
                print(f"[decode-read] B={b} W=1 n_kv={nkv} g={g} hd={hd} "
                      f"S={s_len} pos {lo}-{s_len - 1} {kv_name:8s} splits="
                      f"{splits}{' (taken)' if splits == taken else ''} "
                      f"kernel_ms={ms:.4f} plain_ms={pms} bound_ms={bms:.4f} "
                      f"({by}) library_ms={lib} max_abs_err={err:.3g} "
                      f"bit_equal={share:.6f} (card's plain read "
                      f"{card_share:.6f})", flush=True)
            del q, kp, vp, pt, pos, want, on_card
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
    chunk's and a decode step's logits must be bit-identical.  Then the
    decode step once more with its attention read through the plain read
    (``paged_view`` + ``decode_attend``) instead of the kernel: whether
    its logits are bit-identical is printed, and how far they lie apart."""
    from repro_torch.models import attention as A
    out = {}
    for backend in ("fused", "ref", "plain-read"):
        read = A.decode_read
        if backend == "plain-read":
            A.decode_read = lambda device, par: "plain"
        c = dataclasses.replace(cfg, amm=dataclasses.replace(
            cfg.amm, backend="ref" if backend == "ref" else "fused"))
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
        A.decode_read = read
        out[backend] = (pf, dec[0])
        del cache
    ensure(torch.equal(out["fused"][0], out["ref"][0]),
           "prefill logits: kernels != plain path")
    ensure(torch.equal(out["fused"][1], out["ref"][1]),
           "decode logits: kernels != plain path")
    got, want = out["fused"][1], out["plain-read"][1]
    same = torch.equal(got, want)
    print("[agree] full-width prefill chunk + decode step: kernel logits "
          "bit-identical to the plain LUT-MU path; decode logits through the "
          f"decode-read kernel {'bit-identical to' if same else 'differ from'}"
          f" the plain read's (max abs diff "
          f"{(got - want).abs().max().item():.4g}, argmax "
          f"{'equal' if int(got.argmax()) == int(want.argmax()) else 'differs'})",
          flush=True)


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
          f"mean {1e3 * dec['mean_s']:.3f} ms (n={dec['count']}; CUDA events "
          f"inside the program, no sync) against the profile phase's decode "
          f"replay "
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


def full_width_steps(torch, step_fn, state, cfg):
    """``TRAIN_STEPS`` steps of ``step_fn`` on ``TokenStream`` batches:
    ``(state, losses, ms per step after the first, first step's ms)``."""
    from repro_torch.data import TokenStream
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
    return (state, losses, 1e3 * sum(times[1:]) / (len(times) - 1),
            1e3 * times[0])


def train_phase(torch):
    """24. qwen3-14b at full width, depth cut to ``TRAIN_LAYERS``, bf16
    compute, ``grad_accum`` 2: ``TRAIN_STEPS`` steps of ``make_train_step``
    on ``TokenStream`` batches (ms per step, tokens/s, peak memory, loss);
    then ``Trainer.run`` at reduced width, checkpoints every 5 steps, with
    and without one injected failure: ``recoveries == 1``, the losses
    bitwise equal, and the last checkpoint restored through
    ``restore_into`` equals the live state.  All under deterministic
    algorithms (phase 27 holds the sharded step to this one bit for bit).
    Returns the step's numbers, its losses and its final state on the
    host, and the uninjected ``Trainer`` run's losses."""
    from repro_torch import pytree as T
    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        cfg = dataclasses.replace(get_config("qwen3-14b"),
                                  num_layers=TRAIN_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(t.numel() for t in T.leaves(state.params))
        step_fn = make_train_step(cfg, cosine_schedule(1e-4, 10, 100),
                                  compute_dtype=torch.bfloat16)
        state, losses, step_ms, first_ms = full_width_steps(
            torch, step_fn, state, cfg)
        peak = torch.cuda.max_memory_allocated()
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"[train] qwen3-14b full width, {TRAIN_LAYERS} layers "
              f"({n_params / 1e9:.3f} B params), bf16 compute, grad_accum "
              f"{cfg.grad_accum}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
              f"deterministic algorithms: {step_ms:.1f} ms/step after the "
              f"first ({first_ms:.1f} ms), {tokens / step_ms * 1e3:.1f} "
              f"tokens/s, peak memory {peak / 1e9:.2f} GB, losses "
              f"{[round(v, 4) for v in losses]}", flush=True)
        host = T.map_tree(lambda t: t.to("cpu", copy=True), state)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        rcfg = get_config("qwen3-14b", reduced=True)
        rstream = TokenStream(vocab_size=rcfg.vocab_size, batch_size=4,
                              seq_len=32)
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
            "peak_gb": peak / 1e9, "losses": losses, "state": host,
            "trainer_losses": o1["losses"], "cfg": cfg}


# ---------------------------------------------------------------------------
# phase 27: training on a device mesh, and the dry-run
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "qwen3-14b"      # the 16x16 dry-run's cells, run on the host
# phase 28 (d)'s: the Mamba families' cells on 16x16
DRYRUN_MAMBA_ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
# its per-rank GiB before the serving state was placed by the JAX rules
# (recorded in PERF.md §6)
DRYRUN_BEFORE = {"train_4k": 110.32, "prefill_32k": 873.89,
                 "decode_32k": 41.65}


def start_dryrun(arch: str = DRYRUN_ARCH):
    """``python -m repro_torch.launch.dryrun --arch ARCH --force`` (its
    cells on 16x16, written to ``dryrun_results_torch/`` in the checkout),
    in a process of its own on the host (CPU only; started after phase 27
    (a)'s timed steps, one process per arch, one thread each).  The caller
    ends it."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    # at the lowest priority, so the phases timed meanwhile keep the host
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--force"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(19))


def end_dryrun(proc, timeout: float) -> str:
    """Wait for a ``start_dryrun`` process (killing it after ``timeout``
    seconds); its log.  Fails if it failed."""
    try:
        log, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ensure(proc.returncode == 0, f"a 16x16 dry-run failed:\n{log[-3000:]}")
    return log


def mesh_train_phase(torch, p24, smi, dry):
    """27. (a) phase 24's full-width step through a 1x1 NCCL mesh (the
    sharded step, ``par``): losses and the state after the steps bitwise
    phase 24's, both under deterministic algorithms; (b) the reduced
    ``Trainer`` on the mesh, one injected failure: one recovery, losses
    bitwise phase 24's uninjected run's; ``remesh`` with
    ``state_shardings`` round trip and a checkpoint written from the mesh
    read back by ``restore_into`` equal the live state; (c) the dry-run of
    (a)'s cell on an abstract 1x1 mesh: its argument bytes equal the live
    state's, its FLOPs over (a)'s step time; the 16x16 cells of
    ``DRYRUN_ARCH`` from the host process (``start_dryrun``, kept in
    ``dry["proc"]``) started after (a), beside phase 28 (d)'s (kept in
    ``dry`` by arch for phase 28; the caller ends what is left)."""
    from repro_torch import pytree as T
    from repro_torch.analysis import roofline as RF
    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.device import MetaGenerator
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext,
                                                  shard_state, state_shardings)
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import model as MD
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = p24["cfg"]
    mesh = make_serve_mesh("1x1", "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        # (a) the sharded step at full width
        torch.cuda.reset_peak_memory_stats()
        par = ParallelContext(cfg, mesh, MD.init_params(cfg, MetaGenerator()))
        state = shard_state(init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0)), cfg, mesh)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in T.leaves(state))
        step_fn = make_train_step(cfg, cosine_schedule(1e-4, 10, 100),
                                  compute_dtype=torch.bfloat16, par=par)
        before = par.collectives
        state, losses, step_ms, first_ms = full_width_steps(
            torch, step_fn, state, cfg)
        per_step = (par.collectives - before) // TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        ensure(losses == p24["losses"],
               f"sharded losses {losses} != phase 24's {p24['losses']}")
        ensure(all(torch.equal(a.cpu(), b) for a, b in zip(
            T.leaves(state), T.leaves(p24["state"]))),
               "the sharded step's state differs from phase 24's")
        del state, step_fn, p24["state"]
        gc.collect()
        torch.cuda.empty_cache()
        # one device again, after the mesh (phase 24, mesh, one device)
        _, again, again_ms, _ = full_width_steps(
            torch, make_train_step(cfg, cosine_schedule(1e-4, 10, 100),
                                   compute_dtype=torch.bfloat16),
            init_train_state(
                cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
        ensure(again == p24["losses"], "a second one-device run differs")
        gc.collect()
        torch.cuda.empty_cache()
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"[mesh-train] (a) phase 24's step through a 1x1 NCCL mesh: "
              f"losses {[round(v, 4) for v in losses]} and the state after "
              f"{TRAIN_STEPS} steps bitwise phase 24's; {step_ms:.1f} ms/step "
              f"after the first ({first_ms:.1f} ms), "
              f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
              f"{peak / 1e9:.2f} GB; one device: phase 24 "
              f"{p24['step_ms']:.1f} ms/step, {p24['tokens_per_s']:.1f} "
              f"tokens/s, {p24['peak_gb']:.2f} GB, and run again after the "
              f"mesh {again_ms:.1f} ms/step (its losses bitwise phase 24's); "
              f"collectives a step {per_step}", flush=True)
        # after every timed step: qwen3-14b's cells, and phase 28 (d)'s
        dry["proc"] = start_dryrun()
        for arch in DRYRUN_MAMBA_ARCHS:
            dry[arch] = start_dryrun(arch)

        # (b) the reduced Trainer on the mesh
        rcfg = get_config("qwen3-14b", reduced=True)
        rstream = TokenStream(vocab_size=rcfg.vocab_size, batch_size=4,
                              seq_len=32)
        crashed = {"done": False}

        def hook(step):
            if step == 7 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected node failure")

        with tempfile.TemporaryDirectory() as tmp:
            tr = Trainer(rcfg, TrainerConfig(
                tmp, ckpt_every=5, lr=3e-3, warmup_steps=2,
                compute_dtype=torch.float32), rstream.batch, mesh=mesh,
                failure_hook=hook, device="cuda")
            out = tr.run(12)
            by_step = {m["step"]: m["loss"] for m in tr.metrics_log
                       if "loss" in m}
            mlosses = [by_step[s] for s in sorted(by_step)]
            ensure(out["recoveries"] == 1 and out["final_step"] == 12,
                   f"mesh trainer: recoveries {out['recoveries']}")
            ensure(mlosses == p24["trainer_losses"],
                   f"mesh trainer losses {mlosses} != one device's "
                   f"{p24['trainer_losses']}")
            live = [t.clone() for t in T.leaves(tr.state)]
            shape = init_train_state(rcfg, MetaGenerator())
            tr.remesh(mesh, lambda m: state_shardings(shape, rcfg, m))
            ensure(tr.par is not None and all(
                torch.equal(a, b) for a, b in zip(live, T.leaves(tr.state))),
                   "remesh round trip changed the state")
            back = restore_into(tr.state, Path(tmp) / "step_00000012")
            ensure(all(torch.equal(a, b) for a, b in zip(
                T.leaves(back), live)), "the mesh checkpoint != live state")
        print(f"[mesh-train] (b) Trainer on the 1x1 mesh, 12 steps, one "
              f"injected failure: recoveries 1, losses bitwise the one-device "
              f"Trainer's ({mlosses[0]:.4f} -> {mlosses[-1]:.4f}); remesh "
              "with state_shardings round trip and the mesh's checkpoint "
              "through restore_into equal the live state", flush=True)
        del tr, live, back
    finally:
        torch.use_deterministic_algorithms(False)
        torch.distributed.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the dry-run of (a)'s cell, and of DRYRUN_ARCH on 16x16
    cell = ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = DR.run_cell("qwen3-14b", "train_4k", multi_pod=False,
                      cfg_override=cfg,
                      mesh_override=AbstractMesh((1, 1), ("data", "model")),
                      cell_override=cell, save=False, force=True)
    mem = rec["memory_analysis"]
    ensure(mem["arguments"]["state"] == state_bytes,
           f"predicted state bytes {mem['arguments']['state']} != live "
           f"{state_bytes}")
    pred = mem["argument_size_bytes"] + mem["temp_size_bytes"]
    tflops = rec["flops_per_device"] / (step_ms * 1e-3) / 1e12
    print(f"[mesh-train] (c) dry-run of (a)'s cell on an abstract 1x1 mesh: "
          f"state {mem['arguments']['state']} bytes = the live state's; "
          f"arguments + temp {pred / 1e9:.2f} GB predicted against "
          f"max_memory_allocated {peak / 1e9:.2f} GB; "
          f"{rec['flops_per_device']:.4e} FLOPs a step over {step_ms:.1f} ms "
          f"= {tflops:.1f} TFLOP/s, {100 * tflops / 989:.1f} % of 989 "
          f"(bf16 dense peak) on {smi}", flush=True)
    end_dryrun(dry.pop("proc"), 300)
    for f in sorted(DR.RESULTS_DIR.glob(f"{DRYRUN_ARCH}__*__16x16.json")):
        r = json.loads(f.read_text())
        terms = RF.roofline_terms(r)
        if terms is None:
            print(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: skipped "
                  f"({r['reason']})", flush=True)
            continue
        m = r["memory_analysis"]
        gib = (m["argument_size_bytes"] + m["temp_size_bytes"]) / 2**30
        print(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: per rank "
              f"{gib:.2f} GiB (before the serving placement "
              f"{DRYRUN_BEFORE[r['shape']]:.2f}; arguments "
              f"{m['argument_size_bytes'] / 2**30:.2f} + temp "
              f"{m['temp_size_bytes'] / 2**30:.2f}) against 80; "
              f"{r['flops_per_device']:.4e} FLOPs; collectives "
              f"{r['collectives']['total_bytes'] / 2**30:.3f} GiB; bound by "
              f"{terms['bottleneck']} ({terms['bound_s']:.4f} s); host "
              f"{r['run_s']:.1f}s", flush=True)
    print(f"[mesh-train] phase 27 in {time.perf_counter() - t0:.1f}s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 25: the fixed-slot engine and the non-paged families
# ---------------------------------------------------------------------------

FIXED_SLOTS = 4                # the fixed engine's slots (phase 5's max_batch)
MOE_LAYERS = 12                # qwen3-moe-30b-a3b depth cut (1.25 GB a layer)
SSD_TOKENS = 2048              # the chunked-SSD prefill held to the recurrence
SSD_STATE_TOL = 1e-3           # max |Δ| / max |state|, float32, 2,048 steps
TEACHER_REL = 2e-3             # tests/test_models_smoke.py's relative bound
JAMBA_FULL_PERIOD_GB = 90      # one 8-layer jamba period at full width, bf16


def tree_clone(t):
    return {k: tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in t.items()}


def tree_equal(torch, a, b) -> bool:
    return all(tree_equal(torch, a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(a[k], b[k]) for k in a)


def fixed_twin(torch, eng, MD, log):
    """Wrap the fixed engine's decode program so that every call is checked
    as it happens: the replayed logits (every slot) and the whole cache
    bit-equal to eager ``MD.decode_step`` on a copy of the cache taken just
    before the call (on a mesh with the engine's parallel context).  ``log`` gets one entry
    per call."""
    import numpy as np
    prog = eng._decode
    par = getattr(eng, "par", None)

    def call(**arrays):
        before = tree_clone(eng.cache)
        out = prog(**arrays).clone()
        inputs = [torch.from_numpy(np.asarray(arrays[k], np.int32)).cuda()
                  for k in ("token", "pos")]
        want = MD.decode_step(eng.params, *inputs, before, eng.cfg,
                              compute_dtype=eng.cd, par=par)
        torch.cuda.synchronize()
        ensure(prog.graph is not None, "fixed decode: no graph captured")
        ensure(torch.equal(out, want), "fixed decode: replayed logits != "
               f"eager (max diff {(out - want).abs().max().item()})")
        ensure(tree_equal(torch, eng.cache, before),
               "fixed decode: replayed cache != eager")
        log.append(1)
        return out

    eng._decode = call
    return prog


def check_replays(torch, eng, MD, label, n_requests: int = 4,
                  max_new: int = 5) -> int:
    """At least 3 consecutive fixed decode steps of a live engine, each
    replay bit-equal to eager (``fixed_twin``)."""
    log = []
    prog = fixed_twin(torch, eng, MD, log)
    for p in prompts(eng.cfg.vocab_size, n_requests):
        eng.submit(p, max_new_tokens=max_new)
    eng.run_until_drained()
    eng._decode = prog
    ensure(len(log) >= 3, f"{label}: only {len(log)} decode replays checked")
    return len(log)


def fixed_eager_streams(torch, MD, ES, params, cfg, reqs, max_new: int,
                        max_len: int):
    """Greedy streams of ``reqs``, each request alone through eager
    ``MD.prefill`` (its cache copied into slot 0 of a ``FIXED_SLOTS``-row
    cache) and ``MD.decode_step`` at the engine's shapes, and each
    position's top-2 logit margin."""
    out, margins = [], []
    cd = torch.bfloat16
    for prompt in reqs:
        cache = MD.init_cache(cfg, FIXED_SLOTS, max_len, cd, "cuda")
        logits, one = MD.prefill(params, torch.tensor([prompt], device="cuda"),
                                 cfg, max_len, compute_dtype=cd)
        ES._splice_slot(cache, one, 0, FIXED_SLOTS)
        rows = [logits[0, -1]]
        while len(rows) < max_new:
            token = torch.zeros((FIXED_SLOTS, 1), dtype=torch.int32,
                                device="cuda")
            token[0, 0] = rows[-1].argmax()
            pos = torch.zeros((FIXED_SLOTS,), dtype=torch.int32, device="cuda")
            pos[0] = len(prompt) + len(rows) - 1
            rows.append(MD.decode_step(params, token, pos, cache, cfg,
                                       compute_dtype=cd)[0, 0])
        top = torch.topk(torch.stack(rows), 2).values
        out.append([int(r.argmax()) for r in rows])
        margins.append((top[:, 0] - top[:, 1]).tolist())
    return out, margins


def hold_streams(label, handles, want, margins) -> int:
    """Streams equal to ``want``, or a first difference where the eager
    top-2 margin is within STREAM_MARGIN_TOL; returns how many differ."""
    differ = 0
    for h, w, m in zip(handles, want, margins):
        if h.generated == w:
            continue
        differ += 1
        at = next(i for i, (a, b) in enumerate(zip(h.generated, w)) if a != b)
        print(f"[{label}] req {h.request_id}: first difference at {at}, eager "
              f"top-2 margin {m[at]:.4f} (tolerance {STREAM_MARGIN_TOL})",
              flush=True)
        ensure(m[at] <= STREAM_MARGIN_TOL,
               f"{label}: req {h.request_id} differs at {at}, margin {m[at]}")
    return differ


def serve_line(label, handles, dt, ttft, engine) -> str:
    n_tok = sum(len(h.generated) for h in handles)
    return (f"[{label}] {len(handles)} requests x "
            f"{len(handles[0].generated)} tokens: {n_tok / dt:.2f} tok/s "
            f"({n_tok} in {dt:.3f}s); TTFT mean {sum(ttft) / len(ttft):.4f}s "
            f"max {max(ttft):.4f}s; forward calls "
            f"{engine.stats['prefill_calls']} prefill + "
            f"{engine.stats['decode_calls']} decode; capture_s "
            f"{fmt(engine.stats.get('capture_s', {}))}; graph nodes "
            f"{engine.stats.get('graph_nodes')}")


def step_ms(torch, engine, MD, iters: int = 5) -> str:
    """Where an engine's serve time goes: its decode program replayed with
    idle inputs (CUDA events over ``iters`` replays), and one 8-token
    prefill — the paged engine's chunk program replayed with nothing valid
    (trash page only), the fixed engine's eager ``MD.prefill`` (host clock,
    synced).  Run after the engine drained: the replays write idle rows."""
    import numpy as np
    prog = engine._decode
    rows = len(prog.inputs["token"])
    arrays = {k: np.full(tuple(t.shape), 8 if k == "pos" else 0, np.int32)
              for k, t in prog.inputs.items()}
    if "table" in arrays:
        arrays["table"][:] = engine.kv.trash

    def events(fn):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    dec = events(lambda: prog(**arrays))
    toks = prompts(engine.cfg.vocab_size, 1)[0]
    if hasattr(engine, "kv"):
        pf = events(lambda: engine._prefill(
            tokens=np.zeros((1, engine.prefill_chunk), np.int32), start=0,
            n_valid=0, row=np.full((engine.max_pages_per_seq,),
                                   engine.kv.trash, np.int32)))
        how = "chunk program replayed, CUDA events"
    else:
        t = torch.tensor([toks], device="cuda")
        MD.prefill(engine.params, t, engine.cfg, engine.max_len,
                   compute_dtype=engine.cd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            MD.prefill(engine.params, t, engine.cfg, engine.max_len,
                       compute_dtype=engine.cd)
        torch.cuda.synchronize()
        pf = 1e3 * (time.perf_counter() - t0) / iters
        how = "eager MD.prefill, host clock"
    return (f"decode replay {dec:.3f} ms ({rows} rows, CUDA events); "
            f"{len(toks)}-token prefill {pf:.3f} ms ({how})")


def fixed_qwen_phase(torch, cfg, params, MD, load_engine, FL, dispatch,
                     plain_streams, phase5):
    """(a) phase 5's 40-layer qwen3-14b through ``load_engine(...,
    engine="fixed", max_batch=4)``: 6 requests x 16 greedy tokens held to
    phase 5's streams by the STREAM_MARGIN_TOL rule (margins from the
    paged engine), ``fused_lutmu`` 120 launches per forward (prefills
    eager, decodes replayed), ``ref`` never on CUDA, then 3+ consecutive
    decode replays bit-equal to eager.  Returns its fused_lutmu launches."""
    from repro_torch.serving import FixedSlotEngine
    t0 = time.perf_counter()
    engine = load_engine(None, params, cfg, engine="fixed",
                         max_batch=FIXED_SLOTS, max_len=128,
                         compute_dtype=torch.bfloat16, device=DEVICE)
    ensure(type(engine) is FixedSlotEngine and engine.slots == FIXED_SLOTS,
           f"engine='fixed' built {type(engine).__name__}")
    handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
    calls = engine.stats["prefill_calls"] + engine.stats["decode_calls"]
    launches = FL.LAUNCHES.n
    ensure(launches == 3 * cfg.num_layers * calls,
           f"fixed: fused_lutmu launches {launches} != {3 * cfg.num_layers}"
           f" x {calls} forward calls")
    ensure(dispatch.REF_ON_CUDA.n == 0, "fixed: the ref path ran on CUDA")
    ensure(all(h.done and len(h.generated) == 16 for h in handles),
           "fixed: requests did not finish")

    def make_plain(c=cfg, p=params):
        return load_engine(None, p, c, compute_dtype=torch.bfloat16,
                           device=DEVICE, **ENGINE_KNOBS)

    differ = compare_streams(torch, "fixed", handles, plain_streams,
                             make_plain)
    print(serve_line("fixed", handles, dt, ttft, engine) +
          f"; fused_lutmu launches {launches} = {3 * cfg.num_layers} x "
          f"{calls}; ref on CUDA 0; {differ} of {len(handles)} streams differ "
          f"from phase 5's", flush=True)
    print(f"[fixed] beside phase 5 (paged): {phase5['tok_s']:.2f} tok/s, "
          f"TTFT mean {phase5['ttft']:.4f}s, graph nodes "
          f"{phase5['graph_nodes']}; fixed: {step_ms(torch, engine, MD)}",
          flush=True)
    # the eager twins launch the kernels too: counted above, not after
    n = check_replays(torch, engine, MD, "fixed")
    print(f"[fixed] {n} consecutive decode replays bit-equal to eager "
          f"MD.decode_step (logits of every slot, the whole cache)",
          flush=True)
    del engine
    torch.cuda.empty_cache()
    return {"fused_lutmu": launches, "s": time.perf_counter() - t0}


def mamba_phase(torch, MD, MB, ES, load_engine, get_config):
    """(b) mamba2-370m at full width and depth through the fixed engine.
    Returns its streams, tok/s and graph nodes (phase 28 (a) serves them
    again on a mesh)."""
    cfg = get_config("mamba2-370m")
    params = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                            torch.bfloat16)
    n_params = sum(int(t.numel()) for t in _leaves(params))
    engine = load_engine(None, params, cfg, max_batch=FIXED_SLOTS, max_len=128,
                         compute_dtype=torch.bfloat16, device=DEVICE)
    ensure(type(engine).__name__ == "FixedSlotEngine",
           f"mamba2 dispatched to {type(engine).__name__}")
    handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
    want, margins = fixed_eager_streams(
        torch, MD, ES, params, cfg, prompts(cfg.vocab_size, 6), 16, 128)
    differ = hold_streams("mamba2", handles, want, margins)
    print(serve_line("mamba2", handles, dt, ttft, engine) +
          f"; {cfg.num_layers} layers, {n_params / 1e9:.3f} B params; "
          f"{differ} of 6 streams differ from each request served alone "
          f"(eager prefill + decode_step); {step_ms(torch, engine, MD)}",
          flush=True)
    n_tok = sum(len(h.generated) for h in handles)
    served = {"streams": [list(h.generated) for h in handles],
              "tok_s": n_tok / dt, "graph_nodes": engine.stats["graph_nodes"]}
    n = check_replays(torch, engine, MD, "mamba2")
    del engine
    # the chunked SSD over 2,048 tokens against the recurrence, layer 0 in
    # float32 (bf16 GEMMs of another row count would round differently)
    lp = {k: v.float() for k, v in MD.layer_params(params["layers"],
                                                   0)["mamba"].items()}
    x = torch.randn((1, SSD_TOKENS, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    _, chunked = MB.mamba_forward(lp, x, cfg, return_state=True)
    rec = MB.init_mamba_cache(cfg, 1, torch.float32, "cuda")
    for t in range(SSD_TOKENS):
        MB.mamba_decode_step(lp, x[:, t:t + 1], cfg, rec)
    rel = {k: ((rec[k] - chunked[k]).abs().max()
               / chunked[k].abs().max()).item() for k in ("ssm", "conv")}
    ensure(max(rel.values()) <= SSD_STATE_TOL,
           f"chunked SSD state vs recurrence: {rel}")
    print(f"[mamba2] {n} decode replays bit-equal to eager; a {SSD_TOKENS}-"
          f"token chunked-SSD prefill (chunk {cfg.ssm_chunk}) of layer 0 "
          f"against {SSD_TOKENS} mamba_decode_step calls, float32: max |Δ| / "
          f"max |state| ssm {rel['ssm']:.2e}, conv {rel['conv']:.2e} "
          f"(tolerance {SSD_STATE_TOL})", flush=True)
    del params
    return served


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def moe_phase(torch, MD, MOE, load_engine, get_config, on_mesh=False):
    """(c) qwen3-moe-30b-a3b at full width, depth cut to MOE_LAYERS: the
    paged and the fixed engine each serve 6 x 16 greedy tokens; every
    decode replay checked against its eager model function; an eager
    decode step under ``torch.cuda.set_sync_debug_mode("error")``; the MoE
    share of a decode replay's kernel time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              num_layers=MOE_LAYERS)
    params = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                            torch.bfloat16)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    cd = torch.bfloat16
    out = {}
    for kind in ("paged", "fixed"):
        engine = load_engine(None, params, cfg, engine=kind,
                             compute_dtype=cd, device=DEVICE, **ENGINE_KNOBS)
        handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
        ensure(all(h.done and len(h.generated) == 16 for h in handles),
               f"moe {kind}: requests did not finish")
        print(serve_line(f"moe-{kind}", handles, dt, ttft, engine) +
              f"; {cfg.num_experts} experts top-{cfg.num_experts_per_tok}, "
              f"{MOE_LAYERS} layers, {gb:.2f} GB of params; "
              f"{step_ms(torch, engine, MD)}", flush=True)
        out[kind] = sum(len(h.generated) for h in handles) / dt
        if kind == "paged":
            log = []
            kv = engine.kv.buffers
            engine._decode = twin(
                torch, engine._decode, lambda c, token, pos, table:
                MD.paged_decode_step(params, token, pos, table, c[0], cfg,
                                     compute_dtype=cd),
                [kv], keep_rows(engine.kv.trash), log)
            for p in prompts(cfg.vocab_size, 4):
                engine.submit(p, max_new_tokens=5)
            engine.run_until_drained()
            ensure(len(log) >= 3, f"moe paged: {len(log)} replays checked")
            n = len(log)
        else:
            n = check_replays(torch, engine, MD, "moe-fixed")
            # the share of the MoE in a decode replay's kernel time
            token = torch.zeros((FIXED_SLOTS, 1), dtype=torch.int32,
                                device="cuda")
            pos = torch.full((FIXED_SLOTS,), 8, dtype=torch.int32,
                             device="cuda")
            torch.cuda.set_sync_debug_mode("error")
            MD.decode_step(params, token, pos, engine.cache, cfg,
                           compute_dtype=cd)
            torch.cuda.set_sync_debug_mode("default")
            arrays = {"token": token.cpu().numpy(), "pos": pos.cpu().numpy()}
            x = torch.randn((FIXED_SLOTS, 1, cfg.d_model), device="cuda",
                            dtype=cd)
            layers = [MD.layer_params(params["layers"], l)["moe"]
                      for l in range(MOE_LAYERS)]
            ms = {}
            for name, fn in (
                    ("replay", lambda: engine._decode(**arrays)),
                    ("moe", lambda: [MOE.moe_apply(m, x, cfg)
                                     for m in layers])):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                ms[name], _ = kernel_busy_ms(torch, prof, 3)
            share = ("not measured (the profiler saw no kernels)"
                     if not ms["replay"] else
                     f"{100 * ms['moe'] / ms['replay']:.1f}% "
                     f"({ms['moe']:.3f} of {ms['replay']:.3f} kernel ms)")
            print(f"[moe-fixed] MoE share of a decode replay's kernel time "
                  f"(profiler; the {MOE_LAYERS} layers' moe_apply at the "
                  f"decode shape eagerly, over the replay): {share}; an "
                  "eager decode step under set_sync_debug_mode('error') ran "
                  "without a host sync", flush=True)
        print(f"[moe-{kind}] {n} decode replays bit-equal to eager (every "
              "capture succeeded: no host sync inside)", flush=True)
        del engine
        torch.cuda.empty_cache()
    if on_mesh:
        # 26 (a): the same model through the fixed engine on a 1x1 mesh
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh("1x1", "cuda")
        engine = load_engine(None, params, cfg, engine="fixed", mesh=mesh,
                             compute_dtype=cd, device=DEVICE, **ENGINE_KNOBS)
        handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
        ensure(all(h.done and len(h.generated) == 16 for h in handles),
               "moe fixed on the mesh: requests did not finish")
        line = serve_line("mesh-moe-fixed", handles, dt, ttft, engine)
        n = check_replays(torch, engine, MD, "mesh-moe-fixed")
        print(line + f"; {n} decode replays bit-equal to eager (with the "
              f"parallel context); {out['fixed']:.2f} tok/s unsharded in "
              "this call", flush=True)
        del engine, mesh
        gc.collect()
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def teacher_phase(torch, MD, ST, get_config):
    """(d) whisper-tiny whole with 1,500 seeded frames and internvl2-26b at
    full width, 2 layers, with 256 seeded patch embeddings, float32 (the
    JAX test's type): ``make_prefill_step`` of 8 tokens then 16
    ``make_decode_step`` steps, each step's logits within TEACHER_REL of
    the largest logit of ``forward`` teacher-forced on the same tokens."""
    for arch, layers in (("whisper-tiny", None), ("internvl2-26b", 2)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(8)
        params = MD.init_params(cfg, gen, torch.float32)
        t = cfg.num_frontend_tokens
        extra = torch.randn((1, t, cfg.d_model), device="cuda",
                            generator=gen) * 0.1
        toks = torch.randint(0, cfg.vocab_size, (1, 24), device="cuda",
                             generator=gen)
        f32 = torch.float32
        with torch.inference_mode():
            full = MD.forward(params, toks, cfg, remat=False,
                              extra_embeds=extra, compute_dtype=f32)
        offset = t if cfg.family == "vlm" else 0
        logits, cache = ST.make_prefill_step(cfg, offset + 32, f32)(
            params, {"tokens": toks[:, :8], "frontend": extra})
        decode = ST.make_decode_step(cfg, f32)
        errs = [(logits[0, 0] - full[0, 7]).abs().max().item()]
        for i in range(8, 24):
            lg = decode(params, toks[:, i:i + 1],
                        torch.tensor([offset + i], device="cuda"), cache)
            errs.append((lg[0, 0] - full[0, i]).abs().max().item())
        rel = max(errs) / full.abs().max().item()
        ensure(math.isfinite(rel) and rel < TEACHER_REL,
               f"{arch}: decode vs forward {rel}")
        print(f"[teacher] {arch} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {t} frontend embeddings): prefill 8 + 16 "
              f"decode steps against forward teacher-forced: max |Δ| / max "
              f"|logit| {rel:.2e} (bound {TEACHER_REL})", flush=True)
        del params, cache, full
        torch.cuda.empty_cache()


def jamba_phase(torch, MD, FL, dispatch, load_engine, get_config):
    """(e) jamba-1.5-large at reduced width (one 8-layer period at full
    width is ≈ 90 GB in bf16: the MoE layers alone ≈ 77 GB) with LUT-MU
    serving params through the fixed engine: ``fused_lutmu`` 3 launches
    per dense layer per forward, decode replays bit-equal to eager.
    Returns its fused_lutmu launches and streams."""
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(
        cfg.amm, enabled=True, backend="auto"))
    params = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(9),
                            torch.bfloat16, serving=True)
    dense = sum(1 for i in range(cfg.num_layers) if not cfg.layer_is_moe(i))
    engine = load_engine(None, params, cfg, max_batch=FIXED_SLOTS, max_len=64,
                         compute_dtype=torch.bfloat16, device=DEVICE)
    ensure(type(engine).__name__ == "FixedSlotEngine",
           f"jamba dispatched to {type(engine).__name__}")
    handles, dt, _, engine = drive(torch, engine, cfg, 6, 8)
    calls = engine.stats["prefill_calls"] + engine.stats["decode_calls"]
    launches = FL.LAUNCHES.n
    ensure(all(h.done and len(h.generated) == 8 for h in handles),
           "jamba: requests did not finish")
    ensure(launches == 3 * dense * calls and dispatch.REF_ON_CUDA.n == 0,
           f"jamba: fused_lutmu launches {launches} != 3 x {dense} x {calls}")
    n = check_replays(torch, engine, MD, "jamba")
    n_tok = sum(len(h.generated) for h in handles)
    print(f"[jamba] reduced width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {dense} dense LUT-MU layers): 6 requests x 8 "
          f"tokens {n_tok / dt:.2f} tok/s; fused_lutmu "
          f"{launches} launches = 3 x {dense} x {calls} forward calls; {n} "
          f"decode replays bit-equal to eager.  Full width does not fit one "
          f"card: one 8-layer period is ≈ {JAMBA_FULL_PERIOD_GB} GB in bf16 "
          f"(4 MoE layers of 16 x 3 x 8192 x 24576 ≈ 77 GB), so it waits "
          f"for multi-device serving (ROADMAP A11)", flush=True)
    streams = [list(h.generated) for h in handles]
    del engine, params
    torch.cuda.empty_cache()
    return launches, streams


def families_phase(torch, mods, load_engine, get_config):
    """(b)-(e) of phase 25 (and the MoE part of 26 (a)); returns the jamba
    fused_lutmu launches, and what (b) and (e) served."""
    MD, MB, MOE, ES, ST, FL, dispatch = mods
    t0 = time.perf_counter()
    mamba = mamba_phase(torch, MD, MB, ES, load_engine, get_config)
    gc.collect()
    moe_phase(torch, MD, MOE, load_engine, get_config, on_mesh=True)
    gc.collect()
    teacher_phase(torch, MD, ST, get_config)
    launches, jamba = jamba_phase(torch, MD, FL, dispatch, load_engine,
                                  get_config)
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_lutmu": launches, "s": time.perf_counter() - t0,
            "mamba": mamba, "jamba": jamba}


# ---------------------------------------------------------------------------
# phase 26: serving on a device mesh
# ---------------------------------------------------------------------------

MESH_TPS = (2, 4, 8)           # the per-shard LUT-MU problem's TP degrees
MESH_CASES = [(proj, b, lut) for proj in ("gate_up", "down") for b in (4, 32)
              for lut in ("int8", "float32")]


def nccl_kernels(torch, fn) -> int:
    """Kernels whose name holds ``nccl`` in one call of ``fn``
    (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.key.lower())


def mesh_serve_phase(torch, cfg, params, MD, load_engine, FL, dispatch,
                     plain_streams, phase5):
    """26 (a): phase 5's serve through a 1x1 NCCL mesh, the process group
    destroyed at the end (the later phases capture their programs without
    one).  Returns the fused_lutmu launches."""
    import numpy as np
    from repro_torch.launch.mesh import make_serve_mesh
    t0 = time.perf_counter()
    mesh = make_serve_mesh("1x1", "cuda")
    engine = load_engine(None, params, cfg, compute_dtype=torch.bfloat16,
                         device=DEVICE, mesh=mesh, **ENGINE_KNOBS)
    ensure(engine.par is not None and engine.par.tp == 1
           and engine.par.dp == 1, "the engine is not on the mesh")
    handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
    calls = engine.stats["prefill_calls"] + engine.stats["decode_calls"]
    launches = FL.LAUNCHES.n
    ensure(launches == 3 * cfg.num_layers * calls,
           f"mesh: fused_lutmu launches {launches} != {3 * cfg.num_layers} x "
           f"{calls} forward calls")
    ensure(dispatch.REF_ON_CUDA.n == 0, "mesh: ref LUT-MU ran on CUDA")
    ensure([list(h.generated) for h in handles] == plain_streams,
           "mesh: streams differ from phase 5's")
    n_tok = sum(len(h.generated) for h in handles)
    print(serve_line("mesh-1x1", handles, dt, ttft, engine) +
          f"; streams equal phase 5's; fused_lutmu launches {launches} = "
          f"{3 * cfg.num_layers} x {calls}; phase 5 in this call "
          f"{phase5['tok_s']:.2f} tok/s, TTFT mean {phase5['ttft']:.4f}s",
          flush=True)
    # every decode replay of a few more requests against eager
    log = []
    prog = engine._decode
    par = engine.par
    engine._decode = twin(
        torch, prog, lambda c, token, pos, table: MD.paged_decode_step(
            engine.params, token, pos, table, c[0], cfg,
            compute_dtype=torch.bfloat16, par=par),
        [engine.kv.buffers], keep_rows(engine.kv.trash), log)
    for p in prompts(cfg.vocab_size, 4):
        engine.submit(p, max_new_tokens=5)
    engine.run_until_drained()
    engine._decode = prog
    ensure(len(log) >= 3, f"mesh: only {len(log)} decode replays checked")
    # the collectives a forward issues, and what the captured graph holds
    before = par.collectives
    arrays = {k: np.zeros(tuple(t.shape), np.int32)
              for k, t in prog.inputs.items()}
    arrays["table"][:] = engine.kv.trash
    MD.paged_decode_step(engine.params, *(torch.from_numpy(arrays[k]).cuda()
                                          for k in ("token", "pos", "table")),
                         engine.kv.buffers, cfg, compute_dtype=torch.bfloat16,
                         par=par)
    per_step = par.collectives - before
    nodes = engine.stats["graph_nodes"]["decode"]
    plain_nodes = phase5["graph_nodes"]["decode"]
    n_nccl = nccl_kernels(torch, lambda: prog(**arrays))
    ensure(nodes > plain_nodes,
           f"mesh: decode graph nodes {nodes} not above phase 5's "
           f"{plain_nodes}")
    print(f"[mesh-1x1] {len(log)} decode replays bit-equal to eager "
          f"MD.paged_decode_step(par=...); collectives per decode step "
          f"{per_step}; decode graph nodes {nodes} (phase 5 {plain_nodes}, "
          f"+{nodes - plain_nodes}); NCCL kernels in one replay (profiler) "
          f"{n_nccl}; graph nodes {engine.stats['graph_nodes']}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del engine, handles, prog, par, mesh
    gc.collect()
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


SPLIT_SLOTS = 8                # decode_32k's 128 slots over 16 data ranks
SPLIT_SEQ = 32768              # decode_32k's cache sequence
SPLIT_SHARDS = 16              # its cut over model at 16x16 (8 kv heads)
SPLIT_REL = 1e-5               # tests/test_torch_placement.py's bound
POOL_SHARDS = 4                # page shards of the paged view's check


def split_read_phase(torch, timer, FV, cfg):
    """26 (c): the slice's plain split functions at full width on the one
    card, cut as a 16x16 mesh would cut the work (no mesh pretended):
    qwen3-14b's slot-cache read at decode_32k's per-rank shape, bf16 and
    int8 KV, in SPLIT_SHARDS sequence shards combined in rank order,
    against ``decode_attend`` on the whole view within
    ``split_read_bound`` (SPLIT_REL); then phase 5's full-provisioned
    page pool, padded and cut into POOL_SHARDS page shards, its masked
    gathers summed in rank order: bitwise ``paged_view``."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(26)
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // nkv
    b, s_len = SPLIT_SLOTS, SPLIT_SEQ
    qg = torch.randn((b, 1, nkv, g, hd), generator=gen, device="cuda")
    pos = torch.tensor([s_len - 1, s_len // 2, s_len // 4, 1000, 17,
                        s_len - 1000, 3 * s_len // 4, 2 * s_len // 3],
                       device="cuda")
    for kv_name in ("bf16", "int8"):
        if kv_name == "int8":
            k = torch.randint(-127, 128, (b, s_len, nkv, hd), generator=gen,
                              device="cuda", dtype=torch.int8)
            v = torch.randint(-127, 128, (b, s_len, nkv, hd), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            k = torch.randn((b, s_len, nkv, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            v = torch.randn((b, s_len, nkv, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
        ks, vs = list(k.chunk(SPLIT_SHARDS, 1)), list(v.chunk(SPLIT_SHARDS, 1))

        def whole():
            return FV.decode_attend(qg, k, v, pos, None)

        def split():
            return FV.decode_attend_split(qg, ks, vs, pos, None)

        want, got = whole(), split()
        w = torch.softmax(FV.split_logits(qg, k, pos, None, 0), dim=-1)
        bound = FV.split_read_bound(w, v, SPLIT_REL)
        diff = (got - want).abs()
        ensure(bool((diff <= bound).all()),
               f"split read {kv_name}: max |diff| {float(diff.max()):.3e} "
               f"outside the bound (max {float(bound.max()):.3e})")
        whole_ms, split_ms = timer.ms(whole, 3), timer.ms(split, 3)
        print(f"[split-read] qwen3-14b decode_32k per rank: {b} slots x "
              f"{s_len} x {nkv} kv heads x {g} q heads x hd {hd}, "
              f"{kv_name} KV, {SPLIT_SHARDS} sequence shards in rank order: "
              f"max |diff| {float(diff.max()):.3e} (mean "
              f"{float(diff.mean()):.3e}, {int((diff > 0).sum())} of "
              f"{diff.numel()} outputs moved; max |out| "
              f"{float(want.abs().max()):.3e}) within the bound (max "
              f"{float(bound.max()):.3e}, rel {SPLIT_REL}); decode_attend "
              f"{whole_ms:.3f} ms, decode_attend_split {split_ms:.3f} ms",
              flush=True)
        del k, v, ks, vs, want, got, w, bound, diff
    # the paged view from a pool cut over data: phase 5's full provisioning
    knobs = ENGINE_KNOBS
    mp = -(-knobs["max_len"] // knobs["page_size"])
    pages = knobs["max_batch"] * mp
    total = -(-(pages + 1) // POOL_SHARDS) * POOL_SHARDS
    held = total // POOL_SHARDS
    shape = (total, knobs["page_size"], nkv, hd)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randperm(pages, generator=gen, device="cuda")[
        :knobs["max_batch"] * mp].reshape(knobs["max_batch"], mp)
    table[-1, mp // 2:] = total - 1  # a short row, trash-padded
    table = table.to(torch.int32)
    parts = [FV.paged_view_part(kp[r * held:(r + 1) * held],
                                vp[r * held:(r + 1) * held], table,
                                r * held, held)
             for r in range(POOL_SHARDS)]
    k_view, v_view = FV.paged_view(kp, vp, table)
    for got, want in ((FV.sum_parts([p[0] for p in parts]), k_view),
                      (FV.sum_parts([p[1] for p in parts]), v_view)):
        ensure(torch.equal(got.view(torch.int16), want.view(torch.int16)),
               "paged view from page shards differs from paged_view")
    print(f"[split-read] paged view of phase 5's pool ({pages} pages + "
          f"trash, padded to {total}) cut into {POOL_SHARDS} page shards of "
          f"{held}, masked gathers summed in rank order: bitwise paged_view; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def shard_kernel_phase(torch, timer, mods):
    """26 (b): the per-shard LUT-MU problem at tp 2, 4, 8.  Returns
    ``{kernel: {case: {ms, unsharded_ms, bound_ms, bound_by, library_ms}}}``
    (the library call: one ``torch.matmul`` of the shard's float32 one-hot
    × its float32 LUT; the encode has none)."""
    FL, ME, LA = mods
    g = 2**DEPTH
    gen = torch.Generator(device="cuda").manual_seed(2600)
    t0 = time.perf_counter()
    out = {"fused_lutmu": {}, "encode_onehot": {}, "lut_aggregate": {}}
    for proj, b, lut_name in MESH_CASES:
        c, n = SHAPES[proj]
        x = torch.randn((b, c, DEPTH), generator=gen, device="cuda")
        thr = torch.randn((c, g - 1), generator=gen, device="cuda")
        if lut_name == "int8":
            lut = torch.randint(-128, 128, (c, g, n), generator=gen,
                                dtype=torch.int8, device="cuda")
            oh_dtype = torch.int8
        else:
            lut = torch.randn((c, g, n), generator=gen, device="cuda")
            oh_dtype = torch.float32
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.015 + 0.005
        offset = torch.randn((n,), generator=gen, device="cuda")
        one = torch.ones((), device="cuda")
        zero = torch.zeros((), device="cuda")
        exact = lut_name == "int8"
        whole = {"fused_lutmu": lambda: FL.fused_lutmu(x, thr, lut, scale,
                                                        offset),
                 "unfused": lambda: LA.lut_aggregate(
                     ME.encode_onehot(x, thr, out_dtype=oh_dtype), lut, scale,
                     offset)}
        want = {k: f() for k, f in whole.items()}
        whole_ms = {"fused_lutmu": timer.ms(whole["fused_lutmu"], 10),
                    "encode_onehot": timer.ms(
                        lambda: ME.encode_onehot(x, thr, out_dtype=oh_dtype),
                        10)}
        oh_whole = ME.encode_onehot(x, thr, out_dtype=oh_dtype)
        whole_ms["lut_aggregate"] = timer.ms(
            lambda: LA.lut_aggregate(oh_whole, lut, scale, offset), 10)
        for tp in MESH_TPS:
            cl = c // tp
            shards = [(x[:, r * cl:(r + 1) * cl].contiguous(),
                       thr[r * cl:(r + 1) * cl].contiguous(),
                       lut[r * cl:(r + 1) * cl].contiguous())
                      for r in range(tp)]
            for path in ("fused_lutmu", "unfused"):
                parts = []
                for xs, ts, ls in shards:
                    if path == "fused_lutmu":
                        parts.append(FL.fused_lutmu(xs, ts, ls, one, zero))
                    else:
                        parts.append(LA.lut_aggregate(
                            ME.encode_onehot(xs, ts, out_dtype=oh_dtype), ls,
                            one, zero))
                acc = parts[0].clone()
                for p_ in parts[1:]:
                    acc += p_  # rank order
                got = acc * scale + offset
                torch.cuda.synchronize()
                label = f"{path} tp={tp} {proj} B={b} {lut_name}"
                if exact:
                    ensure(torch.equal(got, want[path]),
                           f"{label}: not bit-equal to the unsharded kernel")
                else:
                    torch.testing.assert_close(got, want[path],
                                               rtol=FLOAT_RTOL,
                                               atol=FLOAT_ATOL, msg=label)
            xs, ts, ls = shards[0]
            oh = ME.encode_onehot(xs, ts, out_dtype=oh_dtype)
            oh_f = ME.encode_onehot(xs, ts).reshape(b, cl * g)
            lut_f = ls.float().reshape(cl * g, n)
            lib_ms = timer.ms(lambda: torch.matmul(oh_f, lut_f), 10)
            rows = int(torch.unique(
                ME.encode_onehot(xs, ts).argmax(-1)
                + g * torch.arange(cl, device="cuda")[None]).numel())
            item = ls.element_size()
            key = f"tp={tp} {proj} B={b} {lut_name}"
            io = b * n * 4
            for name, fn, nbytes, ops in (
                    ("fused_lutmu", lambda: FL.fused_lutmu(xs, ts, ls, one,
                                                           zero),
                     xs.numel() * 4 + ts.numel() * 4 + rows * n * item + io,
                     b * cl * n),
                    ("encode_onehot",
                     lambda: ME.encode_onehot(xs, ts, out_dtype=oh_dtype),
                     xs.numel() * 4 + ts.numel() * 4
                     + oh.numel() * oh.element_size(), b * cl * (g - 1)),
                    ("lut_aggregate", lambda: LA.lut_aggregate(oh, ls, one,
                                                               zero),
                     oh.numel() * oh.element_size() + rows * n * item + io,
                     b * cl * n)):
                bms, by = bound_ms(nbytes, ops, ADD_OPS_PER_S)
                out[name][key] = dict(
                    ms=timer.ms(fn, 10), unsharded_ms=whole_ms[name],
                    bound_ms=bms, bound_by=by,
                    library_ms=None if name == "encode_onehot" else lib_ms)
                r = out[name][key]
                lib = ("" if r["library_ms"] is None
                       else f" library {r['library_ms']:.4f}")
                print(f"[mesh-shard] {name:13s} {key:26s} per-shard "
                      f"{r['ms']:.4f} ms (unsharded {r['unsharded_ms']:.4f}) "
                      f"bound {bms:.5f} ({by}){lib}", flush=True)
            del shards, oh, oh_f, lut_f
        del x, thr, lut, oh_whole, want
        torch.cuda.empty_cache()
    print(f"[mesh-shard] {len(MESH_CASES)} cases x tp {MESH_TPS}: int8 "
          "bit-equal to the unsharded kernels, float32 within "
          f"{FLOAT_RTOL}/{FLOAT_ATOL}, fused and encode + aggregate; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return out

# ---------------------------------------------------------------------------
# phase 28: tensor parallelism inside the Mamba block
# ---------------------------------------------------------------------------

MTP_DEGREES = (2, 4, 8, 16)    # (b)'s simulated model ranks
MTP_SLOTS = 8                  # (b)'s decode rows (decode_32k's per data rank)
MTP_TOKENS = 2048              # (b)'s prefill
MTP_STEPS = 3                  # (b)'s decode steps
# (b) float32: the split regroups three sums over the ranks (the norm's
# mean of squares, the out projection's d_inner rows, the narrower
# products' blocking), each a sum of at most d_inner = 16,384 terms of
# random sign: a regrouping moves it by ≈ √K · 2^-24 ≈ 7.6e-6 of its
# terms' magnitude, within a few times its own size; 1e-4 of max |out|
# leaves a margin of 10, where a misplaced slice moves it by O(1)
MTP_F32_REL = 1e-4
# ... but the SSD rounds its intra-chunk operands to bfloat16, as the
# reference does, so float32 inputs that differ in their last bits (each
# rank's projection is a GEMM of another shape) can round one bfloat16
# step apart: the prefill's outputs are held to one bfloat16 step of the
# largest output
MTP_F32_SSD_REL = 2.0 ** -8
# (b) bfloat16, the served type: the split lies no further from the
# float32 block than the whole bfloat16 block does (its weights, inputs
# and outputs rounded; each rank's projections round alike), plus half a
# bfloat16 step (2^-9 of the largest output, which no random-signed
# partial or partial sum exceeds) for each rounding the split adds: the
# tp partial products of the out projection and the tp - 1 sums of them
MTP_BF16_STEP = 2.0 ** -9
MTP_TRAIN_LAYERS = 4           # (c)'s mamba2-370m depth cut


class RankAlone:
    """A stand-in parallel context that times one model rank's share of a
    Mamba block on the one card (one card cannot hold two NCCL ranks): the
    rank's stages run as on a mesh of ``tp``, and each collective is a
    local op of the same output: the B/C all-gather a concatenation of
    ``tp`` copies, the sums identities."""

    mamba_tp = True

    def __init__(self, torch, tp: int, rank: int):
        self.torch, self.tp, self.tp_rank = torch, tp, rank

    def enter_tp(self, x):
        return x

    def share_tp(self, x, dim: int):
        return self.torch.cat([x] * self.tp, dim)

    def sum_tp(self, x):
        return x

    def reduce_tp(self, x):
        return x


def _rel(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def mamba_mesh_serve(torch, MD, FL, dispatch, load_engine, get_config, fam):
    """28 (a): mamba2-370m at full width and depth, bf16, through the
    fixed engine on a 1x1 NCCL mesh (Mamba TP at tp 1), phase 25 (b)'s
    6 x 16 greedy requests: streams equal 25 (b)'s, 3+ decode replays
    bit-equal to eager ``decode_step(..., par=)``; tok/s, graph nodes and
    the collectives of a decode step beside 25 (b)'s.  Then reduced jamba
    with LUT-MU on the same mesh: streams equal 25 (e)'s, ``fused_lutmu``
    3 launches per dense layer per forward.  Returns the fused_lutmu
    launches."""
    import numpy as np
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh("1x1", "cuda")
    try:
        cfg = get_config("mamba2-370m")
        params = MD.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(5), torch.bfloat16)
        engine = load_engine(None, params, cfg, max_batch=FIXED_SLOTS,
                             max_len=128, compute_dtype=torch.bfloat16,
                             device=DEVICE, mesh=mesh)
        par = engine.par
        ensure(type(engine).__name__ == "FixedSlotEngine" and par is not None
               and par.mamba_tp and par.tp == 1,
               "mamba2 on the mesh: not the fixed engine under Mamba TP")
        handles, dt, ttft, engine = drive(torch, engine, cfg, 6, 16)
        want = fam["mamba"]
        ensure([list(h.generated) for h in handles] == want["streams"],
               "mamba2 on the mesh: streams differ from phase 25 (b)'s")
        line = serve_line("mamba-tp", handles, dt, ttft, engine)
        n = check_replays(torch, engine, MD, "mamba2-mesh")
        # the collectives of one eager decode step (idle rows, a copy of
        # the cache) and the NCCL kernels of one replay
        prog = engine._decode
        arrays = {k: np.full(tuple(t.shape), 8 if k == "pos" else 0,
                             np.int32) for k, t in prog.inputs.items()}
        before = par.collectives
        MD.decode_step(engine.params, *(torch.from_numpy(arrays[k]).cuda()
                                        for k in ("token", "pos")),
                       tree_clone(engine.cache), cfg,
                       compute_dtype=torch.bfloat16, par=par)
        per_step = par.collectives - before
        ensure(per_step == 3 * cfg.num_layers + 2,
               f"mamba2 on the mesh: {per_step} collectives a decode step")
        n_nccl = nccl_kernels(torch, lambda: prog(**arrays))
        costs = _mesh_costs(torch, engine, MD, prog, arrays)
        print(line +
              f"; streams equal phase 25 (b)'s; {n} decode replays bit-equal "
              f"to eager decode_step(par=); collectives a decode step "
              f"{per_step} (3 a Mamba layer: the B/C all-gather, the norm's "
              f"and the out projection's all-reduces; 2 the head's); NCCL "
              f"kernels in one replay {n_nccl}; phase 25 (b) in this call "
              f"{want['tok_s']:.2f} tok/s, graph nodes "
              f"{want['graph_nodes']}, 0 collectives; {costs}", flush=True)
        del engine, handles, prog, params
        gc.collect()
        torch.cuda.empty_cache()

        # reduced jamba with LUT-MU: its Mamba layers cut, its dense
        # LUT-MU layers through lutmu_matmul_sharded
        jcfg = get_config("jamba-1.5-large-398b", reduced=True)
        jcfg = dataclasses.replace(jcfg, amm=dataclasses.replace(
            jcfg.amm, enabled=True, backend="auto"))
        params = MD.init_params(
            jcfg, torch.Generator(device="cuda").manual_seed(9),
            torch.bfloat16, serving=True)
        dense = sum(1 for i in range(jcfg.num_layers)
                    if not jcfg.layer_is_moe(i))
        engine = load_engine(None, params, jcfg, max_batch=FIXED_SLOTS,
                             max_len=64, compute_dtype=torch.bfloat16,
                             device=DEVICE, mesh=mesh)
        ensure(engine.par.mamba_tp, "jamba on the mesh: not under Mamba TP")
        handles, jdt, _, engine = drive(torch, engine, jcfg, 6, 8)
        calls = engine.stats["prefill_calls"] + engine.stats["decode_calls"]
        launches = FL.LAUNCHES.n
        ensure(launches == 3 * dense * calls and dispatch.REF_ON_CUDA.n == 0,
               f"jamba on the mesh: fused_lutmu launches {launches} != 3 x "
               f"{dense} x {calls}")
        ensure([list(h.generated) for h in handles] == fam["jamba"],
               "jamba on the mesh: streams differ from phase 25 (e)'s")
        jn = check_replays(torch, engine, MD, "jamba-mesh")
        print(f"[mamba-tp] reduced jamba with LUT-MU on the 1x1 mesh: 6 x 8 "
              f"tokens {sum(len(h.generated) for h in handles) / jdt:.2f} "
              f"tok/s, streams equal phase 25 (e)'s; fused_lutmu {launches} "
              f"launches = 3 x {dense} x {calls} forward calls; {jn} decode "
              f"replays bit-equal to eager", flush=True)
        del engine, handles, params
    finally:
        gc.collect()
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
    return launches


def _mesh_costs(torch, engine, MD, prog, arrays, iters: int = 5) -> str:
    """A mesh engine's decode replay ms (CUDA events; idle inputs) and one
    8-token eager ``MD.prefill`` through its parallel context and without
    one, on the same params (host clock, synced; alternated)."""
    def events(fn):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    t = torch.tensor([prompts(engine.cfg.vocab_size, 1)[0]], device="cuda")
    times = {"mesh": [], "one": []}
    for _ in range(iters):
        for k, par in (("mesh", engine.par), ("one", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            MD.prefill(engine.params, t, engine.cfg, engine.max_len,
                       compute_dtype=engine.cd, par=par)
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
    pf = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return (f"decode replay {events(lambda: prog(**arrays)):.3f} ms (CUDA "
            f"events); 8-token eager prefill median {pf['mesh']:.3f} ms "
            f"through the mesh, {pf['one']:.3f} ms without it (host clock)")


def _mamba_layer(torch, MB, cfg, seed: int):
    """One Mamba layer's params drawn on the card in float32, with small
    random norm, bias and skip vectors (the init's zeros would hide a
    misplaced slice), and the same rounded to bfloat16 as the bf16 init
    types them (``a_log`` stays float32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lp = MB.init_mamba_params(cfg, gen, torch.float32)
    for k in ("norm_w", "dt_bias", "conv_b", "d_skip"):
        lp[k] = lp[k] + 0.1 * torch.randn(lp[k].shape, generator=gen,
                                          device="cuda")
    return {torch.float32: lp,
            torch.bfloat16: {k: v if k == "a_log" else v.to(torch.bfloat16)
                             for k, v in lp.items()}}


def graph_of(torch, fn):
    """``fn`` (warmed up on a side stream) captured as one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    return g


def fmt_ms(xs) -> str:
    return " / ".join(f"{x:.4f}" for x in xs)


def _mtp_results(torch, run):
    """A block's prefill and decode results by name, in float32."""
    (out, st), (outs, cache) = run["prefill"], run["decode"]
    return {"prefill": out.float(), "prefill_conv": st["conv"].float(),
            "prefill_ssm": st["ssm"], "decode": torch.stack(outs).float(),
            "decode_conv": cache["conv"].float(), "decode_ssm": cache["ssm"]}


def _mtp_errors(torch, got, want):
    """max |got - want| / max |want| of each result."""
    return {k: _rel(torch, got[k], want[k]) for k in want}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def mamba_tp_ranks(torch, MB, SH, get_config, smi):
    """28 (b): one full-width mamba2-370m layer and one full-width jamba
    Mamba layer cut for tp 2, 4, 8 and 16, each rank's stages run in rank
    order on the card (``mamba_forward_split`` / ``mamba_decode_split``):
    a MTP_TOKENS-token prefill and MTP_STEPS decode steps of MTP_SLOTS
    rows, outputs and new state against the whole float32 block: float32
    within MTP_F32_REL of max |out| (the prefill's outputs
    MTP_F32_SSD_REL), bfloat16 within the whole bfloat16 block's own
    distance plus MTP_BF16_STEP for each rounding the split adds; each
    rank's state bytes whole/tp; a rank's bfloat16 decode step
    (``RankAlone``) beside the whole block's, each captured as one CUDA
    graph and replayed (CUDA events, L2 flushed), in turns, and their
    bounds."""
    timer = Timer(torch)
    for arch in ("mamba2-370m", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        nh = cfg.d_inner // cfg.ssm_headdim
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        gen = torch.Generator(device="cuda").manual_seed(28)
        x_pf = torch.randn((1, MTP_TOKENS, cfg.d_model), generator=gen,
                           device="cuda")
        x_dec = torch.randn((MTP_STEPS, MTP_SLOTS, 1, cfg.d_model),
                            generator=gen, device="cuda")
        state0 = {"conv": torch.randn((MTP_SLOTS, cfg.ssm_conv - 1, conv_dim),
                                      generator=gen, device="cuda"),
                  "ssm": torch.randn((MTP_SLOTS, nh, cfg.ssm_state,
                                      cfg.ssm_headdim), generator=gen,
                                     device="cuda")}
        runs = {}
        for dtype, lp in _mamba_layer(torch, MB, cfg, 7).items():
            xp, xd = x_pf.to(dtype), x_dec.to(dtype)
            whole = {"prefill": MB.mamba_forward(lp, xp, cfg,
                                                 return_state=True)}
            cache = {"conv": state0["conv"].to(dtype, copy=True),
                     "ssm": state0["ssm"].clone()}
            whole["decode"] = ([MB.mamba_decode_step(lp, xd[i], cfg, cache)
                                for i in range(MTP_STEPS)], cache)
            runs[dtype] = (lp, whole)
        f32 = _mtp_results(torch, runs[torch.float32][1])
        # the whole bfloat16 block's own distance to the float32 block
        own = _mtp_errors(torch, _mtp_results(torch,
                                              runs[torch.bfloat16][1]), f32)
        lp16, whole16 = runs[torch.bfloat16]
        whole_state = _nbytes(whole16["decode"][1])
        cache = {k: v.clone() for k, v in whole16["decode"][1].items()}
        w_bytes = _nbytes(lp16) + 2 * whole_state
        print(f"[mamba-tp] {arch} layer (d_model {cfg.d_model}, d_inner "
              f"{cfg.d_inner}, {nh} heads, {_nbytes(lp16) / 1e6:.1f} MB of "
              f"bf16 weights): the whole bf16 block against the float32 "
              f"one, max |diff| / max: "
              f"{', '.join(f'{k} {v:.2e}' for k, v in own.items())}; the "
              f"whole {MTP_SLOTS}-row decode step's bound "
              f"{1e3 * w_bytes / HBM_BYTES_PER_S:.4f} ms ({w_bytes / 1e6:.1f}"
              f" MB at 3.35 TB/s) on {smi}", flush=True)
        for tp in MTP_DEGREES:
            ensure(SH.mamba_tp_ok(cfg, tp), f"{arch}: no Mamba TP at tp {tp}")
            mesh = SH.AbstractMesh((1, tp), ("data", "model"))
            parts = SH.mamba_parts(cfg, "mamba/conv")
            errs, rank_state = {}, None
            for dtype, (lp, whole) in runs.items():
                shards = [SH.shard_params({"mamba": lp}, cfg, mesh,
                                          {"data": 0, "model": r})["mamba"]
                          for r in range(tp)]
                got, states = MB.mamba_forward_split(
                    shards, x_pf.to(dtype), cfg, return_state=True)
                caches = [{"conv": SH.cut_parts(state0["conv"].to(dtype), 2,
                                                parts, tp, r),
                           "ssm": state0["ssm"].chunk(tp, 1)[r].clone()}
                          for r in range(tp)]
                outs = [MB.mamba_decode_split(shards, x_dec[i].to(dtype), cfg,
                                              caches)
                        for i in range(MTP_STEPS)]

                def joined(sts):
                    return {"conv": SH.join_parts(torch.cat(
                        [st["conv"] for st in sts], -1), 2, parts, tp),
                        "ssm": torch.cat([st["ssm"] for st in sts], 1)}

                # every result against the float32 whole block
                errs[dtype] = _mtp_errors(torch, _mtp_results(
                    torch, {"prefill": (got, joined(states)),
                            "decode": (outs, joined(caches))}), f32)
                if dtype == torch.bfloat16:
                    rank_state = _nbytes(caches[0])
                    ensure(all(_nbytes(c) * tp == whole_state for c in caches),
                           f"{arch} tp {tp}: a rank's state is not whole/tp")
                    shard0, cache0 = shards[0], caches[0]
                del shards, caches, states, got
            e32, e16 = errs[torch.float32], errs[torch.bfloat16]
            ensure(all(v <= (MTP_F32_SSD_REL if k == "prefill" else
                             MTP_F32_REL) for k, v in e32.items()),
                   f"{arch} tp {tp} float32: {e32}")
            lim = {k: own[k] + (2 * tp - 1) * MTP_BF16_STEP for k in own}
            bad = {k: v for k, v in e16.items() if v > lim[k]}
            ensure(not bad, f"{arch} tp {tp} bfloat16: {bad} against the "
                   f"whole block's {own}")
            alone = RankAlone(torch, tp, 0)
            xd0 = x_dec[0].to(torch.bfloat16)
            # the whole block and rank 0 in turns, twice, each one replayed
            # graph (as the fixed engine replays its decode step)
            whole_ms, rank_ms = [], []
            whole_g = graph_of(torch, lambda: MB.mamba_decode_step(
                lp16, xd0, cfg, cache))
            rank_g = graph_of(torch, lambda: MB.mamba_decode_step(
                shard0, xd0, cfg, cache0, par=alone))
            for _ in range(2):
                whole_ms.append(timer.ms(whole_g.replay, 10))
                rank_ms.append(timer.ms(rank_g.replay, 10))
            del whole_g, rank_g
            # what a rank must move: its weights (its slices of the
            # replicated vectors), its state read and written, the input
            # and its output partial
            vec = sum(shard0[k].numel() * shard0[k].element_size() // tp
                      for k in ("a_log", "dt_bias", "d_skip", "norm_w"))
            r_bytes = (sum(shard0[k].numel() * shard0[k].element_size()
                           for k in ("in_proj", "out_proj", "conv_w",
                                     "conv_b")) + vec + 2 * rank_state
                       + 2 * xd0.numel() * xd0.element_size())
            r_bound = 1e3 * r_bytes / HBM_BYTES_PER_S
            print(f"[mamba-tp] {arch} tp {tp}: {MTP_TOKENS}-token prefill "
                  f"and {MTP_STEPS} {MTP_SLOTS}-row decode steps over {tp} "
                  f"ranks in rank order against the whole block: float32 "
                  f"max |diff| / max |out| "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in e32.items())} "
                  f"(tolerance {MTP_F32_REL}, prefill {MTP_F32_SSD_REL}); "
                  f"bfloat16 against the float32 "
                  f"block {', '.join(f'{k} {v:.2e}' for k, v in e16.items())}"
                  f" (within the whole bf16 block's + {2 * tp - 1} x 2^-9); a "
                  f"rank's state {rank_state} bytes = whole {whole_state} / "
                  f"{tp}; rank 0's decode step {fmt_ms(rank_ms)} ms (bound "
                  f"{r_bound:.4f} ms: {r_bytes / 1e6:.2f} MB) against the "
                  f"whole block's {fmt_ms(whole_ms)} ms (bound "
                  f"{1e3 * w_bytes / HBM_BYTES_PER_S:.4f}), in turns",
                  flush=True)
            del shard0, cache0
        del runs, f32, lp16, whole16, cache
        gc.collect()
        torch.cuda.empty_cache()


def mamba_tp_train(torch, get_config):
    """28 (c): mamba2-370m at full width, depth cut to MTP_TRAIN_LAYERS,
    bf16 compute: two steps of the train step through a 1x1 NCCL mesh
    (Mamba TP at tp 1) beside the one-device step in the same call, under
    deterministic algorithms: the losses and the state bitwise; the ms per
    step of both."""
    from repro_torch import pytree as T
    from repro_torch.data import TokenStream
    from repro_torch.device import MetaGenerator
    from repro_torch.distributed.sharding import ParallelContext, shard_state
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import model as MD
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              num_layers=MTP_TRAIN_LAYERS)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_size=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ)

    def run(par):
        state = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        if par is not None:
            state = shard_state(state, cfg, par.mesh)
        step = make_train_step(cfg, cosine_schedule(1e-4, 10, 100),
                               compute_dtype=torch.bfloat16, par=par)
        losses, times = [], []
        for i in range(2):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in stream.batch(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(1e3 * (time.perf_counter() - t0))
        return losses, times, [t.cpu() for t in T.leaves(state)]

    mesh = make_serve_mesh("1x1", "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        one = run(None)
        par = ParallelContext(cfg, mesh, MD.init_params(cfg, MetaGenerator()))
        ensure(par.mamba_tp, "mamba2 training: not under Mamba TP")
        before = par.collectives
        sharded = run(par)
        per_step = (par.collectives - before) // 2
    finally:
        torch.use_deterministic_algorithms(False)
        torch.distributed.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    ensure(sharded[0] == one[0], f"mamba2 training on the mesh: losses "
           f"{sharded[0]} != one device's {one[0]}")
    ensure(all(torch.equal(a, b) for a, b in zip(sharded[2], one[2])),
           "mamba2 training on the mesh: the state differs from one device's")
    print(f"[mamba-tp] (c) mamba2-370m full width, {MTP_TRAIN_LAYERS} layers, "
          f"bf16 compute, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, deterministic "
          f"algorithms: two steps through the 1x1 mesh, losses "
          f"{[round(v, 5) for v in sharded[0]]} and the state bitwise the one "
          f"device's; ms per step mesh {[round(v, 1) for v in sharded[1]]}, "
          f"one device {[round(v, 1) for v in one[1]]}; collectives a step "
          f"{per_step}", flush=True)


# per-rank GiB (arguments, temp) of the Mamba families' 16x16 cells before
# Mamba TP, from launch/dryrun.py on the code without it (recorded in
# PERF.md §6)
DRYRUN_MAMBA_BEFORE = {
    ("mamba2-370m", "train_4k"): (0.09, 34.13),
    ("mamba2-370m", "prefill_32k"): (0.01, 22.56),
    ("mamba2-370m", "decode_32k"): (0.39, 0.10),
    ("mamba2-370m", "long_500k"): (0.06, 0.10),
    ("jamba-1.5-large-398b", "train_4k"): (17.54, 40.83),
    ("jamba-1.5-large-398b", "prefill_32k"): (2.93, 203.63),
    ("jamba-1.5-large-398b", "decode_32k"): (7.48, 2.07),
    ("jamba-1.5-large-398b", "long_500k"): (3.50, 1.91)}


def mamba_dryrun_lines(dry, timeout: float) -> None:
    """28 (d): the Mamba families' 16x16 cells from the host dry-runs
    started in 27 (a): per-rank arguments and temp beside the figures
    before Mamba TP, the arguments equal to JAX's rule."""
    from repro_torch.analysis import roofline as RF
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    for arch in DRYRUN_MAMBA_ARCHS:
        end_dryrun(dry.pop(arch), max(timeout - (time.perf_counter() - t0),
                                      1.0))
        for f in sorted(DR.RESULTS_DIR.glob(f"{arch}__*__16x16.json")):
            r = json.loads(f.read_text())
            m = r["memory_analysis"]
            args, temp = (m["argument_size_bytes"] / 2**30,
                          m["temp_size_bytes"] / 2**30)
            ensure(m["argument_size_bytes"] == m["rule_argument_size_bytes"],
                   f"{arch} {r['shape']}: arguments != JAX's rule")
            b_args, b_temp = DRYRUN_MAMBA_BEFORE[(arch, r["shape"])]
            terms = RF.roofline_terms(r)
            print(f"[dryrun] {arch} {r['shape']} {r['mesh']}: per rank "
                  f"arguments {args:.2f} GiB (before Mamba TP {b_args:.2f}; "
                  f"JAX's rule {m['rule_argument_size_bytes'] / 2**30:.2f}) + "
                  f"temp {temp:.2f} GiB (before {b_temp:.2f}) against 80; "
                  f"{r['flops_per_device']:.4e} FLOPs; collectives "
                  f"{r['collectives']['total_bytes'] / 2**30:.3f} GiB; bound "
                  f"by {terms['bottleneck']} ({terms['bound_s']:.4f} s); host "
                  f"{r['run_s']:.1f}s", flush=True)


def mamba_tp_phase(torch, mods, load_engine, get_config, fam, smi, dry):
    """28. (a) the Mamba families served through a 1x1 mesh, (b) the
    stages over simulated ranks at full width, (c) training through the
    1x1 mesh, (d) the host dry-run's Mamba cells.  Returns the fused_lutmu
    launches of (a)."""
    from repro_torch.distributed import sharding as SH
    MD, MB, ES, FL, dispatch = mods
    t0 = time.perf_counter()
    launches = mamba_mesh_serve(torch, MD, FL, dispatch, load_engine,
                                get_config, fam)
    t_a = time.perf_counter()
    mamba_tp_ranks(torch, MB, SH, get_config, smi)
    t_b = time.perf_counter()
    mamba_tp_train(torch, get_config)
    t_c = time.perf_counter()
    mamba_dryrun_lines(dry, 600)
    print(f"[mamba-tp] phase 28 in {time.perf_counter() - t0:.1f}s ((a) "
          f"{t_a - t0:.1f}s, (b) {t_b - t_a:.1f}s, (c) {t_c - t_b:.1f}s, (d) "
          f"waited {time.perf_counter() - t_c:.1f}s)", flush=True)
    return {"fused_lutmu": launches}


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
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as MD
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import steps as ST
    from repro_torch.serving import SpeculativeEngine, load_engine
    from repro_torch.serving import engine as ES
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
    # 7 (b). the paged decode read through it at W = 1
    dres = decode_read_checks(torch, timer, FV)
    # 26 (b). the per-shard LUT-MU problem at tp 2, 4, 8
    shard = shard_kernel_phase(torch, timer, (FL, ME, LA))
    # 26 (c). the split reads of the serving state at full width
    split_read_phase(torch, timer, FV, get_config("qwen3-14b"))
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
                FV.LAUNCHES, FV.PLAIN_ON_CUDA, FV.DECODE_LAUNCHES,
                FV.PLAIN_DECODE_ON_CUDA)
    handles, dt, ttft, engine = serve(torch, cfg, params, load_engine, 6, 16)
    launches = {"fused_lutmu": FL.LAUNCHES.n, "encode_onehot": ME.LAUNCHES.n,
                "lut_aggregate": LA.LAUNCHES.n,
                "decode_read": FV.DECODE_LAUNCHES.n}
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
    decodes = engine.stats["decode_calls"]
    ensure(launches["decode_read"] == cfg.num_layers * decodes
           and FV.PLAIN_DECODE_ON_CUDA.n == 0,
           f"decode read: {launches['decode_read']} kernel launches for "
           f"{cfg.num_layers} x {decodes} decode calls, "
           f"{FV.PLAIN_DECODE_ON_CUDA.n} plain reads on CUDA")
    n_tok = sum(len(h.generated) for h in handles)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] 6 requests x 16 tokens: {n_tok} tokens in {dt:.3f}s = "
          f"{n_tok / dt:.2f} tok/s; TTFT mean {sum(ttft) / len(ttft):.4f}s "
          f"min {min(ttft):.4f}s max {max(ttft):.4f}s; forward calls "
          f"{engine.stats['prefill_calls']} prefill + "
          f"{decodes} decode; fused_lutmu launches "
          f"{launches['fused_lutmu']} = {per_call} x {calls}; decode-read "
          f"kernel launches {launches['decode_read']} = {cfg.num_layers} x "
          f"{decodes}, plain decode reads on CUDA 0; ref on CUDA 0; "
          f"peak memory {peak / 1e9:.2f} GB", flush=True)
    print(f"[serve] step programs, captured by a first short request (not "
          f"timed): capture_s {fmt(engine.stats['capture_s'])}; graph nodes "
          f"{engine.stats['graph_nodes']}", flush=True)
    for h in handles:
        print(f"  req {h.request_id}: {h.prompt} -> {h.generated}")
    plain_streams = [list(h.generated) for h in handles]
    phase5 = {"tok_s": n_tok / dt, "ttft": sum(ttft) / len(ttft),
              "graph_nodes": engine.stats["graph_nodes"]}
    del engine, handles
    # 25 (a). the fixed-slot engine on the same 40-layer params
    fixed = fixed_qwen_phase(torch, cfg, params, MD, load_engine, FL,
                             dispatch, plain_streams, phase5)
    # 26 (a). the same serve through a 1x1 NCCL mesh
    mesh_launches = mesh_serve_phase(torch, cfg, params, MD, load_engine, FL,
                                     dispatch, plain_streams, phase5)
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
    # the host dry-runs of 27 (c) and 28 (d), started after 27 (a)'s timed
    # steps, by arch; every one still running is ended below
    dry = {}
    try:
        p24 = train_phase(torch)
        print(f"[case] phases 22-24 in {time.perf_counter() - t_case:.1f}s",
              flush=True)
        # 27. training on a 1x1 NCCL mesh, and the dry-run
        mesh_train_phase(torch, p24, smi, dry)
        del p24

        # 25 (b)-(e). the non-paged families and MoE at full width
        gc.collect()
        torch.cuda.empty_cache()
        fam = families_phase(torch, (MD, MB, MOE, ES, ST, FL, dispatch),
                             load_engine, get_config)
        print(f"[families] phase 25 in {fixed['s'] + fam['s']:.1f}s ((a) "
              f"{fixed['s']:.1f}s, (b)-(e) {fam['s']:.1f}s); fused_lutmu "
              f"launches (a) {fixed['fused_lutmu']} (e) "
              f"{fam['fused_lutmu']}", flush=True)
        # 28. tensor parallelism inside the Mamba block
        gc.collect()
        torch.cuda.empty_cache()
        mtp = mamba_tp_phase(torch, (MD, MB, ES, FL, dispatch), load_engine,
                             get_config, fam, smi, dry)
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    launches["fused_lutmu"] += (fixed["fused_lutmu"] + fam["fused_lutmu"]
                                + mesh_launches + mtp["fused_lutmu"])

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
                                 "16), bf16 KV", vres, VERIFY_JSON_CASE),
               "decode_read": ("src/repro_torch/csrc/verify_window.cu",
                               "src/repro/models/attention.py:247 (plain jnp)",
                               "paged decode",
                               "B=32 W=1 n_kv=8 g=5 hd=128, S=1024 (page_size "
                               "16), bf16 KV", dres, ("bfloat16", 1024))}
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
                "measured_plan_ms": m["measured_ms"]}), **cnn,
            **({"tp_shards": shard[name]} if name in shard else {})})
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
