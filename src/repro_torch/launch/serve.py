"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Random-initialises serving params from a seeded ``torch.Generator`` on the
device and drives a continuous-batching engine over a synthetic request
stream: the paged engine for the families with a paged KV layout, fixed
slots for the others (SSM, hybrid, enc-dec) or with ``--engine fixed``; with ``--amm`` the MLPs run through the LUT-MU path, and
with ``--artifact`` the compiled tables of an ``amm_lm`` artifact or of a
target+draft bundle are spliced into the dense params (both packages'
artifacts load; ``--speculative`` serves a bundle's two halves, and
without ``--artifact`` compiles one from the dense params in process).

Examples:
  # on the card, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --amm

  # on the CPU, reduced widths (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --reduced --amm --device cpu

  # an SSM stack through the fixed-slot engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --reduced --engine fixed --device cpu

  # speculative serving of a bundle compiled in process (int8 target,
  # int4 draft, calibrated on 8 x 32 TokenStream tokens)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --reduced --speculative --device cpu

  # a bundle the JAX compiler wrote, served speculatively on the CPU,
  # sampled (the same seed gives the same streams)
  PYTHONPATH=src python -m repro.compiler bundle --arch qwen3-14b \\
      --reduced --out /tmp/lm_bundle
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --reduced --artifact /tmp/lm_bundle --speculative --device cpu \\
      --temperature 0.8 --top-k 8 --seed 0

  # observed: metrics, a trace, the SLO report, every 2nd step profiled
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --reduced --amm --device cpu --metrics serve.prom \\
      --trace-out trace.json --slo-report --profile-every 2
  PYTHONPATH=src python -m repro_torch.serving.obs --metrics serve.prom \\
      --trace trace.json

  # the HTTP front end: NDJSON token streams on localhost:8080
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --amm \\
      --http --port 8080 --metrics serve.prom

  # sharded serving on a data x model mesh: one process per rank (gloo on
  # the CPU, NCCL on cards); 1x1 needs no launcher
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --reduced --amm --device cpu --mesh 1x1
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen3-14b --reduced --amm --device cpu --mesh 2x2

``--ckpt DIR`` restores the params from a checkpoint of the same tree
(either package's checkpoint manager wrote it).  On a mesh every rank
serves the same schedule and rank 0 prints; each rank draws its params
leaf by leaf into its own shards (``init_params(..., shard=)``: the
seeded weights of one device, never the whole tree on a rank's host),
but for ``--artifact``, ``--ckpt`` and ``--quality-probe``, which read
or keep whole dense leaves: the whole tree is then made on the host and
the engine moves only the rank's shards to the card.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import restore_into
from repro_torch.compiler.artifact import ArtifactError, peek_manifest
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenStream
from repro_torch.device import MetaGenerator, resolve_device
from repro_torch.distributed.sharding import (flatten, leaf_cutter,
                                              param_shardings)
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import model as MD
from repro_torch.serving import (AsyncServer, KernelProfiler, QualityProbe,
                                 Recorder, SamplingParams,
                                 attach_dispatch_hook, load_engine, log,
                                 slo_report, summary_table)


def cli_prompts(prompt_specs, n_requests: int, vocab_size: int):
    """``--prompt`` token lists when given, else ``n_requests`` synthetic
    8-token prompts from the deterministic TokenStream (the JAX launcher's
    prompts)."""
    if prompt_specs:
        out = []
        for spec in prompt_specs:
            try:
                out.append([int(t) for t in spec.replace(",", " ").split()])
            except ValueError:
                raise SystemExit(f"--prompt must be token ids, got {spec!r}")
        return out
    stream = TokenStream(vocab_size=vocab_size, batch_size=1, seq_len=16)
    return [[int(t) for t in stream.batch(i)["tokens"][0][:8]]
            for i in range(n_requests)]


def _artifact_kind(path):
    try:
        return peek_manifest(path).get("kind")
    except (ArtifactError, OSError) as e:
        raise SystemExit(f"cannot read artifact {path!r}: {e}")


def _resolve_mesh(args, device):
    """``--mesh DxM`` → mesh; ``--mesh auto`` reads the artifact manifest."""
    if not args.mesh:
        return None
    if args.mesh != "auto":
        try:
            return make_serve_mesh(args.mesh, device)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
    if not args.artifact:
        raise SystemExit("--mesh auto needs --artifact (the manifest records "
                         "the intended mesh)")
    try:
        art_path = args.artifact
        if _artifact_kind(art_path) == "bundle":
            art_path = str(Path(art_path) / "target")
        manifest = peek_manifest(art_path)
    except (ArtifactError, OSError) as e:
        raise SystemExit(f"--mesh auto: cannot load artifact "
                         f"{args.artifact!r}: {e}")
    want = manifest.get("mesh")
    if not want:
        log("serve", "artifact records no intended mesh; serving unsharded")
        return None
    spec = f"{want['data']}x{want['model']}"
    try:
        mesh = make_serve_mesh(spec, device)
    except ValueError as e:
        log("serve", f"artifact-recorded mesh unusable ({e}); "
            "serving unsharded")
        return None
    log("serve", f"using artifact-recorded mesh {spec}")
    return mesh


def _report(rec, args) -> None:
    """The summary table, the SLO report and the metrics and trace files of
    one recorder."""
    print(summary_table(rec.registry))
    if args.slo_report:
        print(slo_report(rec.slo))
    if args.metrics:
        rec.write_metrics(args.metrics)
        log("serve", f"metrics (Prometheus text format) → {args.metrics}")
    if args.trace_out:
        rec.write_trace(args.trace_out)
        log("serve", f"trace (Chrome trace-event JSON) → {args.trace_out}")


def _serve_http(engine, args, rec) -> None:
    """Run the asyncio front end until interrupted, then report."""
    server = AsyncServer(engine, host=args.host, port=args.port,
                         rate_limit=args.rate_limit,
                         rate_burst=args.rate_burst)

    async def _run():
        await server.start()
        try:
            await server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await server.stop()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        log("serve", "interrupted; shutting down")
    if rec is not None:
        _report(rec, args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--amm", action="store_true",
                    help="serve MLPs through the LUT-MU path")
    ap.add_argument("--amm-backend", default="auto",
                    choices=("auto", "ref", "unfused", "fused"),
                    help="LUT-MU engine backend (kernels.dispatch); 'auto' "
                         "picks per dtype/device")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="decode batch rows (continuous-batching engine); "
                         "also the slot count of the fixed-slot engine")
    ap.add_argument("--slots", type=int, default=2,
                    help="deprecated alias of --max-batch")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size (tokens per page)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens prefilled per engine step")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV page-pool size; smaller than "
                         "max_batch*ceil(max_len/page_size) turns on "
                         "eviction (host swap) under pressure")
    ap.add_argument("--engine", choices=("paged", "fixed"), default=None,
                    help="force an engine; default: paged (continuous "
                         "batching) when the family supports it, else fixed "
                         "slots")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix prefix reuse: every request "
                         "prefills from scratch")
    ap.add_argument("--verify-backend", default="auto",
                    choices=("auto", "scan", "fused"),
                    help="speculative verify-window implementation: 'scan' "
                         "replays the window token by token (oracle), "
                         "'fused' runs the verify-window kernel per layer; "
                         "'auto' honours REPRO_VERIFY_BACKEND then fused")
    ap.add_argument("--artifact",
                    help="amm_lm artifact dir: serve its compiled LUT-MU "
                         "tables instead of the dense MLPs.  A bundle dir "
                         "serves its target half, or both halves with "
                         "--speculative")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-propose / target-verify serving of a bundle "
                         "--artifact (greedy streams equal the target's; "
                         "sampled streams are distributed as its plain "
                         "sampling)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens proposed per verify step (default: "
                         "the bundle manifest's recorded value, else 4)")
    ap.add_argument("--draft-resolution", default="int4",
                    choices=("float32", "int8", "int4"),
                    help="draft LUT width for the in-process bundle compile "
                         "(--speculative without a bundle --artifact)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 (default) = greedy argmax; "
                         "above 0 each request samples from its own seeded "
                         "stream (the JAX package's streams)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i uses seed+i")
    ap.add_argument("--mesh",
                    help="serve sharded on a 'DxM' (data x model) mesh, one "
                         "process per rank (torchrun --nproc-per-node D*M; "
                         "1x1 needs no launcher), or 'auto' to use the mesh "
                         "recorded in the --artifact manifest")
    ap.add_argument("--ckpt", help="restore params from a checkpoint dir "
                                   "(a tree of the same leaves)")
    ap.add_argument("--prompt", action="append", metavar="TOKENS",
                    help="explicit prompt as space/comma-separated token ids "
                         "(repeatable); replaces the synthetic requests")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP instead of draining a synthetic "
                         "batch: POST /v1/generate streams NDJSON tokens, "
                         "GET /metrics, /slo, /debug/quality and /healthz")
    ap.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=8080,
                    help="HTTP port (0 = ephemeral; printed on startup)")
    ap.add_argument("--rate-limit", type=float, default=None, metavar="RPS",
                    help="per-tenant request rate limit (token bucket, "
                         "requests/second; the X-Tenant header keys the "
                         "bucket); over-limit requests get 429")
    ap.add_argument("--rate-burst", type=float, default=None,
                    help="token-bucket burst size (default: max(1, "
                         "rate-limit))")
    ap.add_argument("--metrics", metavar="PATH",
                    help="record serving metrics, print a summary table, and "
                         "write a Prometheus text-format snapshot to PATH")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="record per-request lifecycle spans and write Chrome "
                         "trace-event JSON to PATH (Perfetto)")
    ap.add_argument("--quality-probe", type=float, default=0.0,
                    metavar="RATE",
                    help="replay this fraction of finished requests through "
                         "the dense reference: per-layer relative-error "
                         "histograms, codebook utilisation and dequant "
                         "saturation (GET /debug/quality)")
    ap.add_argument("--profile-every", type=int, default=0, metavar="N",
                    help="profile every N-th engine step: per-site latency "
                         "histograms (synced on profiled steps only), the "
                         "programs' flops/bytes and a 'kernels' trace lane "
                         "(0 = off)")
    ap.add_argument("--slo-report", action="store_true",
                    help="print the sliding-window SLO health report after "
                         "serving; live snapshot at GET /slo")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = _resolve_mesh(args, device)
    try:
        _serve(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> None:
    # on a mesh every rank serves the same schedule; rank 0 reports
    lead = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.amm:
        cfg = dataclasses.replace(
            cfg, amm=dataclasses.replace(cfg.amm, enabled=True,
                                         backend=args.amm_backend))
    dtype = torch.float32 if args.reduced else torch.bfloat16
    # on a mesh the params are drawn on the host and the engine moves only
    # this rank's shards to the card (the seed's weights are then the host
    # generator's, as with --device cpu)
    where = device if mesh is None else torch.device("cpu")
    gen = torch.Generator(device=where).manual_seed(0)
    # --artifact serves compiled tables spliced into a *dense* params tree
    serving = args.amm and not args.artifact
    shape = None
    if mesh is not None and not (args.artifact or args.ckpt
                                 or args.quality_probe):
        # each rank keeps its shards of each leaf as it is drawn
        shape = MD.init_params(cfg, MetaGenerator(), dtype, serving=serving)
        specs = flatten(param_shardings(shape, cfg, mesh))
        params = MD.init_params(cfg, gen, dtype, serving=serving,
                                shard=leaf_cutter(cfg, mesh, specs))
    else:
        params = MD.init_params(cfg, gen, dtype, serving=serving)
    if args.ckpt:
        params = restore_into(params, Path(args.ckpt), device=where)
    art_kind = _artifact_kind(args.artifact) if args.artifact else None
    # one recorder feeds the summary table, the Prometheus snapshot, the
    # Chrome trace and GET /metrics; without these flags engines keep the
    # NullRecorder
    rec = (Recorder(trace=bool(args.trace_out))
           if (args.metrics or args.trace_out or args.http
               or args.quality_probe or args.profile_every
               or args.slo_report) else None)
    if rec is not None and args.quality_probe:
        # ``params`` is the pre-splice tree: with --artifact it still holds
        # the dense mlp weights the probe references (LUT-MU params alone
        # degrade to utilisation/saturation tracking)
        rec.quality = QualityProbe(rec.registry, rate=args.quality_probe,
                                   dense_params=params)
    if rec is not None and args.profile_every:
        rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer,
                                      every=args.profile_every)
        attach_dispatch_hook(rec.registry)
    use_paged = (args.engine or
                 ("paged" if MD.supports_paged(cfg) else "fixed")) == "paged"
    kwargs = dict(max_batch=args.max_batch or args.slots, max_len=args.max_len,
                  page_size=args.page_size, prefill_chunk=args.prefill_chunk,
                  num_pages=args.num_pages,
                  prefix_cache=not args.no_prefix_cache,
                  verify_backend=args.verify_backend, compute_dtype=dtype,
                  device=device, recorder=rec, mesh=mesh)
    if shape is not None:
        kwargs["params_shape"] = shape
    if args.speculative:
        if not use_paged:
            raise SystemExit("--speculative needs the paged engine (family "
                             "with paged KV, --engine paged)")
        if mesh is not None:
            raise SystemExit("--speculative serving is single-device for "
                             "now (mesh support is a ROADMAP open item)")
        if args.spec_k is not None:
            kwargs["spec_k"] = args.spec_k
        if art_kind == "bundle":
            engine = load_engine(args.artifact, params, cfg, **kwargs)
        elif art_kind is not None:
            raise SystemExit(
                f"--speculative needs a target+draft bundle artifact, got "
                f"kind {art_kind!r} — compile one with `python -m "
                "repro_torch.compiler bundle`")
        else:
            if args.amm:
                raise SystemExit("--speculative without an artifact "
                                 "calibrates from the dense MLPs — drop "
                                 "--amm (the compiled bundle IS the LUT-MU "
                                 "path)")
            from repro_torch.compiler import compile_lm_bundle
            kwargs.setdefault("spec_k", 4)
            calib = TokenStream(vocab_size=cfg.vocab_size, batch_size=8,
                                seq_len=32)
            log("serve", f"compiling in-process bundle (target=int8, "
                f"draft={args.draft_resolution}) on {device}…")
            res = compile_lm_bundle(
                params, cfg, calib.batch(0)["tokens"],
                target_resolution="int8",
                draft_resolution=args.draft_resolution,
                spec_k=kwargs["spec_k"])
            engine = load_engine((res.target, res.draft), params, cfg,
                                 **kwargs)
    else:
        # a bundle without --speculative serves its full-resolution target
        # half, the stream-defining model
        engine = load_engine(args.artifact, params, cfg,
                             engine=args.engine or "auto", speculative=False,
                             **kwargs)
    del params  # the engine holds what it serves (on a mesh: its shards)
    if args.http:
        if mesh is not None and dist.get_world_size() > 1:
            raise SystemExit("--http serves from one process; a mesh of "
                             "more than one rank serves a batch (drop "
                             "--http)")
        _serve_http(engine, args, rec)
        return
    for i, prompt in enumerate(cli_prompts(args.prompt, args.requests,
                                           cfg.vocab_size)):
        engine.submit(prompt, SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed + i), max_new_tokens=args.max_new)
    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    if not lead:
        return
    n_tok = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {n_tok} tokens, {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s) on {device}")
    if args.speculative:
        log("spec", f"k={engine.spec_k} rounds={engine.stats['rounds']} "
            f"acceptance={engine.acceptance_rate:.3f} "
            f"tokens/round={engine.mean_emitted_per_round:.2f}")
    if rec is not None:
        _report(rec, args)
    for r in done:
        print(f"  req {r.uid}: {r.prompt} → {r.generated}")


if __name__ == "__main__":
    main()
