"""CLI of the port's offline LUT-MU compiler: ``python -m repro_torch.compiler``.

Usage:
  # compile a randomly-initialised LM's MLP blocks (fitted on the card by
  # default; --device cpu fits on the CPU)
  PYTHONPATH=src python -m repro_torch.compiler lm --arch qwen3-14b \\
      --reduced --device cpu --out artifacts/qwen_amm

  # a target+draft bundle for speculative serving, from one calibration
  PYTHONPATH=src python -m repro_torch.compiler bundle --arch qwen3-14b \\
      --reduced --device cpu --out artifacts/qwen_bundle

  # train the demo MLP on synthetic MNIST and compile it (an amm_chain
  # artifact), reloading it to check the round trip
  PYTHONPATH=src python -m repro_torch.compiler mlp --device cpu \
      --resolution int8 --out artifacts/mlp_int8 --verify

  # inspect / verify an artifact or bundle (either package's)
  PYTHONPATH=src python -m repro_torch.compiler inspect artifacts/qwen_amm
  PYTHONPATH=src python -m repro_torch.compiler verify artifacts/qwen_amm

``lm`` and ``bundle`` take ``--ckpt DIR``: the params restored from a
checkpoint of the dense model's params (either package's format).
``--mesh DxM`` records the intended serving mesh in the manifest, which
``launch.serve --mesh auto`` reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def _print_report(report: dict) -> None:
    print("resource report (total LUT bytes):")
    print(f"  {'config':>8}  {'pruned':>12}  {'unpruned':>12}  "
          f"{'vs f32 unpruned':>15}")
    for name, rec in report.get("configs", {}).items():
        print(f"  {name:>8}  {rec['pruned_lut_bytes']:>12}  "
              f"{rec['unpruned_lut_bytes']:>12}  "
              f"{rec['savings_vs_float32_unpruned']:>14.2f}x")


def _print_stages(clock, n_layers: int) -> None:
    parts = ", ".join(f"{k} {v:.2f}" for k, v in clock.seconds.items())
    total = sum(clock.seconds.values())
    print(f"[compiler] seconds: {parts}; total {total:.2f} "
          f"({total / max(n_layers, 1):.2f} per layer)")


def cmd_mlp(args) -> int:
    from repro_torch.compiler import compile_chain, load_artifact
    from repro_torch.data import synthetic_mnist
    from repro_torch.device import resolve_device
    from repro_torch.models import cnn

    if args.verify and not args.out:
        print("--verify needs --out (nothing to reload otherwise)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    x, y = synthetic_mnist(args.samples, seed=1)
    cfg = cnn.MLPConfig(sizes=tuple(args.sizes))
    n_layers = len(cfg.sizes) - 1
    nc = args.num_codebooks or [max(1, s // 8) for s in cfg.sizes[:-1]]
    if len(nc) != n_layers:
        print(f"--num-codebooks needs {n_layers} values", file=sys.stderr)
        return 2
    print(f"[compiler] training exact MLP {cfg.sizes} "
          f"({args.train_steps} steps) on {device}…")
    params = cnn.mlp_train(cfg, x, y, steps=args.train_steps, lr=0.1,
                           device=device)
    weights = [params[f"w{i}"].cpu().numpy() for i in range(n_layers)]
    biases = [params[f"b{i}"].cpu().numpy() for i in range(n_layers)]
    print(f"[compiler] calibrating on {args.calib} samples, "
          f"resolution={args.resolution}…")
    result = compile_chain(
        weights, biases, torch.from_numpy(x[:args.calib]).to(device),
        num_codebooks=nc, depths=[args.depth] * n_layers,
        activations=["relu"] * (n_layers - 1),
        resolution=args.resolution, prune=not args.no_prune,
        autotune=args.autotune, name="mlp-demo", out=args.out)
    _print_report(result.report)
    acc = cnn.mlp_accuracy(lambda xb: result.chain(xb), x[:512], y[:512],
                       device=device)
    exact = cnn.mlp_accuracy(lambda xb: cnn.mlp_forward(params, xb, n_layers),
                         x[:512], y[:512], device=device)
    print(f"[compiler] accuracy: exact={exact:.3f} compiled={acc:.3f}")
    if args.out:
        print(f"[compiler] wrote artifact → {result.path}")
        if args.verify:
            chain = load_artifact(result.path).to_chain(device=device)
            xb = torch.from_numpy(x[:64]).to(device)
            ok = torch.equal(result.chain(xb), chain(xb))
            print(f"[compiler] round-trip bit-identical: {ok}")
            return 0 if ok else 1
    return 0


def _lm_setup(args):
    """Shared ``lm`` / ``bundle`` preamble → (cfg, params, tokens,
    device, mesh_shape) or an error string."""
    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.models import model as MD

    from repro_torch.launch.mesh import parse_mesh_spec

    mesh_shape = None
    if args.mesh:
        try:
            data, model = parse_mesh_spec(args.mesh)
        except ValueError as e:
            return None, f"--mesh: {e}"
        mesh_shape = {"data": data, "model": model}
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(
        cfg, amm=dataclasses.replace(cfg.amm, enabled=True))
    params = MD.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            torch.float32)
    if args.ckpt:  # a checkpoint of the same tree, either package's
        params = restore_into(params, args.ckpt, device=device)
    ts = TokenStream(vocab_size=cfg.vocab_size, batch_size=args.calib_batch,
                     seq_len=args.calib_seq)
    tokens = np.asarray(ts.batch(0)["tokens"])
    return (cfg, params, tokens, device, mesh_shape), None


def cmd_lm(args) -> int:
    from repro_torch.compiler import compile_lm_amm
    from repro_torch.device import StageClock

    setup, err = _lm_setup(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    cfg, params, tokens, device, mesh_shape = setup
    resolution = args.resolution
    if args.float_luts:  # back-compat alias for the pre-resolution flag
        if resolution is not None and resolution != "float32":
            print("--float-luts contradicts --resolution "
                  f"{resolution} — pick one", file=sys.stderr)
            return 2
        resolution = "float32"
    if resolution is None:
        resolution = "int8"
    print(f"[compiler] capturing MLP inputs for {cfg.num_layers} layers "
          f"on {device}…")
    clock = StageClock()
    result = compile_lm_amm(params, cfg, tokens, out=args.out,
                            mesh_shape=mesh_shape, resolution=resolution,
                            clock=clock)
    _print_stages(clock, cfg.num_layers)
    print(f"[compiler] amm_lm artifact ({result.artifact.resolution}): "
          f"{result.report['lut_bytes']} LUT bytes → "
          f"{result.path or '(not saved)'}")
    return 0


def cmd_bundle(args) -> int:
    from repro_torch.compiler import compile_lm_bundle
    from repro_torch.device import StageClock

    setup, err = _lm_setup(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    cfg, params, tokens, device, mesh_shape = setup
    print(f"[compiler] one calibration pass for {cfg.num_layers} layers on "
          f"{device}, baking target={args.target_resolution} + "
          f"draft={args.draft_resolution}…")
    clock = StageClock()
    result = compile_lm_bundle(
        params, cfg, tokens, out=args.out,
        target_resolution=args.target_resolution,
        draft_resolution=args.draft_resolution, spec_k=args.spec_k,
        mesh_shape=mesh_shape,
        clock=clock)
    _print_stages(clock, cfg.num_layers)
    r = result.report
    print(f"[compiler] bundle: target {r['target']['lut_bytes']} LUT bytes "
          f"({r['target']['resolution']}), draft {r['draft']['lut_bytes']} "
          f"({r['draft']['resolution']}), draft ships "
          f"{r['draft_vs_target_stored']:.2f}x smaller → "
          f"{result.path or '(not saved)'}")
    return 0


def cmd_inspect(args) -> int:
    from repro_torch.compiler import load_artifact, load_bundle, peek_manifest

    if peek_manifest(args.path).get("kind") == "bundle":
        _, _, manifest = load_bundle(args.path)
        print(json.dumps(manifest, indent=2))
        return 0
    art = load_artifact(args.path)
    m = dict(art.manifest)
    m.pop("resource_report", None)
    print(json.dumps(m, indent=2))
    _print_report(art.resource_report)
    return 0


def cmd_verify(args) -> int:
    from repro_torch.compiler import load_artifact, load_bundle, peek_manifest
    from repro_torch.device import resolve_device

    if peek_manifest(args.path).get("kind") == "bundle":
        target, draft, _ = load_bundle(args.path)  # full validation
        print(f"[compiler] {args.path}: bundle "
              f"(target={target.resolution}, draft={draft.resolution}) — "
              "manifests/checksums OK")
        return 0
    art = load_artifact(args.path)  # checksum + schema validation happens here
    print(f"[compiler] {args.path}: kind={art.kind} "
          f"resolution={art.resolution} — manifest/checksum OK")
    if art.kind == "amm_chain":
        device = resolve_device(args.device)
        chain = art.to_chain(device=device)
        d = art.manifest["layers"][0]["in_features"]
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(16, d)).astype(np.float32)).to(device)
        out = chain(x)
        finite = bool(torch.isfinite(out).all())
        print(f"[compiler] forward smoke on {device}: out shape "
              f"{tuple(out.shape)}, finite={finite}")
        return 0 if finite else 1
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the fit runs on (default cuda; 'cpu' "
                        "fits on the CPU)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.compiler")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mlp = sub.add_parser("mlp", help="train and compile the demo MLP")
    mlp.add_argument("--sizes", type=int, nargs="+",
                     default=[784, 128, 128, 10])
    mlp.add_argument("--samples", type=int, default=2048)
    mlp.add_argument("--calib", type=int, default=1024)
    mlp.add_argument("--train-steps", type=int, default=250)
    mlp.add_argument("--num-codebooks", type=int, nargs="+", default=None)
    mlp.add_argument("--depth", type=int, default=4)
    mlp.add_argument("--resolution", default="float32",
                     choices=("float32", "int16", "int8", "int4"))
    mlp.add_argument("--no-prune", action="store_true")
    mlp.add_argument("--autotune", action="store_true")
    mlp.add_argument("--out")
    mlp.add_argument("--verify", action="store_true",
                     help="reload the artifact and check bit-identity")
    _device_arg(mlp)
    mlp.set_defaults(fn=cmd_mlp)

    lm = sub.add_parser("lm", help="compile an LM's MLP blocks (amm_lm)")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--ckpt", help="restore params from a checkpoint dir")
    lm.add_argument("--calib-batch", type=int, default=8)
    lm.add_argument("--calib-seq", type=int, default=32)
    lm.add_argument("--resolution", default=None,
                    choices=("float32", "int8", "int4"),
                    help="LUT entry width baked into the artifact "
                         "(default int8)")
    lm.add_argument("--float-luts", action="store_true",
                    help="deprecated alias of --resolution float32")
    lm.add_argument("--mesh",
                    help="intended serving mesh 'DxM' (data x model), "
                         "recorded in the manifest for --mesh auto serving")
    lm.add_argument("--out")
    _device_arg(lm)
    lm.set_defaults(fn=cmd_lm)

    bd = sub.add_parser(
        "bundle",
        help="compile a target+draft artifact pair for speculative decoding")
    bd.add_argument("--arch", required=True)
    bd.add_argument("--reduced", action="store_true")
    bd.add_argument("--ckpt", help="restore params from a checkpoint dir")
    bd.add_argument("--calib-batch", type=int, default=8)
    bd.add_argument("--calib-seq", type=int, default=32)
    bd.add_argument("--target-resolution", default="int8",
                    choices=("float32", "int8", "int4"),
                    help="verifier LUT width (defines the served streams)")
    bd.add_argument("--draft-resolution", default="int4",
                    choices=("float32", "int8", "int4"),
                    help="proposer LUT width (cheaper = the throughput win)")
    bd.add_argument("--spec-k", type=int, default=4,
                    help="suggested draft tokens per verify step, recorded "
                         "in the bundle manifest")
    bd.add_argument("--mesh", help="intended serving mesh 'DxM' (recorded "
                                   "in both halves' manifests)")
    bd.add_argument("--out")
    _device_arg(bd)
    bd.set_defaults(fn=cmd_bundle)

    ins = sub.add_parser("inspect", help="print an artifact's manifest")
    ins.add_argument("path")
    ins.set_defaults(fn=cmd_inspect)

    ver = sub.add_parser("verify", help="validate + smoke-run an artifact")
    ver.add_argument("path")
    _device_arg(ver)
    ver.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
