"""Roofline analysis from the dry-run records, as in
``repro.analysis.roofline``, for the NVIDIA H100.

Per (arch × shape × mesh) cell, from ``launch/dryrun.py``'s JSON (either
package's: the field names are the JAX record's):

    compute term    = FLOPs_per_device / PEAK_FLOPS                [s]
    memory term     = bytes_per_device / HBM_BW                    [s]
    collective term = collective_bytes_per_device / LINK_BW        [s]

Hardware constants: NVIDIA H100 SXM 80 GB, the data sheet's published
peaks at the full 700 W power limit (a card set below it runs slower):
989 TFLOP/s bf16 dense (no sparsity), 3.35 TB/s HBM3, NVLink 450 GB/s each
way.  These are peaks, not measurements.  NVLink joins the 8 cards of one
host; a mesh that spans more than one host also crosses the slower
inter-host network, so the collective term is a lower bound on such a
mesh's collective time.

MODEL_FLOPS (global): train 6·N·D, prefill 2·N·D, decode 2·N·D with
N = active params (MoE) and D = tokens; the usefulness ratio
MODEL_FLOPS / (FLOPs × devices) exposes remat and redundancy overhead.
"""
from __future__ import annotations

import glob
import json
from pathlib import Path
from typing import List, Optional

PEAK_FLOPS = 989e12        # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12           # bytes/s / card
LINK_BW = 450e9            # bytes/s / card each way (NVLink)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results_torch"


def model_flops(record: dict) -> float:
    """Analytic 'useful' FLOPs for the whole step (global, all devices)."""
    n = record["active_param_count"]
    d_tokens = record["tokens"]
    if record["kind"] == "train":
        return 6.0 * n * d_tokens
    return 2.0 * n * d_tokens


def roofline_terms(record: dict) -> Optional[dict]:
    if record.get("status") != "ok":
        return None
    corr = record.get("corrected") or {
        "flops_per_device": record["flops_per_device"],
        "bytes_per_device": record["bytes_per_device"],
        "collective_bytes_per_device":
            record["collectives"]["total_bytes"],
    }
    chips = record["num_devices"]
    compute_s = corr["flops_per_device"] / PEAK_FLOPS
    memory_s = corr["bytes_per_device"] / HBM_BW
    coll_s = corr["collective_bytes_per_device"] / LINK_BW
    bound = max(("compute", compute_s), ("memory", memory_s),
                ("collective", coll_s), key=lambda kv: kv[1])
    mf = model_flops(record)
    flops_global = corr["flops_per_device"] * chips
    achievable_s = max(compute_s, memory_s, coll_s)
    # roofline fraction: useful model flops against peak compute for the
    # time the dominant term pins the step to.  Decode is memory-bound by
    # construction, so memory efficiency is reported too: the least traffic
    # (arguments and outputs once) over the counted bytes.
    mfu_bound = (mf / chips / PEAK_FLOPS) / achievable_s if achievable_s else 0
    mem = record["memory_analysis"]
    min_traffic = mem["argument_size_bytes"] + mem["output_size_bytes"]
    mem_eff = (min_traffic / corr["bytes_per_device"]
               if corr["bytes_per_device"] else 0.0)
    return {
        "arch": record["arch"],
        "shape": record["shape"],
        "mesh": record["mesh"],
        "kind": record["kind"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bottleneck": bound[0],
        "bound_s": achievable_s,
        "model_flops": mf,
        "hlo_flops_global": flops_global,
        "useful_ratio": mf / flops_global if flops_global else 0.0,
        "roofline_fraction": mfu_bound,
        "memory_efficiency": mem_eff,
        "temp_gib": mem["temp_size_bytes"] / 2**30,
        "amm": record.get("amm", False),
    }


def load_all(mesh: Optional[str] = None, amm: Optional[bool] = None
             ) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(str(RESULTS_DIR / "*.json"))):
        rec = json.loads(Path(f).read_text())
        if mesh and rec.get("mesh") != mesh:
            continue
        if amm is not None and rec.get("amm", False) != amm:
            continue
        t = roofline_terms(rec)
        if t is None:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"), "skipped": True,
                         "reason": rec.get("reason")})
        else:
            rows.append(t)
    return rows


def format_table(rows: List[dict]) -> str:
    hdr = (f"{'arch':25s} {'shape':12s} {'mesh':8s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'bound':>10s} "
           f"{'useful':>7s} {'roofl%':>7s} {'mem_eff':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"{r['arch']:25s} {r['shape']:12s} "
                         f"{r.get('mesh') or '':8s} "
                         f"{'— skipped: ' + (r.get('reason') or '')}")
            continue
        lines.append(
            f"{r['arch']:25s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['compute_s']:10.4f} {r['memory_s']:10.4f} "
            f"{r['collective_s']:10.4f} {r['bottleneck']:>10s} "
            f"{r['useful_ratio']:7.3f} {100 * r['roofline_fraction']:6.1f}% "
            f"{r['memory_efficiency']:8.3f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.roofline")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--amm", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all(mesh=args.mesh, amm=args.amm if args.amm else None)
    print(format_table(rows))


if __name__ == "__main__":
    main()
