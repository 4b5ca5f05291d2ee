"""Readings that a cell's correctness limit is set from, in one process on
the card: the program's compared number on each of ``--seeds`` (a short
window at the cell's own load and sizes, then the benchmark's own check),
and the control's on each of ``--control-seeds`` (the driver's
``control``: the reference in the precision below the configuration's, in
the program's place, on that run's own sample).  The benchmark's runs
never run the control.

    python3 portbench/tools/limits.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 --control-seeds 1,2,3 [--out file.jsonl]

Prints one JSON line per run: the seed, the program's reading, the
control's (where asked), and the run's end-to-end metrics.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(
        ROOT / "portbench" / ".cache" / "lutmu_autotune.json")
    import torch

    from portbench.harness import cell as C
    from portbench.harness import result as R
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = C.resolve(args.workload, ROOT)
    drv = C.driver(cell, ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res = drv.run(cell, seed=seed, seconds=args.seconds, trace=False,
                      device="cuda", t_start=t0)
        rec = {"workload": cell.name, "seed": seed,
               "program": {k: c.value for k, c in res.checks.items()},
               "correct": res.correct, "problems": res.problems,
               "metrics": R.metric_values(cell.end_to_end, res.ctx,
                                          lambda m: C.reader(m, ROOT)),
               "device": res.device}
        if seed in controls:
            t1 = time.perf_counter()
            rec["control"] = drv.control(cell, res, "cuda")
            rec["control_s"] = time.perf_counter() - t1
        rec["run_s"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
