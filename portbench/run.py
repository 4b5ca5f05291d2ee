"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed on the card, kernels built or
loaded, the engine or model built and every shape it uses warmed up) is
``setup_s``; then the cell's driver measures for ``--seconds``, checks what
the timed path produced against the plain reference, and the last line of
standard output is the result: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``.  Exits non-zero
with no result where no card is present, where the cell needs more cards
than there are, or where the JAX stack or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # the program's LUT-MU launch-plan cache, at a fixed path in the checkout
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(
        ROOT / "portbench" / ".cache" / "lutmu_autotune.json")
    from portbench.harness import cell as C
    from portbench.harness import result as R

    cell = C.resolve(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outcome = C.driver(cell, ROOT).run(cell, seed=args.seed,
                                       seconds=args.seconds,
                                       trace=bool(args.trace), device="cuda",
                                       t_start=T_START)
    bad = R.forbidden_modules()
    if bad:
        print(f"refused: the process loaded {bad}", file=sys.stderr)
        return 3
    metrics = R.metric_values(cell.per_layer if args.trace else cell.end_to_end,
                              outcome.ctx, lambda m: C.reader(m, ROOT))
    R.print_checks(outcome)
    print(R.line(outcome, metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
