"""The knee of an open-loop serving cell: the highest arrival rate at which
the backlog does not grow over a window, found once by a sweep on the card.

    python3 portbench/tools/knee.py --workload <cell> --rates 1,1.5,2 \\
        [--warmup 10] [--seconds 30] [--seed 1]

One engine serves every rate in turn (its programs captured once).  At each
rate the mix's requests arrive open loop for ``warmup + seconds``; the
backlog (submitted requests without a first token) is sampled after every
step of the window.  Prints one JSON line per rate: the backlog at the
window's start and end, its least-squares slope (requests/s), the
time-to-first-token percentiles and the output tokens per second of the
window.  Requests still live at the end are cancelled before the next rate.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def slope(ts, ys) -> float:
    n = len(ts)
    if n < 2:
        return 0.0
    mt, my = sum(ts) / n, sum(ys) / n
    var = sum((t - mt) ** 2 for t in ts)
    return sum((t - mt) * (y - my) for t, y in zip(ts, ys)) / var if var else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--warmup", type=float, default=10.0)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(
        ROOT / "portbench" / ".cache" / "lutmu_autotune.json")
    import torch

    from portbench.harness import cell as C
    from portbench.harness import device as D
    from portbench.harness import stats as S
    from portbench.harness import traffic as TR
    from repro_torch.serving import load_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = C.resolve(args.workload, ROOT)
    drv = C.driver(cell, ROOT)
    mod, sizes, mix = cell.config, cell.sizes, cell.mix
    D.build_kernels("cuda")
    params = mod.make_params(sizes, args.seed, "cuda")
    engine = load_engine(None, params, mod.model_config(sizes),
                         compute_dtype=torch.bfloat16, device="cuda",
                         **mix["engine"])
    drv._warm_up(engine, mix, sizes["vocab_size"], args.seed)
    for rate in [float(r) for r in args.rates.split(",")]:
        m = dict(mix, rate_per_s=rate)
        reqs = TR.generate(m, args.seed, sizes["vocab_size"],
                           args.warmup + args.seconds)
        loop = drv._Loop(engine, reqs, False)
        w0 = loop.origin + args.warmup
        w1 = w0 + args.seconds
        ts, backlog = [], []
        tok0 = None
        while time.perf_counter() < w1:
            loop.tick()
            now = time.perf_counter()
            if now >= w0:
                if tok0 is None:
                    tok0 = sum(g for _, g in loop.progress())
                ts.append(now - w0)
                backlog.append(sum(1 for i, h in enumerate(loop.handles)
                                   if h is not None and i not in loop.first))
        toks = sum(g for _, g in loop.progress()) - tok0
        due = [i for i, r in enumerate(reqs)
               if args.warmup <= r.due < args.warmup + args.seconds]
        ttft = [loop.first[i] - loop.origin - reqs[i].due for i in due
                if i in loop.first]
        print(json.dumps({
            "rate_per_s": rate, "due": len(due), "served_first": len(ttft),
            "backlog_start": backlog[0], "backlog_end": backlog[-1],
            "backlog_slope_per_s": slope(ts, backlog),
            "ttft_p50_s": S.percentile(ttft, 50) if ttft else None,
            "ttft_p90_s": S.percentile(ttft, 90) if ttft else None,
            "tok_s": toks / args.seconds,
            "lateness_max_s": max(loop.late) if loop.late else None}),
            flush=True)
        for h in loop.handles:
            if h is not None and not h.done:
                h.cancel()
        engine.run_until_drained()
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
