"""CPU fixtures of the benchmark's tests: the repository's ``src`` on the
path, and the benchmark's cells cut to a size a CPU test holds."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LM = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=32,
               vocab_size=512)
# the CNN keeps its widths and images: a smaller network has too few tree
# decisions for the TF32 control to move one
TINY_CNN = dict(channels=[64, 128, 256, 512], image=[32, 32, 3])


def tiny_cell(workload: str):
    """``workload`` with its configuration's widths and its traffic's sizes
    cut for the CPU (the same code paths, drivers and references)."""
    from portbench.harness import cell as C
    cell = C.resolve(workload, ROOT)
    mix = copy.deepcopy(cell.mix)
    if cell.config.DRIVER == "serve":
        cell.sizes = dict(cell.sizes, **TINY_LM)
        mix["engine"].update(max_batch=4, max_len=64, prefill_chunk=16)
        mix.update(prompt_len={"median": 16, "sigma": 0.3, "min": 8, "max": 24},
                   output_len={"median": 12, "sigma": 0.3, "min": 8, "max": 24},
                   max_total=64)
        if mix["arrival"] == "backlog":
            mix["requests"] = 200
        else:
            mix.update(rate_per_s=3.0, warmup_s=2.0, tail_s=20.0)
    else:
        cell.sizes = dict(cell.sizes, **TINY_CNN)
        mix.update(batch=2, pool_batches=2, warmup_forwards=1,
                   check_forwards=2)
    cell.mix = mix
    return cell


@pytest.fixture
def run_tiny():
    """Run a cut cell on the CPU through its driver, as ``run.py`` would
    past its look for a card."""
    import time

    from portbench.harness import cell as C

    def run(workload: str, seed: int = 2**31 + 11, seconds: float = None,
            trace: bool = False, **mix):
        cell = tiny_cell(workload)
        cell.mix.update(mix)
        if seconds is None:  # long enough for a few greedy requests to finish
            seconds = {"poisson": 6.0, "backlog": 4.0}.get(
                cell.mix.get("arrival"), 2.0)
        drv = C.driver(cell, ROOT)
        return cell, drv, drv.run(cell, seed=seed, seconds=seconds,
                                  trace=trace, device="cpu",
                                  t_start=time.perf_counter())
    return run
