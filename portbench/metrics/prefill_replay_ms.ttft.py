"""prefill_replay_ms.ttft: mean device ms of the prefill-chunk program's calls in the window (CUDA events around each call)."""
from portbench.harness.readers import mean_of

LAYER = "serving/programs.py::StepProgram"
MOVES = "ttft_p90_s"


def read(ctx):
    return mean_of(ctx, "replay_ms", "prefill")
