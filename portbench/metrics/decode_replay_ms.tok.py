"""decode_replay_ms.tok: mean device ms of the decode program's calls in the window (CUDA events around each call: its input copy and graph replay)."""
from portbench.harness.readers import mean_of

LAYER = "serving/programs.py::StepProgram"
MOVES = "tok_s"


def read(ctx):
    return mean_of(ctx, "replay_ms", "decode")
