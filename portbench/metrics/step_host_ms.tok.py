"""step_host_ms.tok: mean host ms of a window step outside its program calls (the recorder's decode and prefill spans against the step's host clock)."""
from portbench.harness.readers import mean_of

LAYER = "serving/engine.py::ServeEngine.step + serving/scheduler.py"
MOVES = "tok_s"


def read(ctx):
    return mean_of(ctx, "step_host_ms")
