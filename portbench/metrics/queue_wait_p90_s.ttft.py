"""queue_wait_p90_s.ttft: 90th percentile of submission to admission (the recorder's queued spans) of the requests due in the window (s)."""
from portbench.harness.readers import percentile_of

LAYER = "serving/engine.py::ServeEngine.step + serving/scheduler.py"
MOVES = "ttft_p90_s"


def read(ctx):
    return percentile_of(ctx, "queue_wait_s", 90)
