"""mfu.ttft: dense-equivalent model FLOPs of the window's work over (busy step seconds x 989 TFLOP/s), in %."""
from portbench.harness.readers import mfu

LAYER = "model step (models/model.py paged prefill and decode; models/cnn.py::resnet9_forward)"
MOVES = "ttft_p90_s"


def read(ctx):
    return mfu(ctx)
