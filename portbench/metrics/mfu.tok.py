"""mfu.tok: dense-equivalent model FLOPs of the window's work over (busy step seconds x 989 TFLOP/s), in %."""
from portbench.harness.readers import mfu

LAYER = "model step (models/model.py paged prefill and decode; models/cnn.py::resnet9_forward)"
MOVES = "tok_s"


def read(ctx):
    return mfu(ctx)
