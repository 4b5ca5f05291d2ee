"""device_idle.tok: share of the traced slice with no kernel running on the device, in %."""
from portbench.harness.readers import device_idle

LAYER = "device"
MOVES = "tok_s"


def read(ctx):
    return device_idle(ctx)
