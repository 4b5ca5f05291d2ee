"""device_idle.ttft: share of the traced slice with no kernel running on the device, in %."""
from portbench.harness.readers import device_idle

LAYER = "device"
MOVES = "ttft_p90_s"


def read(ctx):
    return device_idle(ctx)
