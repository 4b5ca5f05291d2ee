"""ttft_p90_s: 90th percentile over the requests due in the window of first token on the host minus scheduled arrival (s)."""
from portbench.harness.readers import percentile_of

LAYER = None
MOVES = None


def read(ctx):
    return percentile_of(ctx, "ttft_s", 90)
