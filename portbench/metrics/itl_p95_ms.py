"""itl_p95_ms: 95th percentile of the gaps between consecutive output tokens of a request, pooled over the window (ms)."""
from portbench.harness.readers import percentile_of

LAYER = None
MOVES = None


def read(ctx):
    return percentile_of(ctx, "itl_ms", 95)
