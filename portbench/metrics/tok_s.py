"""tok_s: output tokens that reached the host in the window over the window (tokens/s)."""
LAYER = None
MOVES = None


def read(ctx):
    if "tokens_out" not in ctx:
        return None
    return ctx["tokens_out"] / ctx["window_s"]
