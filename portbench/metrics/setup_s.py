"""setup_s: from the start of the process to the first instant of the window (s)."""
LAYER = None
MOVES = None


def read(ctx):
    return ctx["setup_s"]
