"""images_s: images whose logits completed in the window over the window (images/s)."""
LAYER = None
MOVES = None


def read(ctx):
    if "images" not in ctx:
        return None
    return ctx["images"] / ctx["window_s"]
