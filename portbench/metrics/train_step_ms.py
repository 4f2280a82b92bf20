"""The window's time over the steps completed in it; the window ends in
a synchronize (host clock)."""


def read(ctx):
    steps = ctx.get("steps")
    return 1e3 * ctx["window_s"] / steps if steps else None
