"""1 − device busy / wall over the traced requests' own spans."""

from portbench.harness.readers import serve_idle


def read(ctx):
    return serve_idle(ctx)
