"""CUDA kernels the profiler sees per traced step."""


def read(ctx):
    red, steps = ctx.get("trace", {}), len(ctx.get("work", []))
    return red["kernels"] / steps if red and steps else None
