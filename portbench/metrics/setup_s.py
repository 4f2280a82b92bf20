"""Set-up: process start to the first measured request or step (host
clock): loading, weights, the batch, warm-up and, in a checkout's first
run, the kernels' build."""


def read(ctx):
    return ctx["setup_s"]
