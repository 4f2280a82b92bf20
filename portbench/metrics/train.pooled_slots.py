"""Node slots of the pooled graphs a step: the sum of the ``slots``
attributes of the ``tgp.model.pool`` spans (every level), mean over the
traced steps that hold one; None where no pool span carries it."""

from portbench.harness.spans import requests


def read(ctx):
    steps = [[r["attrs"]["slots"] for r in g
              if r["name"] == "tgp.model.pool" and "slots" in r["attrs"]]
             for g in requests() or []]
    steps = [s for s in steps if s]
    return sum(map(sum, steps)) / len(steps) if steps else None
