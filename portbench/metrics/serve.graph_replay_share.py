"""Share of the traced requests served by replaying a captured CUDA graph:
100 × the requests whose every ``tgp.model.forward`` span says ``graph ==
"replay"``, over the requests whose forward spans say how they ran; None
where none does (a program that does not record it)."""

from portbench.harness.spans import requests


def read(ctx):
    said = [[r["attrs"]["graph"] for r in g
             if r["name"] == "tgp.model.forward" and "graph" in r["attrs"]]
            for g in requests() or []]
    said = [hows for hows in said if hows]
    if not said:
        return None
    return 100.0 * sum(all(h == "replay" for h in hows)
                       for hows in said) / len(said)
