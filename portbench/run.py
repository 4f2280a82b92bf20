"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, last, the
numbers compared with their limits (``checks``); the same numbers are
the last lines of standard error.  Without a card, with fewer cards
than the cell asks for, or with JAX loaded once the window has closed,
it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "optax", "tgp_tpu")


def banned_modules() -> list:
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in BANNED)


def finite(value: float) -> float:
    """A number JSON can hold: a failed or missing reading reads 1e300."""
    return value if math.isfinite(value) else 1e300


def _environment() -> None:
    """CUDA's own cache inside the checkout, at a fixed path.  Before
    torch loads.  Cores and threads are the caller's: the run keeps the
    affinity and thread counts it inherits."""
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / ".cache" / "portbench" / "cuda"))


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, system: str = "program", fault=None) -> dict:
    """One run: the loop's output plus the metrics its readers give."""
    from portbench.harness import loops, spec

    runner = {"serve": loops.serve, "train": loops.train}[
        cell.traffic["loop"]]
    out = runner(cell, seed, seconds, traced, device, t_start,
                 system=system, fault=fault)
    metrics = {}
    for m in cell.metrics(traced):
        value = spec.metric_reader(m["name"]).read(out["ctx"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": out["checks"].get(name, math.inf),
                     "limit": limit}
              for name, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return dict(correct=correct, attempted=out["attempted"], failed=0,
                metrics=metrics, peak=out["peak"], ctx=out["ctx"],
                checks=checks, readings=out["checks"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    found = banned_modules()
    if found:
        print(f"modules loaded that the port may not load: {found}",
              file=sys.stderr)
        return 3
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"],
                device=dict(platform="gpu",
                            kind=torch.cuda.get_device_name(device),
                            count=cell.chips,
                            memory_peak_bytes=res["peak"]))
    red = res["ctx"].get("trace")
    if args.trace:
        if not red:
            print("the trace holds no traced iteration", file=sys.stderr)
            return 4
        line["device"].update(busy_s=red["busy_s"], window_s=red["window_s"])
        line["breakdown"] = dict(device_ops=red["device_ops"],
                                 idle_gaps=red["idle_gaps"])
    line["checks"] = {k: dict(value=finite(c["value"]), limit=c["limit"])
                      for k, c in res["checks"].items()}
    readings = {k: v for k, v in res["readings"].items()
                if k not in res["checks"]}
    ctx = res["ctx"]
    print(json.dumps(dict(seed=args.seed, readings=readings,
                          setup_phases_s=ctx["setup_phases"],
                          chunks_ms=ctx["chunks_ms"],
                          new_buckets=ctx.get("new_buckets"))),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
