"""Readings that set a cell's limits, taken in one process on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds 1,2,... --control-seeds 1,2,3 [--faults altered,...] \\
        [--fault-seeds 1,2,3] --out <file.jsonl>

For each seed of ``--seeds`` the port runs the cell (a window of
``--seconds``) and the check's numbers are read (the lower readings);
for each of ``--control-seeds`` the reference, in the next precision
below the configuration's, runs in the port's place (the upper
readings); each fault of ``--faults`` is planted in the port's timed
path on each of ``--fault-seeds``.  One JSON line a run goes to
``--out``.  A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "portbench"))
    import torch

    import run as bench
    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    plan = [("program", None, s) for s in _seeds(args.seeds)]
    plan += [("control", None, s) for s in _seeds(args.control_seeds)]
    plan += [("program", f, s) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    with open(args.out, "a") as out:
        for system, fault, seed in plan:
            t0 = time.perf_counter()
            res = bench.run_cell(cell, seed, args.seconds, False, device,
                                 t0, system=system, fault=fault)
            row = dict(workload=args.workload, system=system, fault=fault,
                       seed=seed, correct=res["correct"],
                       attempted=res["attempted"],
                       readings=res["readings"], metrics=res["metrics"],
                       run_s=time.perf_counter() - t0)
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
