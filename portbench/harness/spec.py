"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of
its own, and so does each metric's reader, each kernel table, each
reference and each program adapter.  Adding one of them is adding a file
and an entry: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

#: the benchmark's folder; the repository root is its parent
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path (names may hold ``-`` and
    ``.``, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace("-", "_").replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        table = self.per_layer if trace else self.end_to_end
        return [m for m in table
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reference(config: dict):
    """The configuration's plain reference (``reference/<name>.py``)."""
    name = config["reference"]
    return load_module(HERE / "reference" / f"{name}.py", "ref_" + name)


def program(config: dict):
    """The adapter that builds and drives the port's model
    (``programs/<name>.py``)."""
    name = config["program"]
    return load_module(HERE / "programs" / f"{name}.py", "prog_" + name)


def metric_reader(name: str):
    """A metric's reader (``metrics/<name>.py``): ``read(ctx)`` returns the
    value, or None where the run holds nothing to read."""
    return load_module(HERE / "metrics" / f"{name}.py", "metric_" + name)


def peaks() -> dict:
    return load_json(HERE / "peaks.json")
