"""``BENCHMARK.json`` against the contract it is written to, and every
file it names."""

import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in m["workloads"]:
        assert reports(e2e[m["moves"]], cell)
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_enough_and_has_its_files(cell):
    w = CELLS[cell]
    assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert w["chips"] == 1
    e2e = [m for m in BENCH["end_to_end"] if reports(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(reports(m, cell) for m in BENCH["per_layer"])
    c = spec.load_cell(cell)
    assert c.limits and all(v > 0 for v in c.limits.values())
    spec.reference(c.config), spec.program(c.config)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry and collation", "training step", "model",
                      "kernels", "device"}


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        # each cut has its reason, and none is a width
        assert set(cfg.get("why_reduced", {})) == set(cfg["reduced"])
        for key in cfg["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank"))
            assert key not in ("hidden", "in_channels", "ratio")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_kernel_tables():
    for path in (spec.HERE / "kernels").glob("*.json"):
        table = spec.load_json(path)
        assert table["op"] == path.stem and table["kernels"]
