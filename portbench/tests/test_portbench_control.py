"""The check can fail: a run whose timed path is broken, or whose system
is the reference in the next lower precision, comes out not correct;
a sound run comes out correct.  Everything of a run but the look for a
card runs here, on the CPU, at a size a test run holds (the kernels'
plain versions and the port's CPU routes)."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import run
from portbench.harness import spec

HERE = Path(__file__).resolve().parents[1]
TINY = {
    "serve-large-graph": dict(nodes={"dist": "fixed", "value": 2048},
                              edges={"kind": "uniform_directed",
                                     "count": 20000}, check_requests=3),
    "train-large-graph": dict(nodes={"dist": "fixed", "value": 2048},
                              edges={"kind": "uniform_directed",
                                     "count": 20000}),
    "train-dense-batch": dict(graphs_per_request=16,
                              nodes={"dist": "fixed", "value": 64},
                              edges={"kind": "er_undirected", "p": 0.1}),
    "serve-small-graphs": dict(plan_requests=4, check_requests=4),
}
#: the faults each cell can have (a batch of one graph has no half)
FAULTS = {"serve-large-graph": ("altered", "stale"),
          "serve-small-graphs": ("altered", "stale", "half_batch"),
          "train-large-graph": ("altered", "state_unchanged"),
          "train-dense-batch": ("altered", "half_batch", "state_unchanged")}
SEED = 2 ** 31 + 77


def tiny(name):
    cell = spec.load_cell(name)
    cell.traffic.update(TINY[name])
    return cell


def once(name, **kw):
    return run.run_cell(tiny(name), SEED, 0.3, False, "cpu",
                        time.perf_counter(), **kw)


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    res = once(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and "setup_s" in res["metrics"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails(name):
    res = once(name, system="control")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_fault_fails(name, fault):
    res = once(name, fault=fault)
    assert not res["correct"], res["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "serve-large-graph", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "serve-large-graph", "--seed", "5", "--seconds", "2"],
        capture_output=True, text=True, timeout=1200, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
