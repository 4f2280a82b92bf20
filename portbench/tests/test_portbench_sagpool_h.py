"""The cells ``train-dd-batch-sagpool`` (SAGPool_h) and ``serve-arxiv-size``:
their traffic mixes through the generator's tests, the program's
parameter map, a sound run, the control and each planted fault on the
CPU at a test's size, and the two readers of the pooling spans."""

import math
import sys
import time

import pytest

import run
import test_portbench_control as control
import test_portbench_traffic as traffic
import tgp_tpu_torch
from portbench.harness import gen, spec
from tgp_tpu_torch import tracing

#: the new cells at a test's size; the traced-run test of
#: ``test_portbench_spans`` sizes every cell of ``BENCHMARK.json`` by
#: ``test_portbench_control.TINY``, so they are entered there too
TINY = {"train-dd-batch-sagpool": dict(graphs_per_request=12),
        "serve-arxiv-size": dict(nodes={"dist": "fixed", "value": 2048},
                                 edges={"kind": "uniform_directed",
                                        "count": 20000}, check_requests=3)}
control.TINY.update(TINY)
FAULTS = {"train-dd-batch-sagpool": ("altered", "half_batch",
                                     "state_unchanged"),
          "serve-arxiv-size": ("altered", "stale")}
MIXES = {"dd-batch-128": dict(graphs_per_request=8),
         "arxiv-size-requests": dict(nodes={"dist": "fixed", "value": 512},
                                     edges={"kind": "uniform_directed",
                                            "count": 4000})}
SAG = "sagpool-h-gcn-h128"


@pytest.fixture(autouse=True)
def small_mixes(monkeypatch):
    for name, small in MIXES.items():
        monkeypatch.setitem(traffic.SMALL, name, small)


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("seed", traffic.SEEDS)
def test_same_seed_same_graphs(name, seed):
    traffic.test_same_seed_same_graphs(name, seed)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_other_index_other_graphs_and_shapes(name):
    traffic.test_other_index_other_graphs(name)
    traffic.test_shapes_as_the_mix_states(name)


def test_the_batch_has_the_same_sizes_on_every_seed():
    """One pool of 128 sizes: every seed trains on the same graphs' sizes
    (36,589 nodes, 184,186 edges, the largest 1,024 nodes)."""
    tr = spec.load_json(spec.HERE / "traffic" / "dd-batch-128.json")
    for seed in traffic.SEEDS:
        ns = gen.node_counts(tr, seed, 0)
        assert (len(ns), sum(ns), max(ns)) == (128, 36589, 1024)
        assert sum(gen.edge_count(tr, n) for n in ns) == 184186
    kept = [sum(math.ceil(n / 2 ** lvl) for n in ns) for lvl in (1, 2, 3)]
    assert kept == [18328, 9198, 4632]


def test_arxiv_mix_is_the_readme_example():
    tr = spec.load_json(spec.HERE / "traffic" / "arxiv-size-requests.json")
    assert tr["nodes"] == {"dist": "fixed", "value": 169343}
    assert tr["edges"] == {"kind": "uniform_directed", "count": 1166243}
    assert (tr["features"], tr["batch_size"], tr["sort_edges"]) == (128, 1,
                                                                    True)


def test_the_program_maps_every_parameter():
    cfg = spec.load_json(spec.HERE / "configs" / f"{SAG}.json")
    ref, prog = spec.reference(cfg), spec.program(cfg)
    model = prog.build(cfg, "cpu")
    shapes = ref.param_shapes(cfg)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(got) == set(prog.PARAMS)
    assert sorted(prog.PARAMS.values()) == sorted(shapes)
    assert all(got[n] == tuple(shapes[prog.PARAMS[n]][0]) for n in got)
    assert sum(math.prod(s) for s in got.values()) == 91205


def _once(name, **kw):
    cell = spec.load_cell(name)
    cell.traffic.update(TINY[name])
    return run.run_cell(cell, control.SEED, 0.3, False, "cpu",
                        time.perf_counter(), **kw)


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    res = _once(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and "setup_s" in res["metrics"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails(name):
    res = _once(name, system="control")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_fault_fails(name, fault):
    res = _once(name, fault=fault)
    assert not res["correct"], res["checks"]


def test_the_traced_run_reads_the_pooled_slots():
    """Three levels a step: B·Kmax compact slots, Kmax halving from the
    largest graph's half."""
    cell = spec.load_cell("train-dd-batch-sagpool")
    cell.traffic.update(TINY["train-dd-batch-sagpool"])
    res = run.run_cell(cell, control.SEED, 0.3, True, "cpu",
                       time.perf_counter())
    ns = gen.node_counts(cell.traffic, control.SEED, 0)
    kmax, want = max(ns), 0
    for _ in range(3):
        kmax = -(-kmax // 2)
        want += len(ns) * kmax
    assert res["metrics"]["train.pooled_slots"]["value"] == want
    assert res["metrics"]["train.pool_host_ms"]["value"] > 0


def rec(i, name, parent, request, start_ms, end_ms, **attrs):
    return dict(name=name, id=i, parent=parent, request=request,
                start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6),
                attrs=attrs)


def step(req, t0, pools):
    """One traced step: its forward and a pool span of each ``(ms,
    slots)``."""
    out = [rec(10 * req, "tgp.model.forward", None, req, t0, t0 + 50)]
    for j, (ms, slots) in enumerate(pools):
        out.append(rec(10 * req + j + 1, "tgp.model.pool", 10 * req, req,
                       t0 + j, t0 + j + ms, level=j, slots=slots))
    return out


def test_pool_readers_on_a_hand_built_store(monkeypatch):
    recs = (step(1, 0, [(2.0, 64), (1.0, 32), (1.0, 16)])
            + step(2, 100, [(4.0, 64), (2.0, 32), (2.0, 16)]))
    monkeypatch.setattr(tracing, "spans", lambda: list(recs))
    read = {m: spec.metric_reader(m).read({})
            for m in ("train.pool_host_ms", "train.pooled_slots")}
    assert read["train.pool_host_ms"] == pytest.approx(6.0)
    assert read["train.pooled_slots"] == 112
    # a pool span without ``slots`` (the one-level classifier's) is no slot
    recs[:] = [dict(r, attrs={}) for r in recs]
    assert spec.metric_reader("train.pooled_slots").read({}) is None


@pytest.mark.parametrize("name", ["train.pool_host_ms", "train.pooled_slots"])
def test_nothing_recorded_reads_nothing(name, monkeypatch):
    tracing.reset()
    assert spec.metric_reader(name).read({}) is None
    monkeypatch.setattr(tracing, "spans",
                        lambda: step(1, 0, [(1.0, 8)]))
    assert spec.metric_reader(name).read({}) is not None
    monkeypatch.delattr(tgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tgp_tpu_torch.tracing", None)
    assert spec.metric_reader(name).read({}) is None


def test_the_configuration_keeps_the_published_widths():
    """nhid 128, ratio 0.5, 3 blocks, a GCN scorer, the tanh gate, max‖mean
    readouts summed and the 256-128-64 head of the authors' code; only
    dropout and weight decay are cut."""
    cfg = spec.load_json(spec.HERE / "configs" / f"{SAG}.json")
    assert cfg["reduced"] == ["dropout", "weight_decay"]
    assert (cfg["in_channels"], cfg["hidden"], cfg["ratio"],
            cfg["num_blocks"], cfg["gnn_kind"], cfg["nonlinearity"],
            cfg["readout"], cfg["head"]) == (128, 128, 0.5, 3, "gcn", "tanh",
                                             "max_mean", [128, 64])
