"""The readers of the program's spans (``harness/spans.py``): on a
hand-built store, on an empty one, without the tracing module, and in a
traced run of each cell on the CPU at a test's size."""

import sys
import time

import pytest

import run
import tgp_tpu_torch
from portbench.harness import spec
from tgp_tpu_torch import tracing

from test_portbench_control import SEED, tiny

NEW = ["serve.pack_ms", "serve.csr_ms", "serve.h2d_ms", "serve.pad_share",
       "serve.forward_host_ms", "serve.d2h_wait_ms", "serve.k1_launches",
       "train.forward_host_ms"]
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
WHERE = {m["name"]: m["workloads"] for m in BENCH["per_layer"]}


def read(name):
    return spec.metric_reader(name).read({})


def rec(i, name, parent, request, start_ms, end_ms, **attrs):
    return dict(name=name, id=i, parent=parent, request=request,
                start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6),
                attrs=attrs)


def request(req, t0, pack, csr, h2d, fwd, d2h, k1, pad, copied):
    """One served request: its spans in the order the program opens them,
    ``csr`` None for a request collated without a CSR layout."""
    base = 10 * req
    out = [rec(base, "tgp.predict", None, req, t0, t0 + 100),
           rec(base + 1, "tgp.collate", base, req, t0, t0 + 50),
           rec(base + 2, "tgp.collate.pack", base + 1, req, t0, t0 + pack)]
    t = t0 + pack
    if csr is not None:
        out.append(rec(base + 3, "tgp.collate.csr", base + 1, req, t,
                       t + csr))
        t += csr
    out.append(rec(base + 4, "tgp.collate.h2d", base + 1, req, t, t + h2d,
                   bytes=copied, pad_bytes=pad))
    out.append(rec(base + 5, "tgp.model.forward", base, req, 60, 60 + fwd,
                   launches={"spmm_csr": k1} if k1 else {}))
    out.append(rec(base + 6, "tgp.predict.d2h", base, req, 90, 90 + d2h))
    return out


@pytest.fixture
def store(monkeypatch):
    """Hand the readers ``records`` in place of the program's store."""
    def put(records):
        monkeypatch.setattr(tracing, "spans", lambda: list(records))
    return put


def test_serving_readers_on_a_hand_built_store(store):
    store(request(1, 0, pack=4, csr=20, h2d=2, fwd=1.5, d2h=0.5, k1=3,
                  pad=10, copied=1000)
          + request(2, 200, pack=6, csr=30, h2d=3, fwd=2.5, d2h=1.5, k1=3,
                    pad=30, copied=1000)
          + request(3, 400, pack=5, csr=10, h2d=1, fwd=0.5, d2h=0.7, k1=2,
                    pad=20, copied=2000))
    assert read("serve.pack_ms") == pytest.approx(5)
    assert read("serve.csr_ms") == pytest.approx(20)
    assert read("serve.h2d_ms") == pytest.approx(2)
    assert read("serve.forward_host_ms") == pytest.approx(1.5)
    assert read("serve.d2h_wait_ms") == pytest.approx(0.7)
    assert read("serve.k1_launches") == 3
    assert read("serve.pad_share") == pytest.approx(100 * 60 / 4000)


def test_a_request_of_two_chunks_sums_them(store):
    one = request(1, 0, pack=4, csr=None, h2d=2, fwd=1, d2h=1, k1=0, pad=5,
                  copied=100)
    # the second chunk of the same request (the readers group by request)
    chunk = [dict(r, id=r["id"] + 100) for r in one[1:]]
    store(one + chunk)
    assert read("serve.pack_ms") == pytest.approx(8)
    assert read("serve.h2d_ms") == pytest.approx(4)
    assert read("serve.pad_share") == pytest.approx(5.0)
    assert read("serve.csr_ms") is None  # no request builds a CSR layout
    assert read("serve.k1_launches") == 0


def test_training_reader_is_the_mean_a_step(store):
    store([rec(1, "tgp.model.forward", None, 1, 0, 2.0),
           rec(2, "tgp.model.conv", 1, 1, 0, 1.0),
           rec(3, "tgp.model.forward", None, 2, 10, 13.0),
           rec(4, "tgp.model.forward", None, 3, 20, 21.0)])
    assert read("train.forward_host_ms") == pytest.approx(2.0)


def test_open_spans_are_left_out(store):
    store([rec(1, "tgp.model.forward", None, 1, 0, 2.0),
           dict(rec(2, "tgp.model.forward", None, 2, 10, 0), end_ns=None)])
    assert read("train.forward_host_ms") == pytest.approx(2.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, store, monkeypatch):
    tracing.reset()  # a --trace 0 run: the profiler never ran
    assert read(name) is None
    # a program without the tracing module (the parent of these readers)
    store(request(1, 0, pack=4, csr=20, h2d=2, fwd=1.5, d2h=0.5, k1=3,
                  pad=10, copied=1000))
    assert read(name) is not None
    monkeypatch.delattr(tgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tgp_tpu_torch.tracing", None)
    assert read(name) is None


@pytest.mark.parametrize("cell", sorted(w["name"]
                                        for w in BENCH["workloads"]))
def test_a_traced_run_reports_them_where_listed(cell):
    res = run.run_cell(tiny(cell), SEED, 0.3, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    got = {m for m in NEW if m in res["metrics"]}
    assert got == {m for m in NEW if cell in WHERE[m]}
    for m in got:
        assert res["metrics"][m]["value"] >= 0
