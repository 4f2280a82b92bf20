"""``tgp_tpu_torch.tracing``: spans at the layer boundaries of the serving
and model path, recorded only while a ``torch.profiler`` runs.

On the CPU the kernel wrappers run their plain versions and count no
launches, so the launch counters are driven by spies that count each
plain call as the card's wrapper counts its launch.
"""

import json

import numpy as np
import pytest
import torch

import cuda_graph_stub

from tgp_tpu_torch import (DenseTopkClassifier, HierarchicalClassifier,
                           PoolingClassifier, Predictor, from_graphs,
                           gcn_norm_dense, get_pooler, to_dense, tracing)
from tgp_tpu_torch import graph as G
from tgp_tpu_torch.ops.kernels import segment_spmm as K

torch.set_num_threads(1)
F_IN, HIDDEN = 8, 16
COLLATE = ["tgp.collate.pack", "tgp.collate.h2d", "tgp.collate.csr"]
MODEL = ["tgp.model.conv", "tgp.model.pool", "tgp.model.conv",
         "tgp.model.readout"]


def _graphs(seed, count=3, n_range=(40, 70)):
    """Loop-free random graphs, two edges a node."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        s, r = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
        keep = s != r
        out.append((rng.normal(size=(n, F_IN)).astype(np.float32),
                    np.stack([s[keep], r[keep]])))
    return out


def _sparse_model():
    g = torch.Generator().manual_seed(0)
    return PoolingClassifier(
        get_pooler("topk", in_channels=HIDDEN, ratio=0.5, pool_mode="masked",
                   device="cpu", generator=g),
        num_classes=3, hidden=HIDDEN, in_channels=F_IN, use_kernel=True,
        device="cpu", generator=g)


def _dense_model():
    return DenseTopkClassifier(num_classes=3, hidden=HIDDEN,
                               in_channels=F_IN, pre_normalized=True,
                               use_kernel=True, device="cpu",
                               generator=torch.Generator().manual_seed(0))


def _batch(kind):
    graphs = _graphs(5)
    if kind == "sparse":
        return from_graphs(graphs, sort_edges=True, device="cpu")
    return gcn_norm_dense(to_dense(from_graphs(graphs, device="cpu")))


MODELS = {"sparse": _sparse_model, "dense": _dense_model}


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_store():
    """Two profiled stretches with no span between them share a store."""
    tracing.reset()


@pytest.fixture
def counting(monkeypatch):
    """The K1/K2 and K4 wrappers count each plain call as a launch."""
    real, real_k4 = K._csr_sum, K._k4_sum

    def csr_sum(x, w, idx, row_ptr, num_rows, counter):
        counter.launches += 1
        return real(x, w, idx, row_ptr, num_rows, counter)

    def k4_sum(x, perm, keep, row_ptr, num_rows, route):
        K.sorted_segment_sum.launches += 1
        K.sorted_segment_sum.launches_by_route[route] += 1
        return real_k4(x, perm, keep, row_ptr, num_rows, route)

    monkeypatch.setattr(K, "_csr_sum", csr_sum)
    monkeypatch.setattr(K, "_k4_sum", k4_sum)


def _delta(before, after):
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def _predict(sort_edges, graphs=None):
    model = _sparse_model()
    serve = Predictor(lambda b: model(b)[0], batch_size=2,
                      sort_edges=sort_edges, device="cpu")
    serve(graphs or _graphs(1))
    return serve


def _step(model, batch):
    logits, _ = model(batch)
    logits.sum().backward()


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


@pytest.mark.parametrize("call", ["predict", "sparse", "dense"])
def test_off_records_nothing_and_counts_launches(call, counting):
    assert not torch._C._autograd._profiler_enabled()
    off = tracing.span("tgp.anything")
    assert off is tracing.span("tgp.other", count_launches=True)
    assert not off and off.__enter__() is off
    if call != "predict":
        model, batch = MODELS[call](), _batch(call)
    before = tracing.launches()
    if call == "predict":
        _predict(True)
    else:
        _step(model, batch)
    assert tracing.spans() == [] and tracing.dropped() == 0
    # the spies stand for the card's counters: K1 three times a sparse
    # forward (twice more in its backward), K4 once for the readout; a
    # request of three graphs is two forwards
    total, k1 = {"predict": (8, 6), "sparse": (6, 5), "dense": (0, 0)}[call]
    got = _delta(before, tracing.launches())
    assert sum(n for k, n in got.items() if isinstance(k, str)) == total
    assert got.get("spmm_csr", 0) == k1


@pytest.mark.parametrize("sort_edges", [True, False])
def test_predict_records_the_span_tree(sort_edges, counting):
    graphs = _graphs(2)
    before = tracing.launches()
    with _profiled():
        _predict(sort_edges, graphs)
    used = _delta(before, tracing.launches())
    recs = tracing.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "tgp.predict"
    assert root["attrs"] == dict(graphs=3, chunks=2)
    assert {r["request"] for r in recs} == {root["request"]}
    by_id = {r["id"]: r for r in recs}
    for r in recs:  # every child lies inside its parent
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    chunks = _children(recs, root)
    assert [r["name"] for r in chunks] == [
        "tgp.collate", "tgp.model.forward", "tgp.predict.d2h"] * 2
    collate = COLLATE if sort_edges else COLLATE[:2]
    for r in chunks:
        names = [c["name"] for c in _children(recs, r)]
        assert names == {"tgp.collate": collate, "tgp.model.forward": MODEL,
                         "tgp.predict.d2h": []}[r["name"]]
    assert all(r["attrs"] == {} for r in chunks[::3])
    # every launch of the request falls in its forwards; K1 only on the
    # CSR route
    forwards = [f["attrs"]["launches"] for f in chunks[1::3]]
    assert {k: sum(f.get(k, 0) for f in forwards) for k in used} == used
    assert sum(sum(f.values()) for f in forwards) == sum(used.values())
    assert [f.get("spmm_csr", 0) for f in forwards] == [3 * sort_edges] * 2


def test_chrome_trace_holds_one_annotation_a_record(tmp_path):
    with _profiled() as prof:
        _predict(True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    got, want = {}, {}
    for e in evs:
        if e.get("cat") == "cpu_op" and e["name"].startswith("tgp."):
            got[e["name"]] = got.get(e["name"], 0) + 1
    for r in tracing.spans():
        want[r["name"]] = want.get(r["name"], 0) + 1
    assert got == want and sum(want.values()) == 2 * (4 + 1 + 5) + 1


@pytest.mark.parametrize("sort_edges", [False, True])
def test_collate_counts_bytes_and_padding(sort_edges):
    """``bytes`` counts the real rows written for the card, none padding:
    ``x``'s rows, the ids, the weights only where a graph has them, and the
    ``B + 1`` node offsets; the padding is built on the batch's device.
    ``staged`` (page-locked staging) is False on the CPU."""
    graphs = _graphs(3, count=2)
    n = sum(g[0].shape[0] for g in graphs)
    e = sum(g[1].shape[1] for g in graphs)
    weighted = [graphs[0] + (np.ones(graphs[0][1].shape[1], np.float32),),
                graphs[1]]
    with _profiled():
        batch = from_graphs(graphs, pad_nodes=n + 9, pad_edges=e + 37,
                            sort_edges=sort_edges, device="cpu")
        from_graphs(weighted, pad_nodes=n + 9, pad_edges=e + 37,
                    sort_edges=sort_edges, device="cpu")
    recs = {}
    for r in tracing.spans():
        recs.setdefault(r["name"], []).append(r)
    assert batch.x.shape[0] == n + 9 and batch.senders.shape[0] == e + 37
    assert int(batch.node_mask.sum()) == n and int(batch.edge_mask.sum()) == e
    assert ("tgp.collate.csr" in recs) == sort_edges
    # the CSR layout is built after the copy, on the batch's device:
    # present with sort_edges, never copied
    layout = ("row_ptr", "senders_t", "receivers_t", "edge_weight_t",
              "row_ptr_t", "in_degree")
    assert all((getattr(batch, k) is not None) == sort_edges for k in layout)
    # x (F f32) a real node; senders, receivers (i32) a real edge, and the
    # weight (f32) where a graph has one; three i32 node offsets
    real = 4 * F_IN * n + 8 * e + 4 * 3
    got = [r["attrs"] for r in recs["tgp.collate.h2d"]]
    assert got == [dict(bytes=real, pad_bytes=0, staged=False),
                   dict(bytes=real + 4 * e, pad_bytes=0, staged=False)]
    if sort_edges:
        assert recs["tgp.collate.csr"][0]["attrs"] == dict(on_card=False,
                                                           edges=e + 37)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_logits_are_bit_identical_traced(kind):
    model, batch = MODELS[kind](), _batch(kind)
    off, _ = model(batch)
    with _profiled():
        on, _ = model(batch)
    assert tracing.spans() and torch.equal(off, on)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_training_forward_is_the_root(kind):
    model, batch = MODELS[kind](), _batch(kind)
    with _profiled():
        _step(model, batch)
        _step(model, batch)
    recs = tracing.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["tgp.model.forward"] * 2
    assert len({r["request"] for r in roots}) == 2
    for root in roots:  # backward and Adam add no span of the program
        assert [c["name"] for c in _children(recs, root)] == MODEL
    assert len(recs) == 2 * (1 + len(MODEL))


@pytest.mark.parametrize("mode", ["compact", "masked"])
def test_hierarchical_forward_records_each_level(mode):
    g = torch.Generator().manual_seed(0)
    pools = [get_pooler("sag", in_channels=HIDDEN, ratio=0.5, gnn_kind="gcn",
                        pool_mode=mode, device="cpu", generator=g)
             for _ in range(3)]
    model = HierarchicalClassifier(pools, num_classes=3, hidden=HIDDEN,
                                   in_channels=F_IN, head=(16, 8),
                                   device="cpu", generator=g)
    batch = _batch("sparse")
    model(batch)
    assert tracing.spans() == []  # the profiler off: nothing recorded
    with _profiled():
        model(batch)
    recs = tracing.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "tgp.model.forward" and "launches" in root["attrs"]
    top = _children(recs, root)
    assert [r["name"] for r in top] == [
        "tgp.model.conv", "tgp.model.pool", "tgp.model.readout"] * 3 + [
        "tgp.model.head"]
    # a compact level's pooled graph has B·Kmax slots, Kmax halving at each
    # level; a masked one keeps the batch's
    kmax, slots = batch.max_nodes, []
    for _ in range(3):
        kmax = -(-kmax // 2)
        slots.append(batch.num_graphs * kmax if mode == "compact"
                     else batch.num_nodes)
    assert [r["attrs"] for r in top[1::3]] == [
        dict(level=lvl, slots=s) for lvl, s in enumerate(slots)]
    assert [r["attrs"] for r in top[2::3]] == [dict(level=lvl)
                                               for lvl in range(3)]
    for pool in top[1::3]:
        assert [c["name"] for c in _children(recs, pool)] == [
            "tgp.model.pool.score", "tgp.model.pool.select"]
    assert all(r["request"] == root["request"] for r in recs)


def test_a_new_profiled_stretch_starts_a_fresh_store():
    model, batch = _sparse_model(), _batch("sparse")
    with _profiled():
        _step(model, batch)
    first = {r["id"] for r in tracing.spans()}
    _step(model, batch)  # the profiler off: kept until the next stretch
    assert {r["id"] for r in tracing.spans()} == first
    with _profiled():
        _step(model, batch)
    recs = tracing.spans()
    assert len(recs) == 1 + len(MODEL) and not first & {r["id"] for r in recs}


def test_the_cap_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 5)
    with _profiled():
        for i in range(8):
            with tracing.span(f"s{i}") as sp:
                sp.set(i=i)
    assert [r["name"] for r in tracing.spans()] == [f"s{i}"
                                                    for i in range(3, 8)]
    assert tracing.dropped() == 3
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("sort_edges", [True, False])
def test_a_replayed_request_dispatches_no_launch(sort_edges, counting,
                                                 monkeypatch):
    """A request served by a replayed graph (the stand-in of
    ``cuda_graph_stub``): the forward span says ``"replay"``, opens no
    child and counts no launch, because the replay calls no wrapper; the
    request's own spans are as an eager one's."""
    graphs = _graphs(2)
    model = _sparse_model()
    serve = Predictor(lambda b: model(b)[0], batch_size=2,
                      sort_edges=sort_edges, device="cpu")
    cuda_graph_stub.install(monkeypatch)
    with torch.inference_mode():
        serve(graphs)  # each chunk's signature eager, then captured
        serve(graphs)
        before = tracing.launches()
        with _profiled():
            serve(graphs)
    assert _delta(before, tracing.launches()) == {}
    recs = tracing.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    chunks = _children(recs, root)
    assert [r["name"] for r in chunks] == [
        "tgp.collate", "tgp.model.forward", "tgp.predict.d2h"] * 2
    collate = COLLATE if sort_edges else COLLATE[:2]
    for r in chunks[::3]:
        assert [c["name"] for c in _children(recs, r)] == collate
    for f in chunks[1::3]:
        assert f["attrs"] == {"graph": "replay", "launches": {}}
        assert _children(recs, f) == []


def test_forward_says_how_it_ran(counting, monkeypatch):
    """``graph`` on ``PoolingClassifier``'s forward span: ``"eager"``,
    ``"capture"``, then ``"replay"`` (with the stand-in graph of
    ``cuda_graph_stub``); the capture runs the forward's Python and counts
    its launches, a replay opens no child span and counts none.  The
    other models' forward spans carry no ``graph``."""
    model, batch = _sparse_model(), _batch("sparse")
    with torch.inference_mode(), _profiled():
        model(batch)  # the CPU: eager
        cuda_graph_stub.install(monkeypatch)
        for _ in range(4):
            model(batch)
    recs = tracing.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["attrs"]["graph"] for r in roots] == [
        "eager", "eager", "capture", "replay", "replay"]
    launches = [r["attrs"]["launches"] for r in roots]
    assert launches[0]["spmm_csr"] == 3
    assert launches[:3] == [launches[0]] * 3 and launches[3:] == [{}, {}]
    assert [[c["name"] for c in _children(recs, r)] for r in roots] == [
        MODEL, MODEL, MODEL, [], []]
    tracing.reset()
    with _profiled():
        for kind in ("dense", "hierarchical"):
            if kind == "dense":
                MODELS["dense"]()(_batch("dense"))
            else:
                g = torch.Generator().manual_seed(0)
                HierarchicalClassifier(
                    [get_pooler("topk", in_channels=HIDDEN, device="cpu",
                                generator=g)], num_classes=3, hidden=HIDDEN,
                    in_channels=F_IN, device="cpu", generator=g)(batch)
    assert [sorted(r["attrs"]) for r in tracing.spans()
            if r["name"] == "tgp.model.forward"] == [["launches"]] * 2
