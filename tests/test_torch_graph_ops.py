"""The port's graph container, segment ops, activations and sparse ops
against the JAX package on the same numpy inputs (f32, atol 1e-6 unless a
test says otherwise; integer outputs exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu.graph as jg
import tgp_tpu.ops.segment as jseg
import tgp_tpu.ops.sparse as jsp
from tgp_tpu.utils.activations import resolve_activation as j_act
import tgp_tpu_torch.graph as tg
import tgp_tpu_torch.ops.segment as tseg
import tgp_tpu_torch.ops.sparse as tsp
from tgp_tpu_torch.utils.activations import resolve_activation as t_act

torch.set_num_threads(1)


def _graphs(seed, nographs=3, self_loops=True, weighted=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nographs):
        n = int(rng.integers(5, 30))
        e = 3 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if not self_loops:
            keep = s != r
            s, r = s[keep], r[keep]
        x = rng.normal(size=(n, 4)).astype(np.float32)
        g = (x, np.stack([s, r]))
        if weighted:
            g = g + ((rng.random(s.shape[0]) - 0.3).astype(np.float32),)
        out.append(g)
    return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _eq(a, b, atol=1e-6):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=atol)


FIELDS = ("x", "senders", "receivers", "edge_weight", "node_graph",
          "node_pos", "node_mask", "edge_mask")
CSR_FIELDS = ("row_ptr", "senders_t", "receivers_t", "edge_weight_t",
              "row_ptr_t", "in_degree")


@pytest.mark.parametrize("sort_edges", [False, True])
@pytest.mark.parametrize("pad", [None, (160, 512)])
def test_from_graphs_matches_jax(sort_edges, pad):
    gs = _graphs(0)
    kw = dict(sort_edges=sort_edges)
    if pad:
        kw.update(pad_nodes=pad[0], pad_edges=pad[1], max_nodes=64)
    jb = jg.from_graphs(gs, **kw)
    tb = tg.from_graphs(gs, device="cpu", **kw)
    for f in FIELDS + (CSR_FIELDS if sort_edges else ()):
        a, b = getattr(tb, f), getattr(jb, f)
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype)), f
        _eq(a, b)
    if not sort_edges:
        assert tb.row_ptr is None and tb.in_degree is None
    assert (tb.num_graphs, tb.max_nodes, tb.edges_sorted) == (
        jb.num_graphs, jb.max_nodes, jb.edges_sorted)
    _eq(tb.nodes_per_graph(), jb.nodes_per_graph())
    _eq(tb.edges_per_graph(), jb.edges_per_graph())
    # has_self_loop marks exactly the nodes with a valid (i, i) edge
    s, r, m = _np(jb.senders), _np(jb.receivers), _np(jb.edge_mask)
    want = np.zeros(tb.num_nodes, bool)
    want[s[m & (s == r)]] = True
    _eq(tb.has_self_loop, want)


def test_from_graphs_rejects_bad_input():
    x = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError, match="edge ids"):
        tg.from_graphs([(x, np.array([[0, 3], [1, 1]]))], device="cpu")
    with pytest.raises(ValueError, match="at least one graph"):
        tg.from_graphs([], device="cpu")
    with pytest.raises(ValueError, match="budget"):
        tg.from_graphs([(x, np.array([[0], [1]]))], pad_nodes=2,
                       device="cpu")


def test_dense_roundtrip_matches_jax():
    gs = _graphs(1)
    jb = jg.from_graphs(gs)
    tb = tg.from_graphs(gs, device="cpu")
    jd, td = jg.to_dense(jb), tg.to_dense(tb)
    for f in ("x", "adj", "mask"):
        _eq(getattr(td, f), getattr(jd, f), atol=1e-5)
    for keep in (True, False):
        js = jg.from_dense(jd, keep_self_loops=keep)
        ts = tg.from_dense(td, keep_self_loops=keep)
        for f in FIELDS:
            _eq(getattr(ts, f), getattr(js, f), atol=1e-5)
    moved = tb.to("cpu")
    assert moved.x.device.type == "cpu" and moved.num_graphs == tb.num_graphs


def _seg_case(seed=0, n=40, segs=7, feat=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segs - 2, n).astype(np.int32)  # 2 empty segments
    data = rng.normal(size=(n, feat)).astype(np.float32)
    mask = rng.random(n) > 0.3
    return ids, data, mask, segs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_segment_reductions_match_jax(name, masked):
    ids, data, mask, segs = _seg_case()
    m = mask if masked else None
    ref = getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), segs,
                              mask=None if m is None else jnp.asarray(m))
    got = getattr(tseg, name)(torch.tensor(data), torch.tensor(ids), segs,
                              mask=None if m is None else torch.tensor(m))
    _eq(got, ref, atol=1e-5)  # includes the ±inf fills of empty segments


@pytest.mark.parametrize("name", ["segment_max", "segment_min", "segment_sum"])
def test_segment_int_reductions_and_out_of_range_ids(name):
    ids = np.array([0, 0, 2, 9, -1, 2], np.int32)  # 9 and -1 are dropped
    data = np.array([5, -3, 7, 100, 100, 1], np.int32)
    ref = getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 4)
    got = getattr(tseg, name)(torch.tensor(data), torch.tensor(ids), 4)
    _eq(got, ref)


def test_segment_count_softmax_normalize_match_jax():
    ids, data, mask, segs = _seg_case(1)
    jid, tid = jnp.asarray(ids), torch.tensor(ids)
    jm, tm = jnp.asarray(mask), torch.tensor(mask)
    _eq(tseg.segment_count(tid, segs, mask=tm),
        jseg.segment_count(jid, segs, mask=jm))
    sc = data[:, 0]
    _eq(tseg.segment_softmax(torch.tensor(sc), tid, segs, mask=tm),
        jseg.segment_softmax(jnp.asarray(sc), jid, segs, mask=jm))
    for ord_ in ("max_abs", "sum"):
        _eq(tseg.segment_normalize(torch.tensor(sc), tid, segs, mask=tm,
                                   ord=ord_),
            jseg.segment_normalize(jnp.asarray(sc), jid, segs, mask=jm,
                                   ord=ord_), atol=1e-5)
    with pytest.raises(ValueError):
        tseg.segment_normalize(torch.tensor(sc), tid, segs, ord="l2")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_topk_rank_ties_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, segs = 60, 5
    ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    scores = rng.integers(0, 4, n).astype(np.float32)  # many ties
    mask = rng.random(n) > 0.2
    ref = jseg.segment_topk_rank(jnp.asarray(scores), jnp.asarray(ids), segs,
                                 mask=jnp.asarray(mask))
    got = tseg.segment_topk_rank(torch.tensor(scores), torch.tensor(ids),
                                 segs, mask=torch.tensor(mask))
    _eq(got, ref)
    # unsorted ids, no mask
    ids2 = rng.integers(0, segs, n).astype(np.int32)
    _eq(tseg.segment_topk_rank(torch.tensor(scores), torch.tensor(ids2), segs),
        jseg.segment_topk_rank(jnp.asarray(scores), jnp.asarray(ids2), segs))


@pytest.mark.parametrize("name", ["tanh", "sigmoid", "relu", "elu", "gelu",
                                  "softplus", "leaky_relu", "identity",
                                  "linear", "none"])
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 33).astype(np.float32)
    _eq(t_act(name)(torch.tensor(x)), j_act(name)(jnp.asarray(x)), atol=1e-5)


def test_activation_resolver_edges():
    x = torch.arange(3.0)
    assert torch.equal(t_act(None)(x), x)
    assert t_act(torch.sin) is torch.sin
    with pytest.raises(ValueError, match="unknown activation"):
        t_act("swishy")


def _edges(seed=0, n=20, e=80):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    s[:5], r[:5] = s[5:10], r[5:10]  # duplicates for coalesce
    w = (rng.random(e) - 0.2).astype(np.float32)
    m = rng.random(e) > 0.15
    nm = np.ones(n, bool)
    nm[-3:] = False
    return s, r, w, m, nm, n


def _both(*arrs):
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_coalesce_matches_jax(reduce):
    """The merged edges equal JAX's as a set (the port lays them out
    receiver-major, JAX sender-major), same edge budget, each masked slot
    of weight 0."""
    s, r, w, m, _, n = _edges(1)
    (js, jr, jw, jm), (ts, tr, tw, tm) = _both(s, r, w, m)
    got = [_np(a) for a in tsp.coalesce(ts, tr, tw, tm, n, reduce=reduce)]
    want = [_np(a) for a in jsp.coalesce(js, jr, jw, jm, n, reduce=reduce)]
    assert [a.shape for a in got] == [a.shape for a in want]
    (gs, gr, gw, gm), (ws, wr, ww, wm) = got, want
    go, wo = np.lexsort((gs[gm], gr[gm])), np.lexsort((ws[wm], wr[wm]))
    np.testing.assert_array_equal(gs[gm][go], ws[wm][wo])
    np.testing.assert_array_equal(gr[gm][go], wr[wm][wo])
    np.testing.assert_allclose(gw[gm][go], ww[wm][wo], atol=1e-6)
    assert not gw[~gm].any()


def test_self_loop_helpers_and_norm_match_jax():
    s, r, w, m, nm, n = _edges(2)
    s[10], r[10], m[10] = 4, 4, True  # an existing loop keeps its weight
    (js, jr, jw, jm, jnm), (ts, tr, tw, tm, tnm) = _both(s, r, w, m, nm)
    for a, b in zip(tsp.add_remaining_self_loops(ts, tr, tw, tm, tnm, 2.0),
                    jsp.add_remaining_self_loops(js, jr, jw, jm, jnm, 2.0)):
        _eq(a, b)
    for a, b in zip(tsp.remove_self_loops(ts, tr, tw, tm),
                    jsp.remove_self_loops(js, jr, jw, jm)):
        _eq(a, b)
    _eq(tsp.normalize_adj_sym(ts, tr, tw, tm, n),
        jsp.normalize_adj_sym(js, jr, jw, jm, n))
    _eq(tsp.weighted_degree(tr, tw, n, mask=tm),
        jsp.weighted_degree(jr, jw, n, mask=jm))
    _eq(tsp.weighted_degree(tr, None, n), jsp.weighted_degree(jr, None, n))
    _eq(tsp.check_and_filter_edge_weights(tw[:, None]), tw)
    with pytest.raises(ValueError, match="Edge weights"):
        tsp.check_and_filter_edge_weights(torch.zeros(3, 2))


@pytest.mark.parametrize("flags", [
    dict(), dict(degree_norm=True), dict(edge_weight_norm=True),
    dict(remove_self_loops_flag=False, prune_eps=0.3),
])
def test_postprocess_adj_sparse_matches_jax(flags):
    s, r, w, m, _, n = _edges(3)
    ng = (np.arange(n) // 7).astype(np.int32)
    (js, jr, jw, jm, jng), (ts, tr, tw, tm, tng) = _both(s, r, w, m, ng)
    for a, b in zip(tsp.postprocess_adj_sparse(ts, tr, tw, tm, tng, n, 3,
                                               **flags),
                    jsp.postprocess_adj_sparse(js, jr, jw, jm, jng, n, 3,
                                               **flags)):
        _eq(a, b, atol=1e-5)


@pytest.mark.parametrize("flags", [
    dict(), dict(degree_norm=True), dict(degree_norm=True, adj_transpose=True),
    dict(edge_weight_norm=True),
])
def test_postprocess_adj_dense_matches_jax(flags):
    rng = np.random.default_rng(4)
    adj = rng.random((2, 6, 6)).astype(np.float32)
    mask = rng.random((2, 6)) > 0.3
    _eq(tsp.postprocess_adj_dense(torch.tensor(adj), torch.tensor(mask),
                                  **flags),
        jsp.postprocess_adj_dense(jnp.asarray(adj), jnp.asarray(mask),
                                  **flags), atol=1e-5)


def test_spmm_paths_match_jax():
    s, r, w, m, _, n = _edges(5)
    order = np.argsort(r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    x = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    (js, jr, jw, jx), (ts, tr, tw, tx) = _both(s, r, w, x)
    ref = jsp.spmm(js, jr, jw, jx, n)
    for method in ("auto", "torch", "kernel"):
        _eq(tsp.spmm(ts, tr, tw, tx, n, indices_are_sorted=True,
                     method=method), ref, atol=1e-5)
    with pytest.raises(ValueError, match="indices_are_sorted"):
        tsp.spmm(ts, tr, tw, tx, n, method="kernel")
    with pytest.raises(ValueError, match="unknown spmm method"):
        tsp.spmm(ts, tr, tw, tx, n, method="xla")


@pytest.mark.parametrize("variant", ["csr", "no_aux", "masked", "abs"])
def test_spmm_batch_matches_jax(variant):
    gs = _graphs(6, self_loops=False)
    jb = jg.from_graphs(gs, sort_edges=True)
    tb = tg.from_graphs(gs, sort_edges=True, device="cpu")
    x = np.random.default_rng(1).normal(size=(tb.num_nodes, 3)).astype(
        np.float32)
    if variant == "no_aux":
        jb = jb.replace(row_ptr=None, senders_t=None, in_degree=None)
        tb = tb.replace(row_ptr=None, senders_t=None, in_degree=None)
    if variant == "masked":
        nm = _np(tb.node_mask) & (np.arange(tb.num_nodes) % 2 == 0)
        jb = jb.replace(node_mask=jnp.asarray(nm), node_mask_shrunk=True)
        tb = tb.replace(node_mask=torch.tensor(nm), node_mask_shrunk=True)
    kw = dict(abs_weights=variant == "abs")
    got = tsp.spmm_batch(tb, torch.tensor(x), **kw)
    ref = jsp.spmm_batch(jb, jnp.asarray(x), **kw)
    keep = _np(tb.node_mask)  # receiver rows of dropped nodes are unmasked
    _eq(_np(got)[keep], np.asarray(ref)[keep], atol=1e-5)


def test_regime_maps_on_cpu():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert not tsp.use_kernel_spmm(1 << 20, True, cpu)
    assert not tsp.use_kernel_spmm(1 << 20, True, meta)
    assert tsp.PALLAS_MIN_EDGES == jsp.PALLAS_MIN_EDGES
    for args in [(64, 256), (1, 4096), (10_000, 2048)]:
        assert tsp.use_dense_pipeline(*args) == jsp.use_dense_pipeline(*args)
