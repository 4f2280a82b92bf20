"""The port's GCNConv, TopkSelect/TopkPooling (masked and compact),
get_pooler and global_reduce against the JAX package, with the same
weights and numpy inputs (f32, atol 2e-5 unless a test says otherwise).

Self-loops: the port holds every GCN branch to ``gcn_norm``'s
``add_remaining_self_loops`` semantics.  On loop-free graphs that equals
the JAX CSR branch; on graphs with loops it equals the JAX generic branch
(``use_pallas=False``), which the JAX CSR branch does not (it adds a unit
loop on top of an existing one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu_torch.ops.sparse as tsp
import tgp_tpu_torch.poolers._masked as t_masked
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.mp.gcn import GCNConv as JGCN
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.reduce.global_reduce import global_reduce as j_readout
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.mp.gcn import GCNConv as TGCN
from tgp_tpu_torch.poolers import get_pooler as t_get
from tgp_tpu_torch.poolers import pooler_map
from tgp_tpu_torch.reduce.global_reduce import global_reduce as t_readout

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _graphs(seed, feat=8, nographs=3, self_loops=False):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(nographs):
        n = int(rng.integers(10, 40))
        e = 3 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if self_loops:
            loops = rng.choice(n, n // 3, replace=False)
            s = np.concatenate([s, loops])
            r = np.concatenate([r, loops])
        else:
            keep = s != r
            s, r = s[keep], r[keep]
        x = rng.normal(size=(n, feat)).astype(np.float32)
        w = rng.random(s.shape[0]).astype(np.float32) + 0.1
        graphs.append((x, np.stack([s, r]), w))
    return graphs


def _batches(graphs, shrink=False, **kw):
    jb = j_from(graphs, sort_edges=True, **kw)
    tb = t_from(graphs, sort_edges=True, device="cpu", **kw)
    if shrink:  # a masked pooled graph: node_mask below the edges' ends
        nm = np.asarray(jb.node_mask) & (np.arange(jb.num_nodes) % 3 != 0)
        jb = jb.replace(node_mask=jnp.asarray(nm), in_degree=None,
                        node_mask_shrunk=True,
                        x=jnp.where(jnp.asarray(nm)[:, None], jb.x, 0.0))
        tb = tb.replace(node_mask=torch.tensor(nm), in_degree=None,
                        node_mask_shrunk=True,
                        x=torch.where(torch.tensor(nm)[:, None], tb.x, 0.0))
    return jb, tb


def _conv_pair(jb, out=8, **kw):
    jconv = JGCN(out, use_pallas=kw.pop("jax_pallas"))
    p = jconv.init(jax.random.key(0), jb, jb.x)
    p = jax.tree.map(lambda a: a + 0.1, p)  # nonzero bias
    tconv = TGCN(jb.num_features, out, device="cpu", **kw)
    tconv.lin.weight.data = torch.tensor(
        np.asarray(p["params"]["Dense_0"]["kernel"]).T.copy())
    tconv.bias.data = torch.tensor(np.asarray(p["params"]["bias"]))
    return jconv, p, tconv


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("shrink", [False, True])
def test_gcn_csr_matches_jax_csr_on_loop_free_graphs(shrink):
    jb, tb = _batches(_graphs(3), shrink)
    jconv, p, tconv = _conv_pair(jb, jax_pallas=True, use_kernel=True)
    np.testing.assert_allclose(_np(tconv(tb)), _np(jconv.apply(p, jb, jb.x)),
                               atol=2e-5)


@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("branch", ["csr", "sorted", "generic"])
@pytest.mark.parametrize("self_loops", [False, True])
def test_gcn_branches_match_gcn_norm(branch, self_loops, shrink):
    """Every port branch equals the JAX ``gcn_norm`` path, loops or not."""
    jb, tb = _batches(_graphs(4, self_loops=self_loops), shrink)
    if branch == "sorted":
        tb = tb.replace(row_ptr=None, in_degree=None)
    if branch != "generic" and self_loops:
        assert bool(tb.has_self_loop.any())
    jconv, p, tconv = _conv_pair(jb, jax_pallas=False,
                                 use_kernel=branch != "generic")
    np.testing.assert_allclose(_np(tconv(tb)), _np(jconv.apply(p, jb, jb.x)),
                               atol=2e-5)


@pytest.mark.parametrize("add_self_loops", [False, True])
def test_gcn_sorted_branch_matches_jax_sorted_branch(add_self_loops,
                                                     monkeypatch):
    """The sorted branch (no CSR offsets) against the JAX package's Pallas
    sorted branch (interpret mode) on loop-free graphs with positive
    weights: the degree and the messages both go through K2's fixed-order
    sum (``segment_sum_sorted``), never ``segment_sum``'s ``index_add_``."""
    import tgp_tpu_torch.mp.gcn as t_gcn

    def no_scatter(*a, **kw):
        raise AssertionError("the sorted branch took segment_sum")

    jb, tb = _batches(_graphs(7))
    jb = jb.replace(row_ptr=None, senders_t=None, in_degree=None)
    tb = tb.replace(row_ptr=None, in_degree=None)
    jconv = JGCN(8, use_pallas=True, add_self_loops=add_self_loops)
    p = jconv.init(jax.random.key(2), jb, jb.x)
    p = jax.tree.map(lambda a: a + 0.1, p)
    tconv = TGCN(jb.num_features, 8, device="cpu", use_kernel=True,
                 add_self_loops=add_self_loops)
    tconv.lin.weight.data = torch.tensor(
        np.asarray(p["params"]["Dense_0"]["kernel"]).T.copy())
    tconv.bias.data = torch.tensor(np.asarray(p["params"]["bias"]))
    monkeypatch.setattr(t_gcn, "segment_sum", no_scatter)
    np.testing.assert_allclose(_np(tconv(tb)), _np(jconv.apply(p, jb, jb.x)),
                               atol=2e-5)


def test_gcn_csr_without_self_loop_flag_computes_it():
    jb, tb = _batches(_graphs(5, self_loops=True))
    jconv, p, tconv = _conv_pair(jb, jax_pallas=False, use_kernel=True)
    tb = tb.replace(has_self_loop=None)
    np.testing.assert_allclose(_np(tconv(tb)), _np(jconv.apply(p, jb, jb.x)),
                               atol=2e-5)


@pytest.mark.parametrize("add_self_loops", [False, True])
def test_gcn_bf16_csr_matches_jax(add_self_loops):
    """bf16 compute: the same casts as flax's ``Dense(dtype=bf16)`` and the
    f32 bias promotion; 2e-2 relative to the output scale (bf16 rounding of
    h and of the SpMM result, and of w inside the Pallas kernel)."""
    jb, tb = _batches(_graphs(6))
    jconv = JGCN(8, use_pallas=True, dtype=jnp.bfloat16,
                 add_self_loops=add_self_loops)
    p = jconv.init(jax.random.key(1), jb, jb.x)
    tconv = TGCN(jb.num_features, 8, device="cpu", use_kernel=True,
                 dtype=torch.bfloat16, add_self_loops=add_self_loops)
    tconv.lin.weight.data = torch.tensor(
        np.asarray(p["params"]["Dense_0"]["kernel"]).T.copy())
    ref = jconv.apply(p, jb, jb.x)
    got = tconv(tb)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    scale = np.abs(_np(ref)).max()
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-2 * scale)


def _pool_pair(jb, tb, **kw):
    jp = j_get("topk", **kw)
    params = jp.init(jax.random.key(0), jb)
    tp = t_get("topk", device="cpu", **kw)
    tp.selector.weight.data = torch.tensor(
        np.asarray(params["params"]["selector"]["weight"]))
    return jp.apply(params, jb), tp(tb), (jp, params, tp)


def _assert_graphs_equal(tg_, jg_, atol=1e-5):
    for f in ("x", "edge_weight"):
        np.testing.assert_allclose(_np(getattr(tg_, f)),
                                   _np(getattr(jg_, f)), atol=atol)
    for f in ("senders", "receivers", "node_mask", "edge_mask", "node_graph",
              "node_pos"):
        np.testing.assert_array_equal(getattr(tg_, f).numpy(),
                                      np.asarray(getattr(jg_, f)))
    assert tg_.num_graphs == jg_.num_graphs
    assert tg_.max_nodes == jg_.max_nodes
    assert tg_.node_mask_shrunk == jg_.node_mask_shrunk


@pytest.mark.parametrize("kw", [
    dict(ratio=0.5), dict(ratio=0.25, multiplier=2.0), dict(ratio=3),
    dict(ratio=0.5, min_score=0.02), dict(ratio=0.5, act="sigmoid"),
    dict(ratio=0.5, remove_self_loops=False),
])
@pytest.mark.parametrize("mode", ["masked", "compact"])
def test_topk_pooling_matches_jax(mode, kw):
    jb, tb = _batches(_graphs(7, self_loops=True))
    jo, to, (jp, params, tp) = _pool_pair(jb, tb, in_channels=8,
                                          pool_mode=mode, **kw)
    for f in ("cluster_index", "node_sel_mask", "cluster_graph",
              "cluster_pos"):
        np.testing.assert_array_equal(getattr(to.so, f).numpy(),
                                      np.asarray(getattr(jo.so, f)))
    np.testing.assert_allclose(_np(to.so.weight), _np(jo.so.weight),
                               atol=1e-6)
    assert to.so.num_clusters == jo.so.num_clusters
    assert to.so.extras.get("pool_mode") == jo.so.extras.get("pool_mode")
    _assert_graphs_equal(to.graph, jo.graph)
    np.testing.assert_array_equal(to.so.out_mask().numpy(),
                                  np.asarray(jo.so.out_mask()))
    # lift back to the node space
    lj = jp.apply(params, jb, so=jo.so, lifting=True, x=jo.graph.x)
    lt = tp(tb, so=to.so, lifting=True, x=to.graph.x)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-5)
    if mode == "masked":  # loops are gone from the pooled graph
        assert not to.graph.has_self_loop.any() or not kw.get(
            "remove_self_loops", True)


@pytest.mark.parametrize("lift_op", ["transpose", "inverse"])
def test_compact_lift_ops_match_jax(lift_op):
    jb, tb = _batches(_graphs(8))
    jo, to, (jp, params, tp) = _pool_pair(jb, tb, in_channels=8,
                                          pool_mode="compact", lift=lift_op)
    assert tp.lift_op == lift_op
    lj = jp.apply(params, jb, so=jo.so, lifting=True, x=jo.graph.x)
    lt = tp(tb, so=to.so, lifting=True, x=to.graph.x)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-5)


def test_masked_and_compact_pool_agree_through_the_post_conv():
    """Masked pooling is the compact pooled graph, kept in node space: the
    post-pool GCN gives the same per-node rows and the same readout."""
    _, tb = _batches(_graphs(9))
    conv = TGCN(8, 8, device="cpu", use_kernel=True)
    outs = {}
    for mode in ("masked", "compact"):
        pool = t_get("topk", in_channels=8, ratio=0.5, pool_mode=mode,
                     device="cpu", generator=torch.Generator().manual_seed(0))
        o = pool(tb)
        h = conv(o.graph)
        outs[mode] = t_readout(h, node_graph=o.graph.node_graph,
                               num_graphs=o.graph.num_graphs,
                               node_mask=o.graph.node_mask)
    np.testing.assert_allclose(_np(outs["masked"]), _np(outs["compact"]),
                               atol=1e-5)


def test_auto_pool_mode(monkeypatch):
    _, tb = _batches(_graphs(10))
    pool = t_get("topk", in_channels=8, device="cpu")
    assert pool(tb).so.extras.get("pool_mode") is None  # CPU: compact
    # in the kernel regime auto takes masked, unless the masked path would
    # compute something else: a non-transpose lift or a normalized adjacency
    monkeypatch.setattr(tsp, "use_kernel_spmm", lambda *a: True)
    assert pool(tb).so.extras.get("pool_mode") == "masked"
    for kw in (dict(s_inv_op="inverse"), dict(degree_norm=True),
               dict(edge_weight_norm=True)):
        p2 = t_get("topk", in_channels=8, device="cpu", **kw)
        assert p2(tb).so.extras.get("pool_mode") is None, kw
    with pytest.raises(ValueError, match="pool_mode"):
        t_get("topk", in_channels=8, device="cpu", pool_mode="bogus")(tb)
    o = t_get("topk", in_channels=8, device="cpu", pool_mode="masked",
              s_inv_op="inverse")(tb)
    with pytest.raises(NotImplementedError):
        t_masked.masked_lift(o.graph.x, o.so, "inverse")


def test_get_pooler_factory():
    assert set(pooler_map()) == {"topk", "sag", "asap", "pan", "ec",
                                 "graclus", "kmis", "nopool", "lap",
                                 "mincut", "diff", "dmon", "hosc", "jb",
                                 "acc", "bnpool", "maxcut", "ndp", "nmf",
                                 "sep", "eigen"}
    p = t_get("topk_u", in_channels=8, ratio=0.3, nonlinearity="relu",
              not_an_arg=1, device="cpu")
    assert p.ratio == 0.3 and p.selector.act == "relu"
    with pytest.raises(ValueError, match="unknown pooler"):
        t_get("bogus", device="cpu")
    g = torch.Generator().manual_seed(3)
    a = t_get("topk", in_channels=8, device="cpu", generator=g)
    b = t_get("topk", in_channels=8, device="cpu",
              generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.selector.weight, b.selector.weight)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_global_reduce_matches_jax(op):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    ng = np.sort(rng.integers(0, 3, 20)).astype(np.int32)
    nm = rng.random(20) > 0.3
    nm[ng == 2] = False  # an empty graph
    ref = j_readout(jnp.asarray(x), node_graph=jnp.asarray(ng), num_graphs=4,
                    node_mask=jnp.asarray(nm), op=op)
    got = t_readout(torch.tensor(x), node_graph=torch.tensor(ng),
                    num_graphs=4, node_mask=torch.tensor(nm), op=op)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)
    xd = x.reshape(4, 5, 4)
    md = nm.reshape(4, 5)
    np.testing.assert_allclose(
        _np(t_readout(torch.tensor(xd), mask=torch.tensor(md), op=op)),
        _np(j_readout(jnp.asarray(xd), mask=jnp.asarray(md), op=op)),
        atol=1e-5)
    with pytest.raises(ValueError):
        t_readout(torch.tensor(x), node_graph=torch.tensor(ng), num_graphs=4,
                  op="median")
