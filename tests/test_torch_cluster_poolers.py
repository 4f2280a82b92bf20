"""The port's clustering poolers against the JAX package on the same numpy
inputs: ``use_dense_vote``, ``cluster_to_select_output`` and
``compact_select_output`` (with and without overflow), the greedy
matching and MIS engines (sparse and dense, ties included), the
Graclus, edge-contraction and k-MIS selections and poolers, NoPool, and
``PoolingClassifier`` with each of them, weights carried over by
``params_from_flax``.

Cluster ids, matchings and MIS flags are held equal exactly.  Pooled
values and gradients: 1e-5 of each output's or leaf's largest |value|
(at least 1; f32 sums in other orders).  The JAX CSR branch
(``spmm_csr``, interpret mode) is reached by setting its regime map
``use_pallas_spmm`` to True, as ``tests/test_torch_score_poolers.py``
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tgp_tpu.ops.sparse as j_sparse
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.poolers.nopool import identity_select as j_identity
from tgp_tpu.select import base as j_base
from tgp_tpu.select import edge_contraction as j_ec
from tgp_tpu.select import kmis as j_kmis
from tgp_tpu.select.graclus import graclus_select as j_graclus
from tgp_tpu_torch import PoolingClassifier, get_pooler
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops import sparse as t_sparse
from tgp_tpu_torch.poolers import (EdgeContractionPooling, GraclusPooling,
                                   KMISPooling, NoPool)
from tgp_tpu_torch.poolers.nopool import identity_select
from tgp_tpu_torch.select import base as t_base
from tgp_tpu_torch.select import edge_contraction as t_ec
from tgp_tpu_torch.select import kmis as t_kmis
from tgp_tpu_torch.select.graclus import graclus_select

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN = 6


def _graphs(seed, count=3, feat=F_IN, lo=8, hi=20, unit=False,
            undirected=False, loops=True):
    """Random multigraphs (self-loops and duplicate edges included, as the
    collator passes them on, unless ``loops`` is False); ``unit`` weights
    give every edge the same rank key."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        e = 2 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if not loops:
            s, r = s[s != r], r[s != r]
        if undirected:
            s, r = np.concatenate([s, r]), np.concatenate([r, s])
        x = rng.normal(size=(n, feat)).astype(np.float32)
        w = (np.ones(s.shape[0], np.float32) if unit else
             rng.random(s.shape[0]).astype(np.float32) + 0.2)
        out.append((x, np.stack([s, r]), w))
    return out


def _batches(graphs, sort=False):
    return (j_from(graphs, sort_edges=sort),
            t_from(graphs, sort_edges=sort, **CPU))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _equal(got, ref, what=""):
    np.testing.assert_array_equal(_np(got), _np(ref), err_msg=what)


def _close(got, ref, rel=1e-5, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0,
                               err_msg=what)


def _perturb(params, seed=0):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                    .astype(np.float32)) for v in leaves])


def _carry(tree):
    """A flax pooler tree onto the port's pooler's parameter names."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = params_from_flax({"pooler": tree})
    return {k[len("pooler."):]: v for k, v in sd.items()}


def _carry_selector(tree):
    """A flax selector tree onto the port's selector's names."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return {k[len("selector."):]: v
            for k, v in _carry({"selector": tree}).items()}


def _check_so(got, ref, what=""):
    """Every sparse field of two select outputs."""
    for f in ("cluster_index", "node_sel_mask", "cluster_graph",
              "cluster_pos"):
        _equal(getattr(got, f), getattr(ref, f), f"{what} {f}")
    _close(got.weight, ref.weight, what=f"{what} weight")
    assert (got.num_clusters, got.max_clusters, got.partial) == (
        ref.num_clusters, ref.max_clusters, ref.partial)


def _edge_set(g):
    """The valid edges of a pooled graph as ``(senders, receivers)`` and
    weights, in ``(sender, receiver)`` order."""
    m = _np(g.edge_mask).astype(bool)
    s, r = _np(g.senders)[m], _np(g.receivers)[m]
    o = np.lexsort((r, s))
    return np.stack([s[o], r[o]]), _np(g.edge_weight)[m][o]


def _check_pooled(tout, jout, what=""):
    """Pooled nodes field by field; the merged edges as a set (the port
    merges receiver-major, JAX sender-major), same edge budget, each
    masked slot of weight 0."""
    tg, jg = tout.graph, jout.graph
    _close(tg.x, jg.x, what=f"{what} x")
    for f in ("node_mask", "node_graph", "node_pos"):
        _equal(getattr(tg, f), getattr(jg, f), f"{what} {f}")
    (te, tw), (je, jw) = _edge_set(tg), _edge_set(jg)
    _equal(te, je, f"{what} edges")
    _close(tw, jw, what=f"{what} edge_weight")
    assert tg.num_edges == jg.senders.shape[0]
    assert not _np(tg.edge_weight)[~_np(tg.edge_mask).astype(bool)].any()
    # the port's merged edges ascend by receiver, flagged for GCNConv
    assert tg.edges_sorted and (np.diff(_np(tg.receivers)) >= 0).all()
    assert (tg.num_graphs, tg.max_nodes) == (jg.num_graphs, jg.max_nodes)


# ---------------------------------------------------------------------------
# regime map and SelectOutput builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N", [(1, 4096), (1, 4097), (64, 256), (64, 512),
                                 (1, 65_536)])
def test_use_dense_vote_matches_jax(B, N):
    assert t_sparse.DENSE_VOTE_BUDGET == j_sparse.DENSE_VOTE_BUDGET
    assert t_sparse.use_dense_vote(B, N) == j_sparse.use_dense_vote(B, N)


def _cluster_case(seed):
    jb, tb = _batches(_graphs(seed, count=3))
    rng = np.random.default_rng(seed)
    N = jb.num_nodes
    ci = rng.integers(0, N, N).astype(np.int32)
    sel = rng.random(N) < 0.8
    w = rng.random(N).astype(np.float32)
    return jb, tb, ci, sel, w


@pytest.mark.parametrize("with_sel", [False, True])
def test_cluster_to_select_output_matches_jax(with_sel):
    jb, tb, ci, sel, w = _cluster_case(3)
    N = jb.num_nodes
    kw_j = dict(num_clusters=N, max_clusters=jb.max_nodes)
    if with_sel:
        ref = j_base.cluster_to_select_output(
            jnp.asarray(ci), jb, weight=jnp.asarray(w),
            node_sel_mask=jnp.asarray(sel), **kw_j)
        got = t_base.cluster_to_select_output(
            torch.tensor(ci), tb, weight=torch.tensor(w),
            node_sel_mask=torch.tensor(sel), **kw_j)
    else:
        ref = j_base.cluster_to_select_output(jnp.asarray(ci), jb, **kw_j)
        got = t_base.cluster_to_select_output(torch.tensor(ci), tb, **kw_j)
    _check_so(got, ref)
    _equal(got.out_mask(), ref.out_mask())


@pytest.mark.parametrize("budget", [None, 3])
def test_compact_select_output_matches_jax(budget, capfd):
    """A budget that fits every graph, and one that overflows: the same
    relabelled, masked output, the overflow counted on the device and,
    where asked, reported on stderr as JAX prints it."""
    jb, tb, ci, sel, _ = _cluster_case(4)
    N = jb.num_nodes
    budget = budget or jb.max_nodes
    kw = dict(num_clusters=N, max_clusters=jb.max_nodes)
    jso = j_base.cluster_to_select_output(
        jnp.asarray(ci % 7 + np.asarray(jb.node_graph) * 7), jb,
        node_sel_mask=jnp.asarray(sel), **kw)
    tso = t_base.cluster_to_select_output(
        torch.tensor(ci % 7) + tb.node_graph * 7, tb,
        node_sel_mask=torch.tensor(sel), **kw)
    ref = j_base.compact_select_output(jso, budget)
    capfd.readouterr()
    got = t_base.compact_select_output(tso, budget, check=True)
    _check_so(got, ref)
    _equal(got.out_mask(), ref.out_mask())
    occupied = np.asarray(jso.out_mask())
    per_graph = np.bincount(np.asarray(jso.cluster_graph)[occupied],
                            minlength=jb.num_graphs)
    dropped = int(np.clip(per_graph - budget, 0, None).sum())
    assert int(got.extras["overflow"]) == dropped
    assert (dropped > 0) == (budget == 3)
    err = capfd.readouterr().err
    assert ("ERROR compact_select_output" in err) == (dropped > 0)
    if dropped:
        assert f"({dropped} supernodes dropped)" in err


def test_identity_select_and_nopool_match_jax():
    jb, tb = _batches(_graphs(5), sort=True)
    got, ref = identity_select(tb), j_identity(jb)
    _check_so(got, ref)
    out = get_pooler("nopool", **CPU)(tb)
    assert isinstance(get_pooler("nopool", **CPU), NoPool)
    assert out.graph is tb and out.so.partial
    x = torch.randn(tb.num_nodes, 4)
    _close(out.graph.x, tb.x)
    _close(get_pooler("nopool")(tb, so=out.so, lifting=True, x=x),
           x * tb.node_mask[:, None])


# ---------------------------------------------------------------------------
# matching and MIS engines
# ---------------------------------------------------------------------------


def _edge_rank(jb, seed, ties):
    """A rank as the selections make it: valid edges first, by a key that
    is constant (``ties``) or random."""
    E = jb.num_edges
    key = (np.ones(E, np.float32) if ties else
           np.random.default_rng(seed).random(E).astype(np.float32))
    em = np.asarray(jb.edge_mask)
    order = np.lexsort((-key, ~em))
    rank = np.zeros(E, np.int32)
    rank[order] = np.arange(E, dtype=np.int32)
    return rank


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_matching_engines_match_jax(impl, ties):
    jb, tb = _batches(_graphs(6, count=4))
    rank = _edge_rank(jb, 6, ties)
    ref = np.asarray(j_ec.matching(jnp.asarray(rank), jb, impl))
    got, rounds = t_ec.matching(torch.tensor(rank), tb, impl)
    _equal(got, ref)
    assert ref.any() and int(rounds) >= 1
    # a maximal matching: no valid edge joins two unmatched nodes
    s, r = np.asarray(jb.senders), np.asarray(jb.receivers)
    hit = np.zeros(jb.num_nodes, bool)
    hit[s[ref]] = hit[r[ref]] = True
    assert not (np.asarray(jb.edge_mask) & ~hit[s] & ~hit[r]).any()


def test_matching_rounds_count_the_rounds_that_had_work():
    """The port's rounds are JAX's while-loop trips: a path graph ranked
    from its far end matches one edge a round."""
    n = 9
    s = np.arange(n - 1)
    graphs = [(np.zeros((n, 1), np.float32), np.stack([s, s + 1]),
               np.arange(1, n, dtype=np.float32))]
    _, tb = _batches(graphs)
    for impl in ("sparse", "dense"):
        so = graclus_select(tb, matching_impl=impl)
        # heaviest edge last on the path: (7, 8), then (5, 6), ...
        assert int(so.extras["rounds"]) == 4, impl
        assert int(so.extras["match"].sum()) == 4


def _node_rank(jb, seed, ties):
    N = jb.num_nodes
    key = (np.ones(N, np.float32) if ties else
           np.random.default_rng(seed).random(N).astype(np.float32))
    nm = np.asarray(jb.node_mask)
    order = np.lexsort((-key, ~nm))
    rank = np.zeros(N, np.int32)
    rank[order] = np.arange(N, dtype=np.int32)
    return rank


@pytest.mark.parametrize("order_k", [1, 2])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_mis_engines_match_jax(order_k, ties):
    jb, tb = _batches(_graphs(7, count=4))
    rank = _node_rank(jb, 7, ties)
    jr, tr = jnp.asarray(rank), torch.tensor(rank)
    args_j = (jb.senders, jb.receivers, jb.edge_mask, jb.node_mask, order_k)
    args_t = (tb.senders, tb.receivers, tb.edge_mask, tb.node_mask, order_k)
    ref_mis = np.asarray(j_kmis.maximal_independent_set(jr, *args_j))
    ref_cl = np.asarray(j_kmis.mis_cluster(jnp.asarray(ref_mis), jr,
                                           *args_j))
    mis, rounds = t_kmis.maximal_independent_set(tr, *args_t)
    _equal(mis, ref_mis, "sparse mis")
    _equal(t_kmis.mis_cluster(mis, tr, *args_t), ref_cl, "sparse cluster")
    mis_d, rounds_d = t_kmis.maximal_independent_set_dense(tr, tb, order_k)
    _equal(mis_d, np.asarray(j_kmis.maximal_independent_set_dense(
        jr, jb, order_k)), "dense mis")
    _equal(t_kmis.mis_cluster_dense(mis_d, tr, tb, order_k), np.asarray(
        j_kmis.mis_cluster_dense(jnp.asarray(ref_mis), jr, jb, order_k)),
        "dense cluster")
    _equal(mis_d, ref_mis)
    assert int(rounds) == int(rounds_d) >= 1


# ---------------------------------------------------------------------------
# Graclus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("weighted,unit", [(True, False), (False, False),
                                           (True, True)])
def test_graclus_select_matches_jax(impl, weighted, unit):
    jb, tb = _batches(_graphs(8, count=3, unit=unit))
    ref = j_graclus(jb, weighted=weighted, matching_impl=impl)
    got = graclus_select(tb, weighted=weighted, matching_impl=impl)
    _check_so(got, ref)


@pytest.mark.parametrize("kw", [{}, dict(degree_norm=True),
                                dict(edge_weight_norm=True,
                                     connect_red_op="max"),
                                dict(remove_self_loops=False,
                                     connect_red_op="mean")])
def test_graclus_pooler_matches_jax(kw):
    jb, tb = _batches(_graphs(9, count=3, undirected=True), sort=True)
    jout = j_get("graclus", **kw).apply({}, jb)
    tpool = get_pooler("graclus", **kw, **CPU)
    assert isinstance(tpool, GraclusPooling)
    tout = tpool(tb)
    _check_so(tout.so, jout.so)
    _check_pooled(tout, jout)
    for op in ("transpose", "inverse"):
        xp = jnp.asarray(np.random.default_rng(1).normal(
            size=(jb.num_nodes, 3)).astype(np.float32))
        jl = j_get("graclus", lift_op=op).apply({}, jb, so=jout.so,
                                                lifting=True, x=xp)
        tl = get_pooler("graclus", lift_op=op)(tb, so=tout.so, lifting=True,
                                              x=torch.tensor(np.asarray(xp)))
        _close(tl, jl, what=op)


# ---------------------------------------------------------------------------
# edge contraction
# ---------------------------------------------------------------------------


def _ec_pair(jb, method="softmax", add=0.5, seed=0, impl="auto"):
    jsel = j_ec.EdgeContractionSelect(in_channels=F_IN,
                                      edge_score_method=method,
                                      add_to_edge_score=add,
                                      matching_impl=impl)
    p = _perturb(jsel.init(jax.random.key(seed), jb), seed)
    tsel = t_ec.EdgeContractionSelect(F_IN, method, 0.0, add,
                                      matching_impl=impl, **CPU)
    tsel.load_state_dict(_carry_selector(p))
    return jsel, p, tsel


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("method", ["softmax", "tanh", "sigmoid"])
def test_edge_contraction_select_matches_jax(impl, method):
    """Cluster ids and weights, then the gradient of the weights through
    the edge scorer (its ``lin``, split into the sender and receiver
    halves in the port)."""
    jb, tb = _batches(_graphs(10, count=3))
    jsel, p, tsel = _ec_pair(jb, method, impl=impl)
    ref = jsel.apply(p, jb)
    got = tsel(tb)
    _check_so(got, ref)
    G = np.random.default_rng(2).normal(size=jb.num_nodes).astype(
        np.float32)
    jg = jax.grad(lambda q: (jsel.apply(q, jb).weight * G).sum())(p)
    (got.weight * torch.tensor(G)).sum().backward()
    for k, v in _carry_selector(jg).items():
        _close(dict(tsel.named_parameters())[k].grad, v, what=k)


def test_edge_contraction_ties_match_jax():
    """Each receiver of one edge scores exactly 1 + 0.5 under the
    softmax: ties the rank breaks by edge order in both packages."""
    rng = np.random.default_rng(11)
    n = 12
    s = rng.permutation(n)
    graphs = [(rng.normal(size=(n, F_IN)).astype(np.float32),
               np.stack([s, np.arange(n)]))]
    jb, tb = _batches(graphs)
    jsel, p, tsel = _ec_pair(jb)
    ref, got = jsel.apply(p, jb), tsel(tb)
    _check_so(got, ref)
    assert float(got.weight.detach().max()) == 1.5


def test_edge_contraction_dropout_draws_from_its_generator():
    _, tb = _batches(_graphs(12))
    sel = t_ec.EdgeContractionSelect(F_IN, dropout=0.5, **CPU)
    sel.train()
    a = sel.edge_score(tb.replace()).detach()
    sel.dropout_generator = torch.Generator().manual_seed(3)
    b = sel.edge_score(tb).detach()
    sel.dropout_generator = torch.Generator().manual_seed(3)
    c = sel.edge_score(tb).detach()
    assert torch.equal(b, c) and a.shape == b.shape
    sel.eval()
    d = sel.edge_score(tb).detach()
    sel.dropout = 0.0
    assert torch.equal(d, sel.edge_score(tb).detach())


@pytest.mark.parametrize("kw", [{}, dict(edge_score_method="tanh",
                                         degree_norm=True),
                                dict(connect_red_op="max",
                                     lift_op="inverse")])
def test_edge_contraction_pooler_matches_jax(kw):
    jb, tb = _batches(_graphs(13, count=3, undirected=True), sort=True)
    jpool = j_get("ec", in_channels=F_IN, **kw)
    p = _perturb(jpool.init(jax.random.key(1), jb), 3)
    tpool = get_pooler("ec", in_channels=F_IN, **kw, **CPU)
    assert isinstance(tpool, EdgeContractionPooling)
    tpool.load_state_dict(_carry(p))
    jout, tout = jpool.apply(p, jb), tpool(tb)
    _check_so(tout.so, jout.so)
    _check_pooled(tout, jout)
    G = np.random.default_rng(3).normal(size=tuple(tout.graph.x.shape))
    jg = jax.grad(lambda q: (jpool.apply(q, jb).graph.x * G).sum())(p)
    (tout.graph.x * torch.tensor(G, dtype=torch.float32)).sum().backward()
    for k, v in _carry(jg).items():
        _close(dict(tpool.named_parameters())[k].grad, v, what=k)
    jl = jpool.apply(p, jb, so=jout.so, lifting=True, x=jout.graph.x)
    _close(tpool(tb, so=tout.so, lifting=True, x=tout.graph.x), jl)


# ---------------------------------------------------------------------------
# k-MIS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("scorer,heur,order_k,undirected", [
    ("linear", "greedy", 1, False), ("linear", "w-greedy", 2, False),
    ("linear", None, 1, True), ("constant", "greedy", 1, False),
    ("canonical", None, 2, False), ("degree", "greedy", 1, True)])
def test_kmis_select_matches_jax(impl, scorer, heur, order_k, undirected):
    """``mis``, cluster ids and weights; the constant scorer ties every
    node.  JAX's pooler runs its ``"auto"`` engine (dense at this size),
    the port each engine in turn."""
    jb, tb = _batches(_graphs(14, count=3))
    jsel = j_kmis.KMISSelect(in_channels=F_IN, order_k=order_k,
                             scorer=scorer, score_heuristic=heur,
                             force_undirected=undirected)
    p = jsel.init(jax.random.key(2), jb)
    if scorer == "linear":
        p = _perturb(p, 4)
    tsel = t_kmis.KMISSelect(F_IN, order_k, scorer, heur, mis_impl=impl,
                             force_undirected=undirected, **CPU)
    if scorer == "linear":
        tsel.load_state_dict(_carry_selector(p))
    ref, got = jsel.apply(p, jb), tsel(tb)
    _check_so(got, ref)
    _equal(got.extras["mis"], ref.extras["mis"])


def test_kmis_random_scorer():
    """With a generator the draws are its uniforms; without one, JAX's
    index hash by the same f32 operations — equal to JAX's value
    wherever the two frameworks' f32 ``sin`` agree, in [0, 1)."""
    _, tb = _batches(_graphs(15))
    N = tb.num_nodes
    g = torch.Generator().manual_seed(5)
    sel = t_kmis.KMISSelect(scorer="random", score_generator=g, **CPU)
    want = torch.rand(N, generator=torch.Generator().manual_seed(5))
    _close(sel(tb).weight, torch.where(tb.node_mask, want, 0.0))
    h = t_kmis.index_hash(N, "cpu")
    ar = jnp.arange(N)
    jh = np.asarray(jnp.sin(ar * 12.9898) * 43758.5453 % 1.0)
    same_sin = (np.asarray(jnp.sin(ar * 12.9898))
                == torch.sin(torch.arange(N, dtype=torch.int32)
                             * 12.9898).numpy())
    assert same_sin.mean() > 0.8
    np.testing.assert_array_equal(h.numpy()[same_sin], jh[same_sin])
    assert float(h.min()) >= 0.0 and float(h.max()) < 1.0
    sel = t_kmis.KMISSelect(scorer="random", **CPU)
    _close(sel(tb).weight, torch.where(tb.node_mask, h, 0.0))


@pytest.mark.parametrize("kw", [{}, dict(reduce_red_op=None),
                                dict(order_k=2, force_undirected=True,
                                     edge_weight_norm=True),
                                dict(lift_op="inverse",
                                     connect_red_op="mean")])
def test_kmis_pooler_matches_jax(kw):
    jb, tb = _batches(_graphs(16, count=3), sort=True)
    jpool = j_get("kmis", in_channels=F_IN, **kw)
    p = _perturb(jpool.init(jax.random.key(3), jb), 5)
    tpool = get_pooler("kmis", in_channels=F_IN, **kw, **CPU)
    assert isinstance(tpool, KMISPooling)
    tpool.load_state_dict(_carry(p))
    jout, tout = jpool.apply(p, jb), tpool(tb)
    _check_so(tout.so, jout.so)
    _check_pooled(tout, jout)
    G = np.random.default_rng(4).normal(size=tuple(tout.graph.x.shape))
    jg = jax.grad(lambda q: (jpool.apply(q, jb).graph.x * G).sum())(p)
    (tout.graph.x * torch.tensor(G, dtype=torch.float32)).sum().backward()
    for k, v in _carry(jg).items():
        _close(dict(tpool.named_parameters())[k].grad, v, what=k)
    jl = jpool.apply(p, jb, so=jout.so, lifting=True, x=jout.graph.x)
    _close(tpool(tb, so=tout.so, lifting=True, x=tout.graph.x), jl)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

ALIASES = ["ec", "graclus", "kmis", "nopool"]


def _model_pair(alias, jb, bf16=False, use_kernel=None, **kw):
    jm = JPC(pooler=j_get(alias, in_channels=8, **kw), num_classes=3,
             hidden=8, use_pallas=use_kernel,
             compute_dtype=jnp.bfloat16 if bf16 else None)
    params = _perturb(jm.init(jax.random.key(6), jb), 13)
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, **kw, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN,
                           use_kernel=use_kernel,
                           compute_dtype=torch.bfloat16 if bf16 else None,
                           **CPU)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


@pytest.mark.parametrize("alias", ALIASES)
def test_pooling_classifier_two_steps_match_jax(alias):
    """Logits, loss and every gradient leaf at step one and, after the
    same optax Adam update, at step two."""
    graphs = _graphs(17, count=4)
    jb, tb = _batches(graphs)
    jm, params, tm = _model_pair(alias, jb)
    y = np.array([0, 1, 2, 1], np.int32)
    tx = optax.adam(1e-2)
    opt = tx.init(params)
    for step in range(2):
        (jl, jlog), jg = jax.value_and_grad(
            lambda p: (lambda lg: (_ce(lg, jnp.asarray(y)), lg))(
                jm.apply(p, jb)[0]), has_aux=True)(params)
        tm.load_state_dict(params_from_flax(params))
        tm.zero_grad()
        logits, _ = tm(tb)
        loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y)
                                                 .long())
        loss.backward()
        _close(logits, jlog, what=f"logits, step {step + 1}")
        _close(loss, jl, what=f"loss, step {step + 1}")
        want = params_from_flax(jax.tree.map(np.asarray, jg))
        got = {k: p.grad for k, p in tm.named_parameters()}
        assert set(got) == set(want)
        for k, v in want.items():
            _close(got[k], v, what=f"{k}, step {step + 1}")
        upd, opt = tx.update(jg, opt)
        params = optax.apply_updates(params, upd)


@pytest.mark.parametrize("alias", ALIASES + ["lap"])
def test_params_from_flax_places_every_leaf(alias):
    jb, _ = _batches(_graphs(18))
    jm = JPC(pooler=j_get(alias, in_channels=8), num_classes=3, hidden=8)
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN, **CPU)
    sd = params_from_flax(jm.init(jax.random.key(0), jb))
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)


@pytest.fixture
def jax_csr(monkeypatch):
    monkeypatch.setattr(j_sparse, "use_pallas_spmm",
                        lambda num_edges, edges_sorted: bool(edges_sorted))


@pytest.mark.parametrize("alias", ["ec", "graclus", "kmis"])
def test_served_configuration_matches_jax(alias, jax_csr):
    """The chip's configuration at a small size (sorted edges, the CSR
    branch before the pool, bf16 GCN products; loop-free graphs, since
    JAX's CSR branch adds a second unit loop to a node with its own): the
    same clusters, and logits within 2e-2 of the logit scale."""
    jb, tb = _batches(_graphs(19, count=2, loops=False), sort=True)
    jm, params, tm = _model_pair(alias, jb, bf16=True, use_kernel=True)
    jlog, jout = jm.apply(params, jb)
    tlog, tout = tm(tb)
    _equal(tout.so.cluster_index, jout.so.cluster_index)
    ref = np.asarray(jlog)
    np.testing.assert_allclose(_np(tlog), ref,
                               atol=2e-2 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("alias", ["ec", "graclus", "kmis"])
def test_cluster_model_runs_one_k1_pass_each_way(alias, monkeypatch):
    """The counts ``chip_smoke.py`` asserts for the clustering poolers:
    the pre-pool GCN's product on the CSR branch (K1 once forward, its
    ``d_h`` once backward); the fixed-order sums of the pooler on K4
    (EC's softmax normalizer, k-MIS's greedy heuristic, the cluster sums
    of the reduce, the merge of duplicate edges); the merged pooled graph
    ascends by receiver, so the post-pool GCN takes the sorted branch (its
    degree and aggregation on K2, as on the card, where its edge count
    puts it in the kernel regime); the readout's K4 once."""
    import tgp_tpu_torch.ops.kernels.segment_spmm as K

    _, tb = _batches(_graphs(20, count=2), sort=True)
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN,
                           use_kernel=None, **CPU)
    for conv in (*tm.pre_convs, *tm.post_convs):
        conv.use_kernel = True
    calls = []
    real, real_k4 = K._csr_sum, K._k4_sum

    def spy(x, w, idx, row_ptr, num_rows, counter):
        calls.append(counter.__name__)
        return real(x, w, idx, row_ptr, num_rows, counter)

    def spy_k4(*args):
        calls.append("sorted_segment_sum")
        return real_k4(*args)

    monkeypatch.setattr(K, "_csr_sum", spy)
    monkeypatch.setattr(K, "_k4_sum", spy_k4)
    logits, out = tm(tb)
    assert out.graph.edges_sorted and out.graph.row_ptr is None
    k4 = ["sorted_segment_sum"]
    select = {"ec": k4, "graclus": [], "kmis": k4}[alias]
    forward = (["spmm_csr"] + select + k4 * 2
               + ["segment_sum_sorted"] * 2 + k4)
    assert calls == forward
    torch.nn.functional.cross_entropy(
        logits, torch.tensor([0, 2]).long()).backward()
    assert calls == forward + ["spmm_csr"]
