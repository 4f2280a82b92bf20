"""MaxCut in the port (``ops/lap.py``, ``ops/assignment.py``,
``select/maxcut.py``, ``poolers/maxcut.py``) against the JAX package on
the same numpy graphs and converted parameters: the δ-GCN matrix and the
Laplacian, the eigen-solvers against ``numpy.linalg.eigh``, both voting
engines (against JAX and each other), the fallbacks, the score net on
both propagation engines (the sparse one on K1's plain version, with and
without the collator's CSR layout, against JAX's COO SpMM), the pooler's
values, loss and gradients, and a ``PoolingClassifier`` step.

Tolerances: 1e-5 of each output's or leaf's largest |value| (at least 1)
for f32 values summed in other orders; cluster ids, masks and votes
exactly; eigenpairs 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.ops import assignment as JA
from tgp_tpu.ops import lap as JL
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.select.maxcut import MaxCutScoreNet as JNet
from tgp_tpu.select.topk import topk_select_from_scores as j_topk
from tgp_tpu_torch import PoolingClassifier, get_pooler
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops import assignment as TA
from tgp_tpu_torch.ops import lap as TL
from tgp_tpu_torch.ops.kernels import segment_spmm as K
from tgp_tpu_torch.poolers import MaxCutPooling
from tgp_tpu_torch.select.maxcut import MaxCutScoreNet
from tgp_tpu_torch.select.topk import topk_select_from_scores as t_topk

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN = 6
MP = (8, 8, 4, 4)  # a short stack of rounds (JAX's default has 12)


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


def _graphs(seed, count=3, lo=8, hi=20, isolated=False):
    """Random weighted multigraphs (duplicates and self-loops included);
    ``isolated`` leaves the last node of each graph without edges."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        m = n - 1 if isolated else n
        s, r = rng.integers(0, m, 2 * n), rng.integers(0, m, 2 * n)
        x = rng.normal(size=(n, F_IN)).astype(np.float32)
        w = rng.random(s.shape[0]).astype(np.float32) + 0.2
        out.append((x, np.stack([s, r]), w))
    return out


def _batches(graphs, sort=False, **kw):
    return (j_from(graphs, sort_edges=sort, **kw),
            t_from(graphs, sort_edges=sort, **kw, **CPU))


def _args(b, torch_side):
    f = torch.tensor if torch_side else jnp.asarray
    return [f(np.asarray(getattr(b, k))) for k in
            ("senders", "receivers", "edge_weight", "edge_mask",
             "node_mask")]


@pytest.mark.parametrize("which", ["delta", "lap", "lap_sym"])
def test_delta_gcn_matrix_and_laplacian_match_jax(which):
    jb, tb = _batches(_graphs(1, isolated=True), pad_nodes=64,
                      pad_edges=160)
    N = tb.num_nodes
    if which == "delta":
        j = JL.delta_gcn_matrix(*_args(jb, False), N, 1.5)
        t = TL.delta_gcn_matrix(*_args(tb, True), N, 1.5)
    else:
        norm = "sym" if which == "lap_sym" else None
        j = JL.laplacian(*_args(jb, False), N, norm)
        t = TL.laplacian(*_args(tb, True), N, norm)
    for name, a, b in zip(("s", "r", "w", "mask"), t, j):
        if name == "w":
            _close(a, b, what=name)
        else:
            _equal(a, b, name)


def _sym_graph(n=30, seed=2):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, 80), rng.integers(0, n, 80)
    keep = s != r
    s, r = np.concatenate([s[keep], r[keep]]), np.concatenate([r[keep],
                                                               s[keep]])
    w = np.concatenate([rng.random(keep.sum())] * 2).astype(np.float32) + .1
    A = np.zeros((n, n), np.float64)
    np.add.at(A, (r, s), w)
    return torch.tensor(s), torch.tensor(r), torch.tensor(w), A


def test_power_iteration_finds_the_dominant_eigenvector():
    s, r, w, A = _sym_graph()
    # a PSD operator (A + c·I) so the dominant pair is the largest one
    c = float(np.abs(np.linalg.eigvalsh(A)).max())
    n = A.shape[0]
    loops = torch.arange(n)
    v = TL.power_iteration_max_eigvec(
        torch.cat([s, loops]), torch.cat([r, loops]),
        torch.cat([w, torch.full((n,), c)]), n, num_iters=400,
        generator=torch.Generator().manual_seed(0))
    top = np.linalg.eigh(A + c * np.eye(n))[1][:, -1]
    assert abs(abs(float(np.dot(_np(v), top))) - 1.0) < 1e-3


@pytest.mark.parametrize("largest", [True, False])
def test_lobpcg_matches_eigh(largest):
    s, r, w, A = _sym_graph()
    vals, vecs = TL.lobpcg(s, r, w, A.shape[0], k=3, num_iters=80,
                           largest=largest,
                           generator=torch.Generator().manual_seed(1))
    ev, evec = np.linalg.eigh(A)
    want = ev[::-1][:3] if largest else ev[:3]
    np.testing.assert_allclose(_np(vals), want, atol=1e-3 * np.abs(ev).max())
    ref = evec[:, ::-1][:, :3] if largest else evec[:, :3]
    for j in range(3):
        assert abs(abs(float(np.dot(_np(vecs[:, j]), ref[:, j]))) - 1) < 1e-3


def _partial(seed, ratio=0.3, **kw):
    """A partial top-k selection on random scores, in both packages."""
    jb, tb = _batches(_graphs(seed, count=4, **kw), pad_nodes=80,
                      pad_edges=200)
    sc = np.random.default_rng(seed).normal(size=tb.num_nodes)
    sc = sc.astype(np.float32)
    jso = j_topk(jnp.asarray(sc), jb, ratio)
    tso = t_topk(torch.tensor(sc), tb, ratio)
    _equal(tso.cluster_index, jso.cluster_index)
    return jb, tb, jso, tso


def _edge_args(b, torch_side):
    f = torch.tensor if torch_side else jnp.asarray
    return [f(np.asarray(getattr(b, k))) for k in
            ("senders", "receivers", "edge_mask")]


def test_propagate_step_matches_jax():
    jb, tb, jso, tso = _partial(3)
    jc, ja = jso.cluster_index, jso.node_sel_mask
    tc, ta = tso.cluster_index, tso.node_sel_mask
    for _ in range(3):
        jc, ja = JA.propagate_assignments_step(jc, ja, *_edge_args(jb, False),
                                               jso.num_clusters)
        tc, ta = TA.propagate_assignments_step(tc, ta, *_edge_args(tb, True),
                                               tso.num_clusters)
        _equal(tc, jc)
        _equal(ta, ja)
    assert int(ta.sum()) > int(tso.node_sel_mask.sum())


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("max_iter", [1, 5])
def test_assign_all_nodes_matches_jax(impl, max_iter):
    """Both engines, the deterministic fallback included (an isolated
    node per graph needs it), against JAX's same engine; the two engines
    agree with each other."""
    jb, tb, jso, tso = _partial(4, isolated=True)
    place = dict(max_iter=max_iter, impl=impl, max_nodes=tb.max_nodes)
    w = torch.rand(tb.num_nodes, generator=torch.Generator().manual_seed(0))
    j = JA.assign_all_nodes(jso, *_edge_args(jb, False), weight=jnp.asarray(
        w.numpy()), node_pos=jb.node_pos, **place)
    t = TA.assign_all_nodes(tso, *_edge_args(tb, True), weight=w,
                            node_pos=tb.node_pos, **place)
    for f in ("cluster_index", "node_sel_mask", "weight"):
        _equal(getattr(t, f), getattr(j, f), f)
    assert not t.partial and bool(t.node_sel_mask[tb.node_mask].all())
    other = TA.assign_all_nodes(
        tso, *_edge_args(tb, True), weight=w, node_pos=tb.node_pos,
        **{**place, "impl": "dense" if impl == "sparse" else "sparse"})
    _equal(other.cluster_index, t.cluster_index, "engines")


def test_random_fallback_contract():
    """The random fallback puts each leftover node on an occupied
    supernode of its own graph, the same for a generator's seed."""
    _, tb, _, tso = _partial(5, ratio=0.2, isolated=True)

    def run(seed):
        return TA.assign_all_nodes(
            tso, *_edge_args(tb, True), max_iter=0,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.cluster_index, b.cluster_index)
    assert not torch.equal(a.cluster_index, c.cluster_index)
    nm = tb.node_mask
    assert bool(a.node_sel_mask[nm].all())
    occupied = torch.zeros(tso.num_clusters, dtype=torch.bool)
    occupied[tso.cluster_index[tso.node_sel_mask].long()] = True
    ci = a.cluster_index.long()[nm]
    assert bool(occupied[ci].all())
    _equal(tso.cluster_graph[ci], tb.node_graph[nm])


def _net_pair(impl, sort, seed=7, **kw):
    jb, tb = _batches(_graphs(seed, isolated=True), sort=sort)
    jnet = JNet(in_channels=F_IN, mp_units=MP, mp_impl=impl, **kw)
    p = jnet.init(jax.random.key(seed), jb)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(seed)
    p = jax.tree.unflatten(tree, [jnp.asarray(np.asarray(v) + 0.2 * rng.normal(
        size=v.shape).astype(np.float32)) for v in leaves])
    tnet = MaxCutScoreNet(F_IN, MP, mp_impl=impl, **kw, **CPU)
    sd = params_from_flax({"pooler": {"selector": {"MaxCutScoreNet_0":
                                                   p["params"]}}})
    tnet.load_state_dict({k.split("score_net.")[1]: v for k, v in sd.items()})
    return jb, tb, jnet, p, tnet


@pytest.mark.parametrize("impl,sort", [("dense", False), ("sparse", False),
                                       ("sparse", True)],
                         ids=["dense", "sparse_sorted_here", "sparse_csr"])
def test_score_net_matches_jax(impl, sort, monkeypatch):
    """Scores and the gradients of ⟨G, score⟩ for every parameter and the
    input features.  The sparse engine runs each round's product on K1
    (its plain version here): twice per round forward and backward, one
    launch each, never a scatter; JAX sums its COO with the loops
    appended."""
    jb, tb, jnet, p, tnet = _net_pair(impl, sort)
    G = np.random.default_rng(0).normal(size=tb.num_nodes).astype(np.float32)
    G *= np.asarray(jb.node_mask)

    def obj(q, x):
        return jnp.sum(jnet.apply(q, jb.replace(x=x)) * G)

    jg_p, jg_x = jax.grad(obj, argnums=(0, 1))(p, jb.x)
    calls = []
    real = K._csr_sum
    monkeypatch.setattr(K, "_csr_sum", lambda *a: calls.append(a[-1].__name__)
                        or real(*a))
    x = tb.x.clone().requires_grad_(True)
    score = tnet(tb.replace(x=x))
    _close(score * tb.node_mask, jnet.apply(p, jb) * jb.node_mask, what="score")
    n_fwd = len(calls)
    (score * torch.tensor(G)).sum().backward()
    assert calls == ["spmm_csr"] * (2 * len(MP) if impl == "sparse" else 0)
    assert n_fwd == (len(MP) if impl == "sparse" else 0)
    _close(x.grad, jg_x, what="d x")
    got = dict(tnet.named_parameters())
    sd = params_from_flax({"pooler": {"selector": {"MaxCutScoreNet_0":
                                                   jg_p["params"]}}})
    for k, v in sd.items():
        _close(got[k.split("score_net.")[1]].grad, v, what=f"d {k}")


def test_score_net_engines_agree():
    """The dense and sparse engines give the same scores on one batch."""
    _, tb, _, _, dense = _net_pair("dense", True)
    sparse = MaxCutScoreNet(F_IN, MP, mp_impl="sparse", **CPU)
    sparse.load_state_dict(dense.state_dict())
    nm = tb.node_mask
    _close(sparse(tb)[nm], dense(tb)[nm], what="engines")
    assert dense.engine(tb) == "dense"


@pytest.mark.parametrize("impl,assign", [("dense", True), ("sparse", True),
                                         ("sparse", False)],
                         ids=["dense", "sparse", "sparse_partial"])
def test_maxcut_pooling_matches_jax(impl, assign):
    """Selection (cluster ids), pooled features and edges, the maxcut
    loss, and the gradients of loss + ⟨G, x'⟩ for every parameter."""
    jb, tb = _batches(_graphs(9, count=4, isolated=True), sort=True)
    kw = dict(in_channels=F_IN, ratio=0.4, mp_units=MP[2:], mp_impl=impl,
              assign_all_nodes=assign, max_iter=3)
    jp = j_get("maxcut", **kw)
    p = jp.init(jax.random.key(2), jb)
    tp = get_pooler("maxcut", **kw, **CPU)
    assert isinstance(tp, MaxCutPooling)
    sd = params_from_flax({"pooler": p["params"]})
    tp.load_state_dict({k[len("pooler."):]: v for k, v in sd.items()})
    jout = jp.apply(p, jb)
    tout = tp(tb)
    for f in ("cluster_index", "node_sel_mask"):
        _equal(getattr(tout.so, f), getattr(jout.so, f), f)
    _close(tout.so.weight, jout.so.weight, what="weight")
    _close(tout.loss["maxcut_loss"], jout.loss["maxcut_loss"], what="loss")
    _close(tout.graph.x, jout.graph.x, what="x'")
    # the pooled edges as sets of (sender, receiver, weight)
    for g, name in ((tout.graph, "port"), (jout.graph, "jax")):
        m = _np(g.edge_mask).astype(bool)
        key = _np(g.senders)[m] * 10 ** 4 + _np(g.receivers)[m]
        if name == "port":
            t_edges = dict(zip(key.tolist(), _np(g.edge_weight)[m].tolist()))
        else:
            j_edges = dict(zip(key.tolist(), _np(g.edge_weight)[m].tolist()))
    assert t_edges.keys() == j_edges.keys()
    np.testing.assert_allclose([t_edges[k] for k in j_edges],
                               list(j_edges.values()), atol=1e-5)
    G = np.random.default_rng(1).normal(size=jout.graph.x.shape)
    G = G.astype(np.float32)

    def obj(q):
        o = jp.apply(q, jb)
        return o.loss["maxcut_loss"] + jnp.sum(o.graph.x * G)

    jg = jax.grad(obj)(p)
    (tout.loss["maxcut_loss"] + (tout.graph.x * torch.tensor(G)).sum()
     ).backward()
    got = dict(tp.named_parameters())
    for k, v in params_from_flax({"pooler": jg["params"]}).items():
        _close(got[k[len("pooler."):]].grad, v, what=f"d {k}")


def test_maxcut_loss_is_skipped_without_scores():
    _, tb = _batches(_graphs(10), sort=True)
    tp = get_pooler("maxcut", in_channels=F_IN, mp_units=MP, **CPU)
    so = tp.selector(tb)
    out = tp(tb, so=so.replace(extras={}))
    assert out.loss == {}


def test_maxcut_classifier_step_matches_jax():
    """``PoolingClassifier`` with MaxCut on a CSR batch (the pre-pool GCN
    and the rounds on K1's plain version): logits, loss and every gradient
    leaf at step one.  JAX's GCN takes its generic branch (its CSR branch
    adds a second unit loop; the port's branches all follow
    ``gcn_norm``)."""
    jb, tb = _batches(_graphs(11, count=4), sort=True)
    kw = dict(in_channels=8, ratio=0.5, mp_units=MP[2:], max_iter=2)
    jm = JPC(pooler=j_get("maxcut", **kw), num_classes=3, hidden=8,
             use_pallas=False)
    params = jm.init(jax.random.key(3), jb)
    tm = PoolingClassifier(get_pooler("maxcut", **kw, **CPU), num_classes=3,
                           hidden=8, in_channels=F_IN, use_kernel=True, **CPU)
    tm.load_state_dict(params_from_flax(params))
    y = np.array([0, 1, 2, 1], np.int32)

    def loss_fn(p):
        logits, out = jm.apply(p, jb)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return ce + out.loss_sum(), logits

    (jl, jlog), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    logits, out = tm(tb)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.tensor(y).long()) + out.loss_sum()
    loss.backward()
    _close(logits, jlog, what="logits")
    _close(loss, jl, what="loss")
    got = dict(tm.named_parameters())
    for k, v in params_from_flax(jax.tree.map(np.asarray, jg)).items():
        _close(got[k].grad, v, what=f"d {k}")
