"""The port's score-and-keep poolers and their layers against the JAX
package, with the same numpy inputs and the flax weights carried over by
``params_from_flax``: ``GraphConv`` (both aggregations, the CSR and the
generic branch), ``LEConv``, ``SAGPooling`` (each scorer, ``min_score``,
masked and compact pooling, the golden file), ``ASAPooling``, ``PANConv``
and ``PANPooling``, and the models that hold them, values and gradients.

f32 throughout.  Values: atol 2e-5.  Gradients: atol 2e-5 of the largest
|value| of the JAX gradient (at least 1), leaf by leaf: the sums run in
other orders in the two packages.

The JAX side runs as its own tests run it on the CPU; its CSR branch
(``spmm_csr``, interpret mode) is reached by setting the JAX regime map
``use_pallas_spmm`` to True, which the CPU backend otherwise never does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu.ops.sparse as j_sparse
from examples.classification_pan import PANNet as JPANNet
from examples.classification_pan_torch import PANNet
from tests.utils_graphs import erdos_renyi_graph
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.mp.gcn import GraphConv as JGraphConv
from tgp_tpu.mp.leconv import LEConv as JLEConv
from tgp_tpu.mp.pan import PANConv as JPANConv
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.classifiers import PoolingClassifier
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.mp import GraphConv, LEConv, PANConv
from tgp_tpu_torch.poolers import (ASAPooling, PANPooling, SAGPooling,
                                   get_pooler)

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN = 6


def _graphs(seed, count=3, feat=F_IN, loops=False, lo=8, hi=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        e = 3 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if not loops:
            keep = s != r
            s, r = s[keep], r[keep]
        x = rng.normal(size=(n, feat)).astype(np.float32)
        w = rng.random(s.shape[0]).astype(np.float32) + 0.2
        out.append((x, np.stack([s, r]), w))
    return out


def _batches(graphs, shrink=False, sort=True):
    """One batch for each package; ``shrink`` makes it a masked pooled
    graph (a third of the nodes masked, the edges kept)."""
    jb = j_from(graphs, sort_edges=sort)
    tb = t_from(graphs, sort_edges=sort, **CPU)
    if shrink:
        nm = np.asarray(jb.node_mask) & (np.arange(jb.num_nodes) % 3 != 0)
        jb = jb.replace(node_mask=jnp.asarray(nm), in_degree=None,
                        node_mask_shrunk=True,
                        x=jnp.where(jnp.asarray(nm)[:, None], jb.x, 0.0))
        tb = tb.replace(node_mask=torch.tensor(nm), in_degree=None,
                        node_mask_shrunk=True,
                        x=torch.where(torch.tensor(nm)[:, None], tb.x, 0.0))
    return jb, tb


def _nest(tree, path):
    for key in reversed(path.split("/")):
        tree = {key: tree}
    return tree


def _carry(tree, path, prefix):
    """``params_from_flax`` on a module's flax tree placed where a model
    holds it (``path``), the port names stripped of ``prefix``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = params_from_flax(_nest(tree, path))
    assert all(k.startswith(prefix) for k in sd), sorted(sd)
    return {k[len(prefix):]: v for k, v in sd.items()}


def _load(module, sd):
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and not [
        k for k in missing if not k.startswith("__")], (missing, unexpected)


def _perturb(params, seed=0):
    """Nonzero biases and spread-out weights, so every term shows."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                    .astype(np.float32)) for v in leaves])


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, ref, atol=2e-5):
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=0)


def _grads_close(module, jgrads, path, prefix):
    """Each port parameter's gradient against the flax gradient leaf
    carried over to it."""
    ref = _carry(jgrads, path, prefix)
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, g in ref.items():
        assert got[k] is not None, k
        scale = max(1.0, float(np.abs(g.numpy()).max()))
        np.testing.assert_allclose(_np(got[k]), g.numpy(),
                                   atol=2e-5 * scale, rtol=0, err_msg=k)


@pytest.fixture
def jax_csr(monkeypatch):
    """Send the JAX package's regime map to the CSR kernel (interpret
    mode on the CPU) for every sorted SpMM."""
    monkeypatch.setattr(j_sparse, "use_pallas_spmm",
                        lambda num_edges, edges_sorted: bool(edges_sorted))


# ---------------------------------------------------------------------------
# GraphConv and LEConv
# ---------------------------------------------------------------------------


def _graph_conv_pair(jb, aggr, out=4, use_kernel=None):
    jconv = JGraphConv(out, aggr=aggr)
    p = _perturb(jconv.init(jax.random.key(0), jb, jb.x))
    tconv = GraphConv(F_IN, out, aggr=aggr, use_kernel=use_kernel, **CPU)
    _load(tconv, _carry(p, "pooler/gnn", "pooler.gnn."))
    return jconv, p, tconv


def _check_conv_grads(jfn, p, jx, module, tfn, tx, out_shape, path,
                      prefix):
    """Values and gradients (weights and features) of ``Σ out · G``."""
    G = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)
    jout, (jg, jgx) = jax.value_and_grad(
        lambda p, x: (jfn(p, x) * G).sum(), argnums=(0, 1))(p, jx)
    x = tx.clone().requires_grad_(True)
    module.zero_grad()
    loss = (tfn(x) * torch.tensor(G)).sum()
    loss.backward()
    _close(loss, jout, atol=2e-5 * max(1.0, abs(float(jout))))
    _grads_close(module, jg, path, prefix)
    _close(x.grad, jgx, atol=2e-5 * max(1.0, float(np.abs(jgx).max())))


@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("branch", ["csr", "generic"])
def test_graph_conv_add_matches_jax(branch, shrink, request):
    if branch == "csr":
        request.getfixturevalue("jax_csr")
    jb, tb = _batches(_graphs(11), shrink)
    jconv, p, tconv = _graph_conv_pair(jb, "add",
                                       use_kernel=branch == "csr")
    _close(tconv(tb), jconv.apply(p, jb, jb.x))
    _check_conv_grads(lambda p, x: jconv.apply(p, jb, x), p, jb.x,
                      tconv, lambda x: tconv(tb, x), tb.x, (tb.num_nodes, 4),
                      "pooler/gnn", "pooler.gnn.")


@pytest.mark.parametrize("branch", ["csr", "generic"])
def test_graph_conv_mean_matches_jax_on_compact_batches(branch, request):
    """Where every edge of the sum is valid (a collated batch), the port's
    degree — the edges its numerator sums — is JAX's degree."""
    if branch == "csr":
        request.getfixturevalue("jax_csr")
    jb, tb = _batches(_graphs(12))
    jconv, p, tconv = _graph_conv_pair(jb, "mean",
                                       use_kernel=branch == "csr")
    _close(tconv(tb), jconv.apply(p, jb, jb.x))
    _check_conv_grads(lambda p, x: jconv.apply(p, jb, x), p, jb.x,
                      tconv, lambda x: tconv(tb, x), tb.x, (tb.num_nodes, 4),
                      "pooler/gnn", "pooler.gnn.")


@pytest.mark.parametrize("branch", ["csr", "generic"])
def test_graph_conv_mean_degree_counts_the_summed_edges(branch):
    """On a masked pooled batch the port divides by the weight of the
    edges it sums (kept senders; both ends kept on the generic branch):
    its mean is that of a plain numpy loop, while JAX's degree also counts
    the edges the numerator drops, so the two differ there."""
    jb, tb = _batches(_graphs(13), shrink=True)
    jconv, p, tconv = _graph_conv_pair(jb, "mean",
                                       use_kernel=branch == "csr")
    got = _np(tconv(tb))
    x, nm = tb.x.numpy(), tb.node_mask.numpy()
    s, r = tb.senders.numpy(), tb.receivers.numpy()
    w = np.where(tb.edge_mask.numpy(), tb.edge_weight.numpy(), 0.0)
    kept = nm[s] if branch == "csr" else nm[s] & nm[r]
    num = np.zeros_like(x)
    deg = np.zeros(x.shape[0], np.float32)
    np.add.at(num, r, (w * kept)[:, None] * x[s])
    np.add.at(deg, r, w * kept)
    neigh = num / np.maximum(deg, 1.0)[:, None]
    lin, lin_1 = tconv.lin, tconv.lin_1
    ref = (x @ lin.weight.detach().numpy().T + lin.bias.detach().numpy()
           + neigh @ lin_1.weight.detach().numpy().T)
    ref = np.where(nm[:, None], ref, 0.0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    jax_out = _np(JGraphConv(4, aggr="mean").apply(p, jb, jb.x))
    assert np.abs(jax_out - got).max() > 1e-3  # JAX's degree ignores masks


def test_graph_conv_rejects_unknown_aggregation():
    with pytest.raises(ValueError, match="aggr"):
        GraphConv(3, 1, aggr="max", **CPU)


@pytest.mark.parametrize("masked", [False, True])
def test_leconv_matches_jax(masked):
    jb, tb = _batches(_graphs(14), shrink=masked)
    jconv = JLEConv(3)
    args = lambda b: (b.senders, b.receivers, b.edge_weight, b.num_nodes,
                      b.node_mask if masked else None)
    p = _perturb(jconv.init(jax.random.key(1), jb.x, *args(jb)))
    tconv = LEConv(F_IN, 3, **CPU)
    _load(tconv, _carry(p, "pooler/gnn", "pooler.gnn."))
    _close(tconv(tb.x, *args(tb)), jconv.apply(p, jb.x, *args(jb)))
    _check_conv_grads(lambda p, x: jconv.apply(p, x, *args(jb)), p, jb.x,
                      tconv, lambda x: tconv(x, *args(tb)), tb.x,
                      (tb.num_nodes, 3), "pooler/gnn", "pooler.gnn.")


# ---------------------------------------------------------------------------
# SAGPooling
# ---------------------------------------------------------------------------


def _sag_pair(jb, gnn_kind, pool_mode="compact", min_score=None,
              use_kernel=None, seed=2, **kw):
    jp = j_get("sag", in_channels=F_IN, ratio=0.5, gnn_kind=gnn_kind,
               pool_mode=pool_mode, min_score=min_score, **kw)
    p = _perturb(jp.init(jax.random.key(seed), jb), seed)
    tp = get_pooler("sag", in_channels=F_IN, ratio=0.5, gnn_kind=gnn_kind,
                    pool_mode=pool_mode, min_score=min_score,
                    use_kernel=use_kernel, **kw, **CPU)
    assert isinstance(tp, SAGPooling)
    _load(tp, _carry(p, "pooler", "pooler."))
    return jp, p, tp


def _check_pooled(tout, jout, masked):
    _close(tout.graph.x, jout.graph.x)
    for name in ("node_mask", "edge_mask"):
        np.testing.assert_array_equal(
            getattr(tout.graph, name).numpy(),
            np.asarray(getattr(jout.graph, name)), err_msg=name)
    _close(tout.graph.edge_weight, jout.graph.edge_weight)
    np.testing.assert_array_equal(tout.so.node_sel_mask.numpy(),
                                  np.asarray(jout.so.node_sel_mask))
    _close(tout.so.weight, jout.so.weight)
    keep = tout.so.node_sel_mask.numpy()
    np.testing.assert_array_equal(
        np.where(keep, tout.so.cluster_index.numpy(), -1),
        np.where(keep, np.asarray(jout.so.cluster_index), -1))
    if masked:
        assert tout.so.extras["pool_mode"] == "masked"
        assert jout.so.extras["pool_mode"] == "masked"
    else:
        np.testing.assert_array_equal(tout.graph.senders.numpy(),
                                      np.asarray(jout.graph.senders))
        np.testing.assert_array_equal(tout.graph.receivers.numpy(),
                                      np.asarray(jout.graph.receivers))


def _check_pool_grads(jp, p, jb, tp, tb):
    """Gradients of ``Σ pooled x · G`` for the pooler's weights."""
    out = tp(tb)
    G = np.random.default_rng(3).normal(
        size=tuple(out.graph.x.shape)).astype(np.float32)
    jg = jax.grad(lambda p: (jp.apply(p, jb).graph.x * G).sum())(p)
    tp.zero_grad()
    (out.graph.x * torch.tensor(G)).sum().backward()
    _grads_close(tp, jg, "pooler", "pooler.")


@pytest.mark.parametrize("pool_mode", ["compact", "masked"])
@pytest.mark.parametrize("min_score", [None, 0.05])
@pytest.mark.parametrize("gnn_kind", ["graph_conv", "gcn", "le"])
def test_sag_matches_jax(gnn_kind, min_score, pool_mode):
    jb, tb = _batches(_graphs(20, loops=True))
    jp, p, tp = _sag_pair(jb, gnn_kind, pool_mode, min_score)
    jout, tout = jp.apply(p, jb), tp(tb)
    _check_pooled(tout, jout, pool_mode == "masked")
    _close(tp.score(tb), jp.apply(p, jb, method=jp.score))
    _check_pool_grads(jp, p, jb, tp, tb)
    # lift: the masked identity or the compact gather back to the nodes
    _close(tp(tb, so=tout.so, lifting=True, x=tout.graph.x),
           jp.apply(p, jb, so=jout.so, lifting=True, x=jout.graph.x))


@pytest.mark.parametrize("pool_mode", ["compact", "masked"])
@pytest.mark.parametrize("gnn_kind", ["graph_conv", "gcn"])
def test_sag_csr_scorer_matches_jax(gnn_kind, pool_mode, jax_csr):
    """The scorer's propagation on the CSR branch (K1's plain version)
    against JAX's ``spmm_csr`` in interpret mode."""
    jb, tb = _batches(_graphs(21))
    jp, p, tp = _sag_pair(jb, gnn_kind, pool_mode, use_kernel=True)
    _check_pooled(tp(tb), jp.apply(p, jb), pool_mode == "masked")
    _check_pool_grads(jp, p, jb, tp, tb)


def test_sag_scorer_takes_the_csr_branch(monkeypatch):
    """With ``use_kernel=True`` on a batch with the collator's CSR layout,
    the GraphConv scorer calls ``spmm_csr`` once, at the input width."""
    import tgp_tpu_torch.ops.kernels.segment_spmm as K

    calls = []
    real = K.spmm_csr

    def spy(h, *a, **k):
        calls.append(tuple(h.shape))
        return real(h, *a, **k)

    monkeypatch.setattr(K, "spmm_csr", spy)
    _, tb = _batches(_graphs(22))
    tp = get_pooler("sag", in_channels=F_IN, use_kernel=True, **CPU)
    tp(tb)
    assert calls == [(tb.num_nodes, F_IN)]


def test_sag_user_score_gnn():
    """A user scorer (any module ``(batch, x) → [N] or [N, 1]``) replaces
    the built-in one."""
    _, tb = _batches(_graphs(23))

    class Norm(torch.nn.Module):
        def forward(self, batch, x=None):
            return (batch.x if x is None else x).norm(dim=-1, keepdim=True)

    tp = SAGPooling(F_IN, ratio=0.5, score_gnn=Norm(), **CPU)
    score = tp.score(tb)
    ref = torch.tanh(tb.x.norm(dim=-1))
    _close(score, ref)
    with pytest.raises(ValueError, match="gnn_kind"):
        SAGPooling(F_IN, gnn_kind="gat", **CPU)


def test_sag_golden():
    """The port's SAG with the JAX weights of ``tests/test_goldens.py``'s
    run reproduces ``tests/goldens/sag.npz``."""
    graphs = []
    for i, n in enumerate([9, 6, 12]):
        x, ei = erdos_renyi_graph(n, p=0.4, num_features=5, seed=42 + i)
        ew = np.random.default_rng(142 + i).uniform(
            0.5, 2.0, size=ei.shape[1]).astype(np.float32)
        graphs.append((x, ei, ew))
    kw = dict(pad_nodes=32, pad_edges=160)
    jb = j_from(graphs, **kw)
    tb = t_from(graphs, **kw, **CPU)
    jp = j_get("sag", in_channels=5, ratio=0.5, k=4)
    params = jp.init(jax.random.key(42), jb)
    tp = get_pooler("sag", in_channels=5, ratio=0.5, k=4, **CPU)
    _load(tp, _carry(params, "pooler", "pooler."))
    out = tp(tb)
    golden = np.load("tests/goldens/sag.npz")
    np.testing.assert_allclose(_np(out.graph.x), golden["x"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(
        np.where(tb.node_mask.numpy(), out.so.cluster_index.numpy(), -1),
        golden["cluster_index"])


# ---------------------------------------------------------------------------
# ASAPooling
# ---------------------------------------------------------------------------


def _asap_pair(jb, intra_gnn, add_self_loops, seed=4):
    jp = j_get("asap", in_channels=F_IN, ratio=0.5, intra_gnn=intra_gnn,
               add_self_loops=add_self_loops)
    p = _perturb(jp.init(jax.random.key(seed), jb), seed)
    tp = get_pooler("asap", in_channels=F_IN, ratio=0.5,
                    intra_gnn=intra_gnn, add_self_loops=add_self_loops,
                    **CPU)
    assert isinstance(tp, ASAPooling)
    _load(tp, _carry(p, "pooler", "pooler."))
    return jp, p, tp


@pytest.mark.parametrize("add_self_loops", [False, True])
@pytest.mark.parametrize("intra_gnn", [None, "graph_conv", "gcn"])
@pytest.mark.parametrize("loops", [False, True])
def test_asap_matches_jax(intra_gnn, add_self_loops, loops):
    jb, tb = _batches(_graphs(30, loops=loops), sort=False)
    jp, p, tp = _asap_pair(jb, intra_gnn, add_self_loops)
    _check_pooled(tp(tb), jp.apply(p, jb), masked=False)
    _check_pool_grads(jp, p, jb, tp, tb)


def test_asap_dropout_in_training_mode():
    """Dropout > 0: in training mode the attention drops entries from the
    given generator (the same seed, the same pooled graph), the output
    keeps its shapes and masks and stays finite; in eval mode it is the
    pooler without dropout."""
    _, tb = _batches(_graphs(31), sort=False)
    g = torch.Generator().manual_seed(0)

    def pooler(**kw):
        return ASAPooling(F_IN, ratio=0.5, generator=torch.Generator(
            ).manual_seed(5), **kw, **CPU)

    drop = pooler(dropout=0.5, dropout_generator=g)
    plain = pooler()
    ref = plain(tb)
    outs = []
    for _ in range(2):
        g.manual_seed(1)
        outs.append(drop(tb))
    a, b = outs
    assert a.graph.x.shape == ref.graph.x.shape
    for o in (a, b):
        assert torch.isfinite(o.graph.x).all()
        np.testing.assert_array_equal(o.graph.node_mask.numpy(),
                                      o.so.out_mask().numpy())
        assert not o.graph.x[~o.graph.node_mask].any()
    _close(a.graph.x, b.graph.x, atol=0)
    assert (a.graph.x - ref.graph.x).abs().max() > 1e-4
    drop.eval()
    _close(drop(tb).graph.x, ref.graph.x)


# ---------------------------------------------------------------------------
# PANConv and PANPooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dense_met", [False, True])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_pan_conv_matches_jax(normalize, exact, dense_met):
    jb, tb = _batches(_graphs(40, loops=True), sort=False)
    flags = dict(normalize=normalize, exact_met_support=exact,
                 return_dense_met=dense_met)
    jconv = JPANConv(5, filter_size=3, **flags)
    p = _perturb(jconv.init(jax.random.key(6), jb), 6)
    tconv = PANConv(F_IN, 5, filter_size=3, **flags, **CPU)
    _load(tconv, _carry(p, "PANConv_0", "pan_conv."))
    jout, tout = jconv.apply(p, jb), tconv(tb)
    assert len(tout) == len(jout) == (4 if dense_met else 3)
    for a, b in zip(tout, jout):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        _close(a, b, atol=2e-5 * scale)
    Gs = [np.random.default_rng(7 + i).normal(size=np.shape(o)).astype(
        np.float32) for i, o in enumerate(jout)]

    def jloss(p, x):
        return sum((o * G).sum() for o, G in zip(jconv.apply(p, jb, x), Gs))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jb.x)
    x = tb.x.clone().requires_grad_(True)
    sum((o * torch.tensor(G)).sum()
        for o, G in zip(tconv(tb, x), Gs)).backward()
    _grads_close(tconv, jg, "PANConv_0", "pan_conv.")
    _close(x.grad, jgx, atol=2e-5 * max(1.0, float(np.abs(jgx).max())))


@pytest.mark.parametrize("min_score", [None, 0.05])
@pytest.mark.parametrize("source", ["edges", "met_degree", "met_dense"])
def test_pan_pooling_matches_jax(source, min_score):
    """Score and pooled graph from the edge weights, from a given MET
    degree, and with a dense MET matrix (the exact connect), against
    JAX's, values and gradients (``p``, ``beta`` and the MET matrix)."""
    jb, tb = _batches(_graphs(41), sort=False)
    B, K = jb.num_graphs, jb.max_nodes
    rng = np.random.default_rng(8)
    # small MET values keep the scores off tanh's plateau, where ranks
    # would hang on one-ulp differences of saturated scores
    met = 0.05 * np.abs(rng.normal(size=(B, K, K))).astype(np.float32)
    deg = rng.random(jb.num_nodes).astype(np.float32)
    jpool = j_get("pan", in_channels=F_IN, ratio=0.5, min_score=min_score)
    p = _perturb(jpool.init(jax.random.key(0), jb), 9)
    tpool = get_pooler("pan", in_channels=F_IN, ratio=0.5,
                       min_score=min_score, **CPU)
    assert isinstance(tpool, PANPooling)
    _load(tpool, _carry(p, "PANPooling_0", "pooler."))

    def jrun(p, m):
        kw = {"met_degree": dict(met_degree=jnp.asarray(deg)),
              "met_dense": dict(met_dense=m), "edges": {}}[source]
        return jpool.apply(p, jb, **kw)

    t_met = torch.tensor(met, requires_grad=True)
    kw = {"met_degree": dict(met_degree=torch.tensor(deg)),
          "met_dense": dict(met_dense=t_met), "edges": {}}[source]
    tout, jout = tpool(tb, **kw), jrun(p, jnp.asarray(met))
    _check_pooled(tout, jout, masked=False)
    G = rng.normal(size=tuple(tout.graph.x.shape)).astype(np.float32)
    Gw = rng.normal(size=tuple(tout.graph.edge_weight.shape)).astype(
        np.float32)

    def jloss(p, m):
        g = jrun(p, m).graph
        return (g.x * G).sum() + (g.edge_weight * Gw).sum()

    jg, jgm = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(met))
    ((tout.graph.x * torch.tensor(G)).sum()
     + (tout.graph.edge_weight * torch.tensor(Gw)).sum()).backward()
    _grads_close(tpool, jg, "PANPooling_0", "pooler.")
    if source == "met_dense":
        _close(t_met.grad, jgm)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _ce(logits, y):
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                                1).mean()


def _check_model(jfn, params, tmodel, tfn, y):
    """Logits, the loss of a cross-entropy step and every gradient leaf."""
    jl = jfn(params)
    tl = tfn()
    _close(tl, jl, atol=2e-5 * max(1.0, float(np.abs(np.asarray(jl)).max())))
    jloss, jg = jax.value_and_grad(lambda p: _ce(jfn(p), jnp.asarray(y)))(
        params)
    tmodel.zero_grad()
    loss = torch.nn.functional.cross_entropy(tfn(), torch.tensor(y).long())
    loss.backward()
    _close(loss, jloss)
    ref = params_from_flax(jg)
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, g in ref.items():
        scale = max(1.0, float(np.abs(g.numpy()).max()))
        np.testing.assert_allclose(_np(got[k]), g.numpy(), atol=2e-5 * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("alias,kw", [
    ("sag", {}), ("sag", dict(gnn_kind="gcn")), ("sag", dict(gnn_kind="le")),
    ("sag", dict(pool_mode="masked")), ("asap", {}),
    ("asap", dict(intra_gnn="graph_conv")), ("pan", {})])
def test_pooling_classifier_matches_jax(alias, kw):
    graphs = _graphs(50, count=4)
    jb, tb = _batches(graphs, sort=False)
    jm = JPC(pooler=j_get(alias, in_channels=8, ratio=0.5, **kw),
             num_classes=3, hidden=8)
    params = _perturb(jm.init(jax.random.key(3), jb), 10)
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, ratio=0.5, **kw,
                                      **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN, **CPU)
    tm.load_state_dict(params_from_flax(params))
    y = np.array([0, 1, 2, 1])
    _check_model(lambda p: jm.apply(p, jb)[0], params, tm,
                 lambda: tm(tb)[0], y)


def test_pan_net_matches_jax():
    graphs = _graphs(51, count=4, loops=True)
    jb, tb = _batches(graphs, sort=False)
    jm = JPANNet(num_classes=3, hidden=8)
    params = _perturb(jm.init(jax.random.key(4), jb), 11)
    tm = PANNet(F_IN, num_classes=3, hidden=8, **CPU)
    tm.load_state_dict(params_from_flax(params))
    _check_model(lambda p: jm.apply(p, jb), params, tm, lambda: tm(tb),
                 np.array([2, 0, 1, 1]))


@pytest.mark.parametrize("alias,kw", [
    ("sag", {}), ("sag", dict(gnn_kind="gcn")), ("sag", dict(gnn_kind="le")),
    ("asap", {}), ("asap", dict(intra_gnn="graph_conv")),
    ("asap", dict(intra_gnn="gcn")), ("pan", {})])
def test_params_from_flax_places_every_leaf(alias, kw):
    """A full flax tree of each new model maps onto the port's
    ``state_dict`` with no leaf left over and none missing, shapes
    equal."""
    jb, tb = _batches(_graphs(52), sort=False)
    jm = JPC(pooler=j_get(alias, in_channels=8, **kw), num_classes=3,
             hidden=8)
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, **kw, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN, **CPU)
    sd = params_from_flax(jm.init(jax.random.key(0), jb))
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)


def test_params_from_flax_places_every_pan_net_leaf():
    jb, _ = _batches(_graphs(53), sort=False)
    sd = params_from_flax(JPANNet(hidden=8).init(jax.random.key(0), jb))
    ref = PANNet(F_IN, hidden=8, **CPU).state_dict()
    assert set(sd) == set(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)


def _sag_model_pair(jb, bf16, pool_mode="masked"):
    jm = JPC(pooler=j_get("sag", in_channels=8, ratio=0.5,
                          pool_mode=pool_mode),
             num_classes=3, hidden=8, use_pallas=True,
             compute_dtype=jnp.bfloat16 if bf16 else None)
    params = _perturb(jm.init(jax.random.key(5), jb), 12)
    tm = PoolingClassifier(
        get_pooler("sag", in_channels=8, ratio=0.5, pool_mode=pool_mode,
                   use_kernel=True, **CPU),
        num_classes=3, hidden=8, in_channels=F_IN, use_kernel=True,
        compute_dtype=torch.bfloat16 if bf16 else None, **CPU)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("pool_mode", ["masked", "compact"])
def test_sag_model_on_the_csr_path_matches_jax(pool_mode, jax_csr):
    """The served SAG model at a small size on the CSR path (K1's plain
    version for both GCN layers and the scorer) against JAX's (interpret
    mode), f32: logits, loss and every gradient leaf."""
    jb, tb = _batches(_graphs(60, count=4))
    jm, params, tm = _sag_model_pair(jb, bf16=False, pool_mode=pool_mode)
    _, out = tm(tb)
    assert out.so.extras.get("pool_mode") == (
        "masked" if pool_mode == "masked" else None)
    _check_model(lambda p: jm.apply(p, jb)[0], params, tm,
                 lambda: tm(tb)[0], np.array([1, 0, 2, 1]))


def test_sag_model_bf16_matches_jax(jax_csr):
    """The chip's configuration (bf16 GCN products, f32 scorer on the CSR
    branch, masked pooling): logits within 2e-2 of the logit scale, bf16
    rounding of the GCN products in both packages."""
    jb, tb = _batches(_graphs(61, count=4))
    jm, params, tm = _sag_model_pair(jb, bf16=True)
    ref = np.asarray(jm.apply(params, jb)[0])
    got = _np(tm(tb)[0])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max(),
                               rtol=0)


def test_sag_training_step_runs_seven_k1_passes(monkeypatch):
    """The count ``chip_smoke.py``'s [train_sag] asserts: forward, the
    first GCN's product, the scorer's ``A X``, the second GCN's degree
    pass and product, then the readout's K4; backward, the second GCN's,
    the scorer's and the first GCN's ``d_h`` (no ``d_w``; the degree pass
    takes no gradient)."""
    import tgp_tpu_torch.ops.kernels.segment_spmm as K

    _, tb = _batches(_graphs(62, count=2))
    _, _, tm = _sag_model_pair(j_from(_graphs(62, count=2),
                                      sort_edges=True), bf16=False)
    calls = []
    real, real_k4 = K._csr_sum, K._k4_sum

    def spy(x, w, idx, row_ptr, num_rows, counter):
        calls.append((counter.__name__, x.shape[1]))
        return real(x, w, idx, row_ptr, num_rows, counter)

    def spy_k4(*args):
        calls.append(("sorted_segment_sum", args[0].shape[1]))
        return real_k4(*args)

    monkeypatch.setattr(K, "_csr_sum", spy)
    monkeypatch.setattr(K, "_k4_sum", spy_k4)
    logits, _ = tm(tb)
    assert len(calls) == 5
    torch.nn.functional.cross_entropy(
        logits, torch.tensor([0, 2]).long()).backward()
    assert [c for c, _ in calls] == (["spmm_csr"] * 4
                                     + ["sorted_segment_sum"]
                                     + ["spmm_csr"] * 3)
    # the scorer propagates at the pooler's input width, before its
    # projection to width 1; the degree pass at width 1
    assert [f for _, f in calls[:4]] == [8, 8, 1, 8]
