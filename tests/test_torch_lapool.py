"""LaPool and the unbatched dense SRC path of the port against the JAX
package on the same numpy inputs: ``lapool_select`` (with and without the
shortest-path weights), ``reduce_dense_unbatched``,
``dense_connect_unbatched``, ``lift_dense_unbatched`` (``transpose`` and
``inverse``, each reduce op), ``DenseSRCPooling``'s conversions, the
``LaPooling`` pooler, ``PoolingClassifier`` with it (the dense post-pool
GCN on ``torch.matmul`` and on K3's plain version), and the port's
``ACCEPTS_DENSE_BATCH`` choice.

Leaders and slots are held equal exactly.  Values and gradients: 1e-5
of each output's or leaf's largest |value| (at least 1; f32 sums in other
orders); with K3 (bf16-rounded operands in both packages) 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.connect.base import dense_connect_unbatched as j_connect
from tgp_tpu.graph import DenseGraphBatch as JDense
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.lift.base import lift_dense_unbatched as j_lift
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.models.prepare import prepare_batch as j_prepare
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.reduce.base import reduce_dense_unbatched as j_reduce
from tgp_tpu.select.base import SelectOutput as JSO
from tgp_tpu.select.lapool import lapool_select as j_select
from tgp_tpu.select.lapool import shortest_path_weights as j_spw
from tgp_tpu.src import DenseSRCPooling as JDenseSRC
from tgp_tpu_torch import (DenseGraphBatch, GraphBatch, PoolingClassifier,
                           get_pooler, prepare_batch)
from tgp_tpu_torch.connect.base import dense_connect_unbatched
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.lift.base import lift_dense_unbatched
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops.kernels import bmm as K3
from tgp_tpu_torch.poolers import LaPooling
from tgp_tpu_torch.reduce.base import base_reduce, reduce_dense_unbatched
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.lapool import lapool_select, shortest_path_weights
from tgp_tpu_torch.src import DenseSRCPooling

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN = 6


def _graphs(seed, count=3, feat=F_IN, lo=6, hi=14, undirected=True):
    """Random graphs (undirected by default, as LaPool's leaders assume),
    a few isolated nodes among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        e = n + 2
        s, r = rng.integers(0, n - 2, e), rng.integers(0, n - 2, e)
        keep = s != r
        s, r = s[keep], r[keep]
        if undirected:
            s, r = np.concatenate([s, r]), np.concatenate([r, s])
        x = rng.normal(size=(n, feat)).astype(np.float32)
        w = rng.random(s.shape[0]).astype(np.float32) + 0.2
        out.append((x, np.stack([s, r]), w))
    return out


def _batches(graphs, sort=False):
    return (j_from(graphs, sort_edges=sort),
            t_from(graphs, sort_edges=sort, **CPU))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel=1e-5, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0,
                               err_msg=what)


def _soft_s(jb, seed):
    """A random soft assignment ``[N, K]``, zero on padding rows."""
    rng = np.random.default_rng(seed)
    s = rng.random((jb.num_nodes, jb.max_nodes)).astype(np.float32)
    s *= rng.random(s.shape) < 0.6
    return s * np.asarray(jb.node_mask)[:, None]


# ---------------------------------------------------------------------------
# the selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "shortest_path"])
def test_lapool_select_matches_jax(sp):
    """``S``, leaders, slots and ``v``; with ``sp`` the host weights of both
    packages first, then the regularized selection; then the gradient of
    ``S`` with respect to the features."""
    jb, tb = _batches(_graphs(1))
    ref0, got0 = j_select(jb), lapool_select(tb)
    for k in ("leader", "slot"):
        np.testing.assert_array_equal(_np(got0.extras[k]),
                                      _np(ref0.extras[k]), err_msg=k)
    _close(got0.extras["v"], ref0.extras["v"])
    assert np.asarray(ref0.extras["leader"]).any()
    jkw, tkw = {}, {}
    if sp:
        jw = j_spw(jb, ref0.extras["leader"], ref0.extras["slot"])
        tw = shortest_path_weights(tb, got0.extras["leader"],
                                   got0.extras["slot"])
        _close(tw, jw)
        assert np.asarray(jw).any()
        jkw = dict(shortest_path_reg=True, sp_weight=jw)
        tkw = dict(shortest_path_reg=True, sp_weight=tw)
    ref = j_select(jb, **jkw)
    x = tb.x.clone().requires_grad_(True)
    got = lapool_select(tb.replace(x=x), **tkw)
    _close(got.s, ref.s, what="S")
    _close(got.out_mask(), ref.out_mask(), what="out_mask")
    assert (got.num_clusters, got.max_clusters, got.num_graphs) == (
        ref.num_clusters, ref.max_clusters, ref.num_graphs)
    G = np.random.default_rng(2).normal(size=ref.s.shape).astype(np.float32)
    jg = jax.grad(lambda xx: (j_select(jb.replace(x=xx), **jkw).s * G)
                  .sum())(jb.x)
    (got.s * torch.tensor(G)).sum().backward()
    _close(x.grad, jg, what="dS/dx")


def test_lapool_select_needs_host_weights_for_the_regularizer():
    _, tb = _batches(_graphs(2))
    with pytest.raises(NotImplementedError, match="sp_weight"):
        lapool_select(tb, shortest_path_reg=True)


# ---------------------------------------------------------------------------
# reduce, connect, lift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("return_batched", [True, False])
def test_reduce_dense_unbatched_matches_jax(return_batched):
    jb, tb = _batches(_graphs(3))
    s = _soft_s(jb, 3)
    ts = torch.tensor(s, requires_grad=True)
    tx = tb.x.clone().requires_grad_(True)
    ref = j_reduce(jb.x, jnp.asarray(s), jb.node_graph, jb.num_graphs,
                   jb.node_mask, return_batched=return_batched)
    got = reduce_dense_unbatched(tx, ts, tb.node_graph, tb.num_graphs,
                                 tb.node_mask, return_batched,
                                 node_pos=tb.node_pos,
                                 max_nodes=tb.max_nodes)
    _close(got, ref)
    G = np.random.default_rng(4).normal(size=ref.shape).astype(np.float32)
    jgx, jgs = jax.grad(lambda x, s_: (j_reduce(
        x, s_, jb.node_graph, jb.num_graphs, jb.node_mask,
        return_batched=return_batched) * G).sum(), argnums=(0, 1))(
        jb.x, jnp.asarray(s))
    (got * torch.tensor(G)).sum().backward()
    _close(tx.grad, jgx, what="dx")
    # padding rows share a cell with a real node: their S rows are zero in
    # every producer, and their gradient is the masked one
    nm = np.asarray(jb.node_mask)[:, None]
    _close(ts.grad.numpy() * nm, np.asarray(jgs) * nm, what="ds")


def test_dense_connect_unbatched_matches_jax():
    jb, tb = _batches(_graphs(5))
    s = _soft_s(jb, 5)
    ts = torch.tensor(s, requires_grad=True)
    tw = tb.edge_weight.clone().requires_grad_(True)
    ref = j_connect(jb.senders, jb.receivers, jb.edge_weight,
                    jnp.asarray(s), jb.node_graph, jb.num_graphs,
                    jb.node_mask)
    got = dense_connect_unbatched(tb.senders, tb.receivers, tw, ts,
                                  tb.node_graph, tb.num_graphs, tb.node_mask,
                                  node_pos=tb.node_pos,
                                  max_nodes=tb.max_nodes)
    _close(got, ref)
    G = np.random.default_rng(6).normal(size=ref.shape).astype(np.float32)
    jgw, jgs = jax.grad(lambda w, s_: (j_connect(
        jb.senders, jb.receivers, w, s_, jb.node_graph, jb.num_graphs,
        jb.node_mask) * G).sum(), argnums=(0, 1))(jb.edge_weight,
                                                 jnp.asarray(s))
    (got * torch.tensor(G)).sum().backward()
    _close(tw.grad, jgw, what="dw")
    nm = np.asarray(jb.node_mask)[:, None]
    _close(ts.grad.numpy() * nm, np.asarray(jgs) * nm, what="ds")


def _unbatched_so(jb, tb, s, op):
    jso = JSO(s=jnp.asarray(s), node_graph=jb.node_graph,
              node_mask=jb.node_mask, num_clusters=jb.max_nodes,
              num_graphs=jb.num_graphs, max_clusters=jb.max_nodes,
              s_inv_op=op)
    tso = SelectOutput(assignment=torch.tensor(s), node_graph=tb.node_graph,
                       node_mask=tb.node_mask, node_pos=tb.node_pos,
                       max_nodes=tb.max_nodes, num_clusters=tb.max_nodes,
                       num_graphs=tb.num_graphs, max_clusters=tb.max_nodes,
                       s_inv_op=op)
    return jso, tso


@pytest.mark.parametrize("op", ["transpose", "inverse"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max"])
@pytest.mark.parametrize("flat", [False, True])
def test_lift_dense_unbatched_matches_jax(op, reduce_op, flat):
    """A LaPool assignment (leaders one-hot, softmax rows, a full column
    rank per graph for the inverse)."""
    jb, tb = _batches(_graphs(7))
    s = np.asarray(j_select(jb).s)
    jso, tso = _unbatched_so(jb, tb, s, op)
    xp = np.random.default_rng(8).normal(
        size=(jb.num_graphs, jb.max_nodes, 5)).astype(np.float32)
    if flat:
        xp = xp.reshape(-1, 5)
    ref = j_lift(jnp.asarray(xp), jso, "precomputed", reduce_op)
    tx = torch.tensor(xp, requires_grad=True)
    got = lift_dense_unbatched(tx, tso, "precomputed", reduce_op)
    _close(got, ref, rel=1e-4 if op == "inverse" else 1e-5)
    G = np.random.default_rng(9).normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda x: (j_lift(x, jso, "precomputed", reduce_op) * G)
                  .sum())(jnp.asarray(xp))
    (got * torch.tensor(G)).sum().backward()
    _close(tx.grad, jg, rel=1e-4 if op == "inverse" else 1e-5, what="dx")


def test_dense_src_conversions_match_jax():
    jb, tb = _batches(_graphs(10))
    for transpose in (False, True):
        ref = JDenseSRC.ensure_dense(jb, transpose)
        got = DenseSRCPooling.ensure_dense(tb, transpose)
        for f in ("x", "adj", "mask"):
            _close(getattr(got, f), getattr(ref, f), what=f)
        assert DenseSRCPooling.ensure_dense(got) is got
    ref_sp = JDenseSRC.finalize_sparse_output(ref)
    got_sp = DenseSRCPooling.finalize_sparse_output(got)
    for f in ("x", "senders", "receivers", "edge_weight", "edge_mask",
              "node_mask", "node_graph", "node_pos"):
        _close(getattr(got_sp, f), getattr(ref_sp, f), what=f)


# ---------------------------------------------------------------------------
# the pooler and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(shortest_path_reg=True),
                                dict(degree_norm=False,
                                     edge_weight_norm=True),
                                dict(sparse_output=True),
                                dict(s_inv_op="inverse")])
def test_lapool_pooler_matches_jax(kw):
    jb, tb = _batches(_graphs(11))
    jpool = j_get("lap", **kw)
    tpool = get_pooler("lap", **kw, **CPU)
    assert isinstance(tpool, LaPooling)
    jout, tout = jpool.apply({}, jb), tpool(tb)
    _close(tout.so.s, jout.so.s, what="S")
    if kw.get("sparse_output"):
        for f in ("x", "edge_weight", "edge_mask", "node_mask",
                  "senders", "receivers"):
            _close(getattr(tout.graph, f), getattr(jout.graph, f), what=f)
        return
    for f in ("x", "adj", "mask"):
        _close(getattr(tout.dense, f), getattr(jout.dense, f), what=f)
    # the lift of the pooled features back to the nodes
    jl = jpool.apply({}, jb, so=jout.so, lifting=True, x=jout.dense.x)
    tl = tpool(tb, so=tout.so, lifting=True, x=tout.dense.x)
    _close(tl, jl, rel=1e-4 if kw.get("s_inv_op") else 1e-5)
    _close(base_reduce(tb.x, tout.so), tout.dense.x)


def test_lapool_keeps_the_batch_sparse_where_jax_fails():
    """JAX's LaPooling accepts a dense batch by its flag, which
    ``prepare_batch`` then hands it, and fails reading the edge list; the
    port's flag is False, so its ``prepare_batch`` keeps the batch
    sparse."""
    jb, tb = _batches(_graphs(12, count=4, lo=12, hi=13))
    jpool = j_get("lap")
    dense = j_prepare(jb, pooler=type(jpool))
    assert isinstance(dense, JDense)
    with pytest.raises(AttributeError):
        jpool.apply({}, dense)
    assert LaPooling.ACCEPTS_DENSE_BATCH is False
    assert issubclass(LaPooling, DenseSRCPooling)
    for pooler in (LaPooling, get_pooler("lap")):
        got = prepare_batch(tb, pooler=pooler, normalize=True)
        assert isinstance(got, GraphBatch) and got is tb
    with pytest.raises(ValueError, match="ACCEPTS_DENSE_BATCH"):
        prepare_batch(tb, pooler=LaPooling, densify=True)


def _model_pair(jb, use_kernel):
    jm = JPC(pooler=j_get("lap"), num_classes=3, hidden=8,
             use_pallas=use_kernel)
    leaves, tree = jax.tree.flatten(jm.init(jax.random.key(7), jb))
    rng = np.random.default_rng(14)
    params = jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                    .astype(np.float32)) for v in leaves])
    tm = PoolingClassifier(get_pooler("lap", **CPU), num_classes=3, hidden=8,
                           in_channels=F_IN, use_kernel=use_kernel, **CPU)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("use_kernel", [None, True], ids=["matmul", "k3"])
def test_lapool_classifier_two_steps_match_jax(use_kernel):
    """Logits, loss and every gradient leaf at step one and, after the same
    optax Adam update, at step two; the post-pool GCN runs on the dense
    pooled graph (``use_kernel=True``: K3's plain version here,
    ``bmm_pallas`` in interpret mode in JAX)."""
    jb, tb = _batches(_graphs(13, count=4))
    jm, params, tm = _model_pair(jb, use_kernel)
    rel = 2e-2 if use_kernel else 1e-5
    y = np.array([0, 1, 2, 1], np.int32)
    tx = optax.adam(1e-2)
    opt = tx.init(params)

    def loss_fn(p):
        logits = jm.apply(p, jb)[0]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    for step in range(2):
        (jl, jlog), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
        tm.load_state_dict(params_from_flax(params))
        tm.zero_grad()
        logits, out = tm(tb)
        assert out.dense is not None and out.graph is None
        loss = torch.nn.functional.cross_entropy(logits,
                                                 torch.tensor(y).long())
        loss.backward()
        _close(logits, jlog, rel, f"logits, step {step + 1}")
        _close(loss, jl, rel, f"loss, step {step + 1}")
        want = params_from_flax(jax.tree.map(np.asarray, jg))
        got = {k: p.grad for k, p in tm.named_parameters()}
        assert set(got) == set(want)
        for k, v in want.items():
            _close(got[k], v, rel, f"{k}, step {step + 1}")
        upd, opt = tx.update(jg, opt)
        params = optax.apply_updates(params, upd)


def test_lapool_classifier_runs_k3_three_times_a_step(monkeypatch):
    """The count ``chip_smoke.py``'s [train_lap] asserts: the post-pool
    GCN's adjacency product forward, and backward both operands' products
    (the pooled adjacency depends on the features through ``S``); the
    sparse side launches nothing on unsorted edges."""
    _, tb = _batches(_graphs(15, count=2))
    tm = PoolingClassifier(get_pooler("lap", **CPU), num_classes=3,
                           hidden=8, in_channels=F_IN, use_kernel=True,
                           **CPU)
    calls = []
    real = K3._product

    def spy(a, b, trans_a, trans_b):
        calls.append((trans_a, trans_b))
        return real(a, b, trans_a, trans_b)

    monkeypatch.setattr(K3, "_product", spy)
    logits, out = tm(tb)
    assert calls == [(False, False)]
    assert isinstance(out.dense, DenseGraphBatch)
    torch.nn.functional.cross_entropy(logits,
                                      torch.tensor([1, 2]).long()).backward()
    assert sorted(calls) == [(False, False), (False, True), (True, False)]
