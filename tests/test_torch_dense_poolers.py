"""The dense soft-cluster poolers of the port (MinCut, DiffPool, DMoN,
HOSC, JustBalance, AsymCheegerCut; batched and ``_u``) against the JAX
package on the same numpy graphs and converted parameters: pooled
features, adjacency and mask, every loss, and the gradients of the
parameters and the input features; batched against unbatched in the port
(the contract of ``tests/poolers/test_dense_batched_vs_unbatched.py``,
5e-4); the batched dense reduce, connect and lift against JAX's; and
``PoolingClassifier`` with MinCut on ``torch.matmul`` and on K3's plain
version.

Tolerances: 1e-5 of each output's or leaf's largest |value| (at least 1;
f32 sums in other orders); with K3 (bf16-rounded operands in both
packages) 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.utils_graphs import erdos_renyi_graph
from tgp_tpu.connect.base import dense_connect as j_connect
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.lift.base import lift_dense_batched as j_lift
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.models.prepare import prepare_batch as j_prepare
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.reduce.base import reduce_dense_batched as j_reduce
from tgp_tpu.select.base import SelectOutput as JSO
from tgp_tpu_torch import (DenseGraphBatch, GraphBatch, PoolingClassifier,
                           get_pooler, prepare_batch)
from tgp_tpu_torch.connect.base import dense_connect
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.lift.base import base_lift, lift_dense_batched
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops.kernels import bmm as K3
from tgp_tpu_torch.poolers import DenseClusterPooling
from tgp_tpu_torch.reduce.base import base_reduce, reduce_dense_batched
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.mlp import MLPSelect

torch.set_num_threads(1)
CPU = dict(device="cpu")
ALIASES = ["mincut", "diff", "dmon", "hosc", "jb", "acc"]
F_IN, K = 7, 5


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


def _graphs(sizes=(9, 6, 12), seed=3):
    out = []
    for i, n in enumerate(sizes):
        x, ei = erdos_renyi_graph(n, p=0.4, num_features=F_IN, seed=seed + i)
        w = np.random.default_rng(seed + 100 + i).uniform(
            0.5, 2.0, ei.shape[1]).astype(np.float32)
        out.append((x, ei, w))
    return out


@pytest.fixture(scope="module")
def batches():
    """The sparse batch (padded) and its dense form, in both packages."""
    graphs = _graphs()
    kw = dict(pad_nodes=32, pad_edges=160)
    jb, tb = j_from(graphs, **kw), t_from(graphs, **kw, **CPU)
    jd = j_prepare(jb, densify=True)
    td = prepare_batch(tb, densify=True)
    return dict(jb=jb, tb=tb, jd=jd, td=td)


@pytest.fixture(scope="module")
def jax_params(batches):
    """One flax init per alias (both modes share the selector's shapes),
    perturbed so no parameter is at its initial value."""
    out = {}
    for i, alias in enumerate(ALIASES):
        p = j_get(alias, in_channels=F_IN, k=K).init(jax.random.key(i),
                                                     batches["jd"])
        leaves, tree = jax.tree.flatten(p)
        rng = np.random.default_rng(i)
        out[alias] = jax.tree.unflatten(tree, [
            jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                        .astype(np.float32)) for v in leaves])
    return out


def _carry(tree):
    """A flax pooler tree onto the port's pooler's parameter names."""
    sd = params_from_flax({"pooler": tree["params"]})
    return {k[len("pooler."):]: v for k, v in sd.items()}


def _pair(alias, batched, jax_params, **kw):
    jp = j_get(alias, in_channels=F_IN, k=K, batched=batched, **kw)
    tp = get_pooler(alias, in_channels=F_IN, k=K, batched=batched, **kw,
                    **CPU)
    assert isinstance(tp, DenseClusterPooling) and tp.batched == batched
    tp.load_state_dict(_carry(jax_params[alias]))
    return jp, tp


def _inputs(batches, batched):
    return ((batches["jd"], batches["td"]) if batched
            else (batches["jb"], batches["tb"]))


def _probe(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "u"])
@pytest.mark.parametrize("alias", ALIASES)
def test_dense_pooler_matches_jax(alias, batched, batches, jax_params):
    """Pooled x, adjacency and mask, every loss, and the gradients of Σ
    losses + ⟨G, x'⟩ + ⟨H, A'⟩ for the selector's parameters and the
    input features."""
    jp, tp = _pair(alias, batched, jax_params)
    jin, tin = _inputs(batches, batched)
    p = jax_params[alias]
    jout = jp.apply(p, jin)
    G = _probe(jout.dense.x.shape, 1)
    H = _probe(jout.dense.adj.shape, 2)

    def j_obj(q, x):
        o = jp.apply(q, jin.replace(x=x))
        return (o.loss_sum() + jnp.sum(o.dense.x * G)
                + jnp.sum(o.dense.adj * H))

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(p, jin.x)
    x = tin.x.clone().requires_grad_(True)
    tout = tp(tin.replace(x=x))
    for f in ("x", "adj"):
        _close(getattr(tout.dense, f), getattr(jout.dense, f), what=f)
    np.testing.assert_array_equal(_np(tout.dense.mask),
                                  _np(jout.dense.mask))
    assert set(tout.loss) == set(jout.loss)
    for name, v in jout.loss.items():
        _close(tout.loss[name], v, what=name)
    (tout.loss_sum() + (tout.dense.x * torch.tensor(G)).sum()
     + (tout.dense.adj * torch.tensor(H)).sum()).backward()
    _close(x.grad, jg_x, what="d x")
    got = dict(tp.named_parameters())
    for k, v in _carry(jg_p).items():
        assert torch.isfinite(got[k].grad).all(), k
        _close(got[k].grad, v, what=f"d {k}")


@pytest.mark.parametrize("alias", ALIASES)
def test_batched_equals_unbatched(alias, batches, jax_params):
    """The port's two modes on the same graphs and weights: losses,
    pooled features and pooled adjacency within 5e-4."""
    _, tb_pool = _pair(alias, True, jax_params)
    _, tu_pool = _pair(alias, False, jax_params)
    ob, ou = tb_pool(batches["td"]), tu_pool(batches["tb"])
    assert set(ob.loss) == set(ou.loss)
    for name in ob.loss:
        np.testing.assert_allclose(_np(ob.loss[name]), _np(ou.loss[name]),
                                   rtol=5e-4, atol=5e-4, err_msg=name)
    for f in ("x", "adj", "mask"):
        np.testing.assert_allclose(_np(getattr(ob.dense, f)),
                                   _np(getattr(ou.dense, f)),
                                   rtol=5e-4, atol=5e-4, err_msg=f)


@pytest.mark.parametrize("alias", ALIASES)
def test_sparse_output_and_lift_match_jax(alias, batches, jax_params):
    """``sparse_output`` hands back JAX's block-diagonal batch; lifting the
    pooled features through the selection gives JAX's nodes."""
    jp, tp = _pair(alias, True, jax_params, sparse_output=True)
    p = jax_params[alias]
    jout, tout = jp.apply(p, batches["jd"]), tp(batches["td"])
    assert isinstance(tout.graph, GraphBatch) and tout.dense is None
    for f in ("x", "edge_weight"):
        _close(getattr(tout.graph, f), getattr(jout.graph, f), what=f)
    for f in ("senders", "receivers", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(_np(getattr(tout.graph, f)),
                                      _np(getattr(jout.graph, f)), f)
    xp = _probe((batches["jd"].num_graphs, K, 3), 4)
    jl = jp.apply(p, batches["jd"], so=jout.so, lifting=True,
                  x=jnp.asarray(xp))
    tl = tp(batches["td"], so=tout.so, lifting=True, x=torch.tensor(xp))
    _close(tl, jl, what="lift")


def _soft_so(batches, seed, zeros=True):
    """A random batched soft assignment ``[B, N, K]`` (some structural
    zeros), zero on padded rows, as a select output of both packages."""
    jd = batches["jd"]
    rng = np.random.default_rng(seed)
    s = rng.random((jd.num_graphs, jd.x.shape[1], K)).astype(np.float32)
    if zeros:
        s *= rng.random(s.shape) < 0.6
    s *= np.asarray(jd.mask)[..., None]
    mask = np.asarray(jd.mask)
    jso = JSO(s=jnp.asarray(s), in_mask=jnp.asarray(mask), num_clusters=K,
              num_graphs=jd.num_graphs, max_clusters=K)
    tso = SelectOutput(batched_s=torch.tensor(s), in_mask=torch.tensor(mask),
                       num_clusters=K, num_graphs=jd.num_graphs,
                       max_clusters=K)
    return jso, tso


def test_dense_reduce_and_connect_match_jax(batches):
    jso, tso = _soft_so(batches, 5)
    jd, td = batches["jd"], batches["td"]
    assert tso.is_dense and tso.s is tso.batched_s
    _close(reduce_dense_batched(td.x, tso.s), j_reduce(jd.x, jso.s))
    _close(base_reduce(td.x, tso), j_reduce(jd.x, jso.s))
    _close(dense_connect(td.adj, tso.s), j_connect(jd.adj, jso.s))
    np.testing.assert_array_equal(_np(tso.out_mask()), _np(jso.out_mask()))


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max"])
@pytest.mark.parametrize("matrix_op", ["transpose", "inverse"])
def test_dense_lift_matches_jax(batches, matrix_op, reduce_op):
    jso, tso = _soft_so(batches, 6)
    xp = _probe((batches["jd"].num_graphs, K, 4), 7)
    ref = j_lift(jnp.asarray(xp), jso, matrix_op, reduce_op)
    _close(lift_dense_batched(torch.tensor(xp), tso, matrix_op, reduce_op),
           ref, what=f"{matrix_op} {reduce_op}")
    _close(base_lift(torch.tensor(xp), tso, matrix_op, reduce_op), ref)


def test_mlp_select_hidden_layers_and_dropout(batches):
    """A hidden-layer MLP from the flax tree; dropout draws from its
    generator in training mode only, the same draws for the same seed."""
    jp = j_get("mincut", in_channels=[F_IN, 6], k=K)
    p = jp.init(jax.random.key(9), batches["jd"])
    tp = get_pooler("mincut", in_channels=[F_IN, 6], k=K, **CPU)
    tp.load_state_dict(_carry(p))
    assert len(tp.selector.mlp.layers) == 2
    _close(tp(batches["td"]).dense.x, jp.apply(p, batches["jd"]).dense.x)

    def drawn(seed):
        return MLPSelect([F_IN, 6], K, dropout=0.5,
                         generator=torch.Generator().manual_seed(0),
                         dropout_generator=torch.Generator().manual_seed(seed),
                         **CPU)

    a, b, c = drawn(1), drawn(1), drawn(2)
    sa, sb, sc = (m(batches["td"]).s for m in (a, b, c))
    assert torch.equal(sa, sb) and not torch.equal(sa, sc)
    a.eval()
    c.eval()
    assert torch.equal(a(batches["td"]).s, c(batches["td"]).s)


def _model_pair(alias, jin, use_kernel):
    jm = JPC(pooler=j_get(alias, in_channels=8, k=K), num_classes=3,
             hidden=8, use_pallas=use_kernel)
    leaves, tree = jax.tree.flatten(jm.init(jax.random.key(7), jin))
    rng = np.random.default_rng(14)
    params = jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                    .astype(np.float32)) for v in leaves])
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, k=K, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN,
                           use_kernel=use_kernel, **CPU)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("use_kernel", [None, True], ids=["matmul", "k3"])
@pytest.mark.parametrize("alias", ["mincut", "mincut_u"])
def test_mincut_classifier_two_steps_match_jax(alias, use_kernel, batches):
    """Logits, CE + the pooler's losses, and every gradient leaf at step
    one and, after the same optax Adam update, at step two; the dense GCN
    products on ``torch.matmul`` or K3's plain version (``bmm_pallas`` in
    interpret mode in JAX)."""
    batched = alias == "mincut"
    jin, tin = _inputs(batches, batched)
    jm, params, tm = _model_pair(alias, jin, use_kernel)
    rel = 2e-2 if use_kernel else 1e-5
    y = np.array([0, 1, 2], np.int32)
    tx = optax.adam(1e-2)
    opt = tx.init(params)

    def loss_fn(p):
        logits, out = jm.apply(p, jin)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return ce + out.loss_sum(), logits

    for step in range(2):
        (jl, jlog), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
        tm.load_state_dict(params_from_flax(params))
        tm.zero_grad()
        logits, out = tm(tin)
        assert isinstance(out.dense, DenseGraphBatch)
        loss = (torch.nn.functional.cross_entropy(logits,
                                                  torch.tensor(y).long())
                + out.loss_sum())
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


@pytest.mark.parametrize("alias,want", [
    ("mincut", [(False, False)] * 2 + [(False, True), (True, False),
                                       (True, False)]),
    ("mincut_u", [(False, False), (False, True), (True, False)])])
def test_mincut_classifier_k3_products_a_step(alias, want, batches,
                                              monkeypatch):
    """The counts ``chip_smoke.py``'s [train_mincut] and [train_mincut_u]
    assert: batched, the pre- and post-pool GCN products forward (2), and
    backward the pre-pool layer's feature gradient and both of the
    post-pool layer's (its adjacency depends on the features through
    ``S``): 5 a step; ``_u``, the sparse pre-pool layer launches nothing
    and the dense post-pool layer 3."""
    _, tin = _inputs(batches, alias == "mincut")
    tm = PoolingClassifier(get_pooler(alias, in_channels=8, k=K, **CPU),
                           num_classes=3, hidden=8, in_channels=F_IN,
                           use_kernel=True, **CPU)
    calls = []
    real = K3._product

    def spy(a, b, trans_a, trans_b):
        calls.append((trans_a, trans_b))
        return real(a, b, trans_a, trans_b)

    monkeypatch.setattr(K3, "_product", spy)
    logits, out = tm(tin)
    (torch.nn.functional.cross_entropy(logits, torch.tensor([0, 1, 2]))
     + out.loss_sum()).backward()
    assert sorted(calls) == sorted(want)


def test_empty_padded_graph_keeps_gradients_finite(batches, jax_params):
    """A dense batch whose second graph has no valid node: every pooler's
    losses are finite, and so is every gradient of their sum."""
    td = batches["td"]
    mask = td.mask.clone()
    mask[1] = False
    dense = DenseGraphBatch(x=td.x * mask[..., None],
                            adj=td.adj * mask[:, :, None] * mask[:, None, :],
                            mask=mask)
    for alias in ALIASES:
        _, tp = _pair(alias, True, jax_params)
        out = tp(dense)
        loss = out.loss_sum()
        assert torch.isfinite(loss), alias
        loss.backward()
        for k, prm in tp.named_parameters():
            assert torch.isfinite(prm.grad).all(), (alias, k)


def test_dense_family_routes_like_jax(batches):
    """``prepare_batch`` densifies for a batched instance and keeps the
    batch sparse for a ``_u`` one (it reads ``batched``), as JAX's does."""
    for alias, dense in (("mincut", True), ("mincut_u", False)):
        tp = get_pooler(alias, in_channels=F_IN, k=K, **CPU)
        jp = j_get(alias, in_channels=F_IN, k=K)
        got = prepare_batch(batches["tb"], pooler=tp)
        ref = j_prepare(batches["jb"], pooler=jp)
        assert isinstance(got, DenseGraphBatch) == dense
        assert (type(ref).__name__ == "DenseGraphBatch") == dense
