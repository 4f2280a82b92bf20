"""The port's dense regime against ``tgp_tpu`` on the same numpy inputs:
``gcn_norm_dense``, the dense ``GCNConv`` (matmul and K3 routes), the
dense top-k selection and pooling, ``prepare_batch``,
``DenseTopkClassifier`` and the dense ``PoolingClassifier``, and training
steps with Adam against optax.

JAX's ``use_pallas=True`` runs ``bmm_pallas`` in interpret mode; the
port's ``use_kernel=True`` runs ``bmm_plain`` on CPU tensors.  Tolerances:
f32 algorithm checks 1e-5 (layers) or 1e-4 of the logit scale; bf16 2e-2
of the output scale (bf16 rounding at places the two frameworks order
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.graph import DenseGraphBatch as JDense
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.graph import to_dense as j_to_dense
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.models.fast_dense import DenseTopkClassifier as JDTC
from tgp_tpu.models.fast_dense import gather_rows as j_gather_rows
from tgp_tpu.models.prepare import prepare_batch as j_prepare
from tgp_tpu.mp.gcn import GCNConv as JGCN
from tgp_tpu.mp.gcn import gcn_norm_dense as j_norm
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.select.topk import _topk_values_vjp as j_topk_values
from tgp_tpu.select.topk import dense_topk_indices as j_indices
from tgp_tpu_torch import (DenseGraphBatch, DenseTopkClassifier,
                           PoolingClassifier, from_graphs, gcn_norm_dense,
                           get_pooler, prepare_batch, to_dense)
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.poolers.topk import gather_rows
from tgp_tpu_torch.select.topk import _TopkValues, dense_topk_indices

torch.set_num_threads(1)
F_IN, HIDDEN, MAX_NODES = 12, 16, 32


def _graphs(seed, count=8, n_range=(16, 33), feat=F_IN, p=0.2,
            weighted=False, signed=False):
    """Loop-free ER graphs of 16–32 nodes, one numpy rng."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        upper = np.triu(rng.random((n, n)) < p, 1)
        s, r = np.nonzero(upper | upper.T)
        x = rng.normal(size=(n, feat)).astype(np.float32)
        g = (x, np.stack([s, r]))
        if weighted:
            w = rng.uniform(0.5, 2.0, s.shape[0]).astype(np.float32)
            if signed:
                w *= rng.choice([-1.0, 1.0], s.shape[0]).astype(np.float32)
            g = g + (w,)
        out.append(g)
    return out


def _dense_pair(graphs, max_nodes=MAX_NODES):
    jd = j_to_dense(j_from(graphs, max_nodes=max_nodes))
    td = to_dense(from_graphs(graphs, max_nodes=max_nodes, device="cpu"))
    return jd, td


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# gcn_norm_dense and the dense GCNConv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adj_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_norm_dense_matches_jax(add_self_loops, adj_dtype):
    """Abs degrees (signed weights), self-loops on valid nodes only."""
    jd, td = _dense_pair(_graphs(1, weighted=True, signed=True))
    ref = j_norm(jd, add_self_loops=add_self_loops,
                 adj_dtype=None if adj_dtype is None else jnp.bfloat16)
    got = gcn_norm_dense(td, add_self_loops=add_self_loops,
                         adj_dtype=None if adj_dtype is None
                         else torch.bfloat16)
    assert str(got.adj.dtype).split(".")[-1] == (adj_dtype or "float32")
    # f32 to rounding; bf16 to one ulp (2⁻⁷ relative) of the largest entry
    _close(got.adj, ref.adj, 1e-6 if adj_dtype is None else 2 ** -7)
    assert np.isfinite(_np(got.adj)).all()
    # padding rows and columns stay zero
    pad = ~td.mask.numpy()
    assert not _np(got.adj)[pad].any()


def _conv_pair(jd, out=8, jax_kw=None, **kw):
    jconv = JGCN(out, **(jax_kw or {}))
    p = jconv.init(jax.random.key(0), jd, jd.x)
    p = jax.tree.map(lambda a: a + 0.1, p)  # a nonzero bias
    tconv = GCNConv(jd.x.shape[-1], out, device="cpu", **kw)
    tconv.load_state_dict({
        "lin.weight": torch.tensor(
            np.asarray(p["params"]["Dense_0"]["kernel"]).T.copy()),
        **({"bias": torch.tensor(np.asarray(p["params"]["bias"]))}
           if "bias" in p["params"] else {})})
    return jconv.apply(p, jd, jd.x), tconv


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("normalize,mask_output", [(True, True),
                                                   (False, False)])
def test_gcn_dense_matches_jax(normalize, mask_output, kernel, dtype,
                               use_bias):
    """Both routes, cast for cast: the kernel route gives f32 before the
    bias; the matmul route gives h's dtype (bf16 under dtype=bf16); the f32
    bias promotes either to f32."""
    jd, td = _dense_pair(_graphs(2, weighted=True))
    if not normalize:
        jd, td = j_norm(jd), gcn_norm_dense(td)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    ref, tconv = _conv_pair(
        jd, jax_kw=dict(use_pallas=kernel, normalize=normalize,
                        mask_output=mask_output, dtype=jdt,
                        use_bias=use_bias),
        use_kernel=kernel, normalize=normalize, mask_output=mask_output,
        dtype=tdt, use_bias=use_bias)
    got = tconv(td)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    # bf16 rounding of operands whose f32 values differ in the last bits
    # (XLA's and torch's sum orders) may land one ulp apart: ~1e-4 seen
    f32_all = dtype is None and not kernel
    _close(got, ref, 1e-5 if f32_all else 2e-3)
    if mask_output:
        assert not _np(got - (tconv.bias if use_bias else 0))[
            ~td.mask.numpy()].any()


def test_gcn_dense_kernel_route_holds_to_bmm_rounding():
    """f32 features through the kernel route: operands rounded to bf16,
    so the layer agrees with JAX's ``use_pallas=True`` far closer than
    with the f32 product (only the f32 → bf16 rounding of nearly equal
    values can differ)."""
    jd, td = _dense_pair(_graphs(3))
    ref, tconv = _conv_pair(jd, jax_kw=dict(use_pallas=True),
                            use_kernel=True)
    _close(tconv(td), ref, 2e-3)
    ref32, _ = _conv_pair(jd, jax_kw=dict(use_pallas=False),
                          use_kernel=False)
    _close(tconv(td), ref32, 1e-2)  # bf16 operands vs the f32 product


def test_gcn_dense_f32_features_through_bf16_adjacency():
    """A bf16 adjacency does not truncate f32 features on the matmul
    route (``gcn.py:207-214``)."""
    jd, td = _dense_pair(_graphs(4))
    jd, td = j_norm(jd, adj_dtype=jnp.bfloat16), gcn_norm_dense(
        td, adj_dtype=torch.bfloat16)
    ref, tconv = _conv_pair(jd, jax_kw=dict(normalize=False),
                            normalize=False)
    got = tconv(td)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# dense top-k selection
# ---------------------------------------------------------------------------


def _tied_scores(seed, B=6, N=20):
    """Scores rounded to 0.25 (many ties), a ragged mask, an empty graph
    and a graph with one node."""
    rng = np.random.default_rng(seed)
    score = (np.round(rng.normal(size=(B, N)) * 4) / 4).astype(np.float32)
    n_valid = rng.integers(3, N + 1, B)
    n_valid[1], n_valid[2] = 0, 1
    mask = np.arange(N)[None, :] < n_valid[:, None]
    return score, mask


@pytest.mark.parametrize("ratio,min_score", [
    (0.5, None), (0.25, None), (3, None), (100, None), (0.9, None),
    (0.5, 0.1), (0.5, 0.5)])
def test_dense_topk_indices_matches_jax_with_ties(ratio, min_score):
    """Ties (rounded scores, equal padding values) break toward the lower
    index in both; ``ratio`` may ask for more nodes than a graph has."""
    score, mask = _tied_scores(5)
    if min_score is not None:  # PyG semantics on per-graph softmaxed scores
        score = np.asarray(jax.nn.softmax(
            jnp.where(mask, score, jnp.finfo(jnp.float32).min), -1))
    ref = j_indices(jnp.asarray(score), jnp.asarray(mask), ratio, min_score)
    got = dense_topk_indices(torch.tensor(score), torch.tensor(mask), ratio,
                             min_score)
    for g, r, name in zip(got, ref, ("idx", "slot_mask", "gate")):
        np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)
    assert not got[1][1].any()  # the empty graph keeps no slot


def test_dense_topk_gate_gradient_matches_jax():
    score, mask = _tied_scores(6)
    w = np.random.default_rng(7).normal(size=(6, 10)).astype(np.float32)

    def jloss(s):
        _, _, gate = j_indices(s, jnp.asarray(mask), 0.5)
        return (gate * jnp.asarray(w)).sum()

    ref = jax.grad(jloss)(jnp.asarray(score))
    ts = torch.tensor(score, requires_grad=True)
    _, _, gate = dense_topk_indices(ts, torch.tensor(mask), 0.5)
    (gate * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(_np(ts.grad), _np(ref))


def test_topk_values_function_matches_jax_vjp():
    """Forward returns the values as they are; backward is the one-hot
    contraction into ``ranked``, a zero cotangent for the values."""
    rng = np.random.default_rng(8)
    ranked = rng.normal(size=(3, 9)).astype(np.float32)
    idx = np.argsort(-ranked, axis=1)[:, :4].astype(np.int32)
    top = np.take_along_axis(ranked, idx, 1)
    g = rng.normal(size=(3, 4)).astype(np.float32)
    out, vjp = jax.vjp(j_topk_values, jnp.asarray(ranked), jnp.asarray(idx),
                       jnp.asarray(top))
    jr, _, jt = vjp(jnp.asarray(g))
    tr = torch.tensor(ranked, requires_grad=True)
    tt = torch.tensor(top, requires_grad=True)
    got = _TopkValues.apply(tr, torch.tensor(idx).long(), tt)
    np.testing.assert_array_equal(_np(got), _np(out))
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(_np(tr.grad), _np(jr))
    np.testing.assert_array_equal(_np(tt.grad), _np(jt))


def test_gather_rows_values_and_gradient_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 10, 5)).astype(np.float32)
    idx = np.stack([rng.permutation(10)[:6] for _ in range(3)])
    g = rng.normal(size=(3, 6, 5)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: j_gather_rows(a, jnp.asarray(idx)),
                       jnp.asarray(x))
    (jx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    got = gather_rows(tx, torch.tensor(idx))
    np.testing.assert_array_equal(_np(got), _np(out))
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(_np(tx.grad), _np(jx))


# ---------------------------------------------------------------------------
# TopkPooling's dense branch (the JAX cases of tests/test_dense_dispatch.py)
# ---------------------------------------------------------------------------


def _dense_pool_pair(seed, feat, pool_impl="auto", weighted=True, **kw):
    graphs = _graphs(seed, count=3, n_range=(6, 13), feat=feat,
                     weighted=weighted, p=0.4)
    jd, td = _dense_pair(graphs, max_nodes=12)
    jp = j_get("topk", in_channels=feat, **kw)
    params = jp.init(jax.random.key(seed), jd)
    tp = get_pooler("topk", in_channels=feat, device="cpu", **kw)
    tp.selector.weight.data = torch.tensor(
        np.asarray(params["params"]["selector"]["weight"]))
    ref = jp.apply(params, jd, pool_impl=pool_impl)
    return ref, tp(td, pool_impl=pool_impl), td


def _assert_pooled_equal(got, ref):
    assert got.graph is None and got.dense is not None
    np.testing.assert_array_equal(got.dense.mask.numpy(),
                                  np.asarray(ref.dense.mask))
    for f in ("x", "adj"):
        np.testing.assert_allclose(_np(getattr(got.dense, f)),
                                   _np(getattr(ref.dense, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for f in ("idx", "slot_mask", "gate"):
        np.testing.assert_allclose(_np(got.so.extras[f]),
                                   _np(ref.so.extras[f]), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(_np(got.so.s), _np(ref.so.s), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got.so.out_mask().numpy(),
                                  np.asarray(ref.so.out_mask()))
    assert got.so.is_dense and got.so.s.dim() == 3
    assert not got.so.is_sparse
    assert got.so.max_clusters == ref.so.max_clusters
    assert got.so.num_clusters == ref.so.num_clusters


@pytest.mark.parametrize("ratio", [0.5, 0.25, 3])
@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_topk_dense_branch_matches_jax(ratio, impl):
    ref, got, _ = _dense_pool_pair(4, 6, impl, ratio=ratio, multiplier=1.5)
    _assert_pooled_equal(got, ref)
    assert got.x is got.dense.x and got.mask is got.dense.mask
    assert not got.loss and float(got.loss_sum()) == 0.0


def test_topk_dense_branch_min_score_matches_jax():
    ref, got, _ = _dense_pool_pair(7, 5, weighted=False, min_score=0.08)
    _assert_pooled_equal(got, ref)


@pytest.mark.parametrize("flags", [
    dict(remove_self_loops=False), dict(degree_norm=True),
    dict(edge_weight_norm=True)], ids=["loops", "degree", "weight"])
def test_topk_dense_branch_postprocess_flags_match_jax(flags):
    ref, got, _ = _dense_pool_pair(9, 4, ratio=0.5, **flags)
    _assert_pooled_equal(got, ref)


def test_topk_dense_selection_s_and_negative_gates():
    """``sᵀ X`` is the pooled features (the generic dense reduce); with
    all scores negative the gates are negative and the slots still valid
    (``out_mask`` comes from the slot mask, not from ``s``)."""
    _, got, td = _dense_pool_pair(11, 4, ratio=0.5)
    x_generic = torch.einsum("bnk,bnf->bkf", got.so.s, td.x)
    np.testing.assert_allclose(_np(x_generic), _np(got.dense.x), atol=1e-6)
    x = torch.tensor([[[-5.0], [-3.0], [-1.0], [-2.0]]])
    dense = DenseGraphBatch(x=x, adj=1 - torch.eye(4)[None],
                            mask=torch.ones(1, 4, dtype=torch.bool))
    out = get_pooler("topk", in_channels=1, ratio=0.5, device="cpu")(dense)
    assert int(out.dense.mask.sum()) == 2
    assert (out.so.extras["gate"][0, :2] < 0).all()
    np.testing.assert_array_equal(out.so.out_mask().numpy(),
                                  out.dense.mask.numpy())


# ---------------------------------------------------------------------------
# prepare_batch
# ---------------------------------------------------------------------------


class _SparseOnly(torch.nn.Module):
    ACCEPTS_DENSE_BATCH = False


class _Unbatched(torch.nn.Module):
    ACCEPTS_DENSE_BATCH = True
    batched = False


def test_prepare_batch_routing_and_capability_gate():
    graphs = _graphs(12, count=2, n_range=(5, 7), feat=4)
    b = from_graphs(graphs, device="cpu")
    pooler = get_pooler("topk", in_channels=4, device="cpu")
    assert prepare_batch(b) is b  # no pooler: auto never densifies
    assert isinstance(prepare_batch(b, pooler=pooler), DenseGraphBatch)
    assert isinstance(prepare_batch(b, pooler=type(pooler)),
                      DenseGraphBatch)
    assert prepare_batch(b, densify=False) is b
    assert isinstance(prepare_batch(b, densify=True), DenseGraphBatch)
    assert prepare_batch(b, pooler=_SparseOnly()) is b
    assert prepare_batch(b, pooler=_Unbatched()) is b
    with pytest.raises(ValueError, match="ACCEPTS_DENSE_BATCH"):
        prepare_batch(b, densify=True, pooler=_SparseOnly())
    d = to_dense(b)
    assert prepare_batch(d) is d
    with pytest.raises(ValueError, match="DenseGraphBatch"):
        prepare_batch(d, pooler=_SparseOnly())
    # a wide batch stays sparse under auto
    wide = from_graphs([(np.zeros((2049, 1), np.float32),
                         np.array([[0], [1]]))], device="cpu")
    assert prepare_batch(wide, pooler=pooler) is wide


@pytest.mark.parametrize("adj_dtype", [None, "bfloat16"])
def test_prepare_batch_normalize_matches_jax(adj_dtype):
    graphs = _graphs(13, count=3, n_range=(6, 10), weighted=True)
    jb = j_from(graphs)
    ref = j_prepare(jb, pooler=j_get("topk", in_channels=F_IN),
                    normalize=True,
                    adj_dtype=None if adj_dtype is None else jnp.bfloat16)
    got = prepare_batch(from_graphs(graphs, device="cpu"),
                        pooler=get_pooler("topk", in_channels=F_IN,
                                          device="cpu"), normalize=True,
                        adj_dtype=None if adj_dtype is None
                        else torch.bfloat16)
    assert isinstance(ref, JDense) and isinstance(got, DenseGraphBatch)
    _close(got.adj, ref.adj, 1e-6 if adj_dtype is None else 2 ** -7)
    np.testing.assert_array_equal(_np(got.x), _np(ref.x))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _dtc_pair(seed, *, kernel=False, bf16=False, pool_impl="auto"):
    jm = JDTC(num_classes=3, hidden=HIDDEN, ratio=0.5, pre_normalized=True,
              compute_dtype=jnp.bfloat16 if bf16 else None,
              use_pallas=kernel, pool_impl=pool_impl)
    graphs = _graphs(seed)
    jd, td = _dense_pair(graphs)
    jd = j_norm(jd, adj_dtype=jnp.bfloat16 if bf16 else None)
    td = gcn_norm_dense(td, adj_dtype=torch.bfloat16 if bf16 else None)
    params = jm.init(jax.random.key(seed), jd)
    tm = DenseTopkClassifier(
        num_classes=3, hidden=HIDDEN, ratio=0.5, pre_normalized=True,
        compute_dtype=torch.bfloat16 if bf16 else None, use_kernel=kernel,
        pool_impl=pool_impl, in_channels=F_IN, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, jd, tm, td


def _pc_pair(seed, *, kernel=False, bf16=False, fast_masks=False):
    """The documented default path: prepare_batch(normalize=True) (bf16
    adjacency) and PoolingClassifier(pre_normalized=True)."""
    graphs = _graphs(seed)
    jpool = j_get("topk", in_channels=HIDDEN, ratio=0.5)
    jd = j_prepare(j_from(graphs, max_nodes=MAX_NODES), pooler=jpool,
                   normalize=True)
    jm = JPC(pooler=jpool, num_classes=3, hidden=HIDDEN, pre_normalized=True,
             fast_masks=fast_masks, use_pallas=kernel,
             compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jm.init(jax.random.key(seed), jd)
    tpool = get_pooler("topk", in_channels=HIDDEN, ratio=0.5, device="cpu")
    td = prepare_batch(from_graphs(graphs, max_nodes=MAX_NODES, device="cpu"),
                       pooler=tpool, normalize=True)
    tm = PoolingClassifier(tpool, num_classes=3, hidden=HIDDEN,
                           in_channels=F_IN, pre_normalized=True,
                           fast_masks=fast_masks, use_kernel=kernel,
                           compute_dtype=torch.bfloat16 if bf16 else None,
                           device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, jd, tm, td


def _check_logits(pair, rel):
    jm, params, jd, tm, td = pair
    ref, _ = jm.apply(params, jd)
    got, out = tm(td)
    assert got.dtype == torch.float32 and got.shape == (8, 3)
    assert np.isfinite(_np(got)).all()
    _close(got, ref, rel)
    return out


@pytest.mark.parametrize("pool_impl", ["onehot", "gather"])
def test_dense_topk_classifier_f32_matches_jax(pool_impl):
    pooled = _check_logits(_dtc_pair(20, pool_impl=pool_impl), 1e-4)
    assert isinstance(pooled, DenseGraphBatch)
    assert pooled.max_nodes == MAX_NODES // 2


@pytest.mark.parametrize("kernel", [False, True])
def test_dense_topk_classifier_bf16_matches_jax(kernel):
    _check_logits(_dtc_pair(21, kernel=kernel, bf16=True), 2e-2)


@pytest.mark.parametrize("fast_masks", [False, True])
def test_pooling_classifier_dense_f32_matches_jax(fast_masks):
    out = _check_logits(_pc_pair(22, fast_masks=fast_masks), 1e-4)
    assert out.graph is None and out.dense is not None
    assert out.so.is_dense


@pytest.mark.parametrize("kernel", [False, True])
def test_pooling_classifier_dense_bf16_matches_jax(kernel):
    _check_logits(_pc_pair(23, kernel=kernel, bf16=True), 2e-2)


def test_pooling_classifier_kernel_route_matches_jax_pallas():
    """The default path with ``use_kernel=True`` (f32 features, bf16
    adjacency: every operand rounded to bf16 inside the product)."""
    _check_logits(_pc_pair(24, kernel=True), 2e-2)


# ---------------------------------------------------------------------------
# training steps: loss, gradients and Adam against optax
# ---------------------------------------------------------------------------

LABELS = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)


def _jax_losses(jm, params, jd, steps, aux):
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    y = jnp.asarray(LABELS)

    def loss_fn(p):
        logits, out = jm.apply(p, jd)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean() + (out.loss_sum() if aux else 0.0)

    losses, grads0 = [], None
    for _ in range(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads0 = grads if grads0 is None else grads0
        losses.append(float(loss))
        upd, opt = tx.update(grads, opt)
        params = optax.apply_updates(params, upd)
    return losses, grads0


def _torch_losses(tm, td, steps, aux):
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    y = torch.tensor(LABELS).long()
    losses, grads0 = [], None
    for _ in range(steps):
        opt.zero_grad()
        logits, out = tm(td)
        loss = torch.nn.functional.cross_entropy(logits, y)
        if aux:
            loss = loss + out.loss_sum()
        loss.backward()
        if grads0 is None:
            grads0 = {k: v.grad.clone() for k, v in tm.named_parameters()}
        losses.append(float(loss.detach()))
        opt.step()
    return losses, grads0


@pytest.mark.parametrize("model,kernel", [("dense_topk", False),
                                          ("dense_topk", True),
                                          ("pooling", False)])
def test_dense_training_steps_match_jax(model, kernel):
    """Step one's loss and every gradient leaf (mapped through
    ``params_from_flax``, within 1e-3 of the leaf's max |value|), and the
    losses of 3 Adam steps within 1e-3 relative, f32 compute."""
    pair = (_dtc_pair(30, kernel=kernel) if model == "dense_topk"
            else _pc_pair(31, kernel=kernel))
    jm, params, jd, tm, td = pair
    aux = model == "pooling"  # the default path adds out.loss_sum()
    jl, jg = _jax_losses(jm, params, jd, 3, aux)
    tl, tg = _torch_losses(tm, td, 3, aux)
    want = params_from_flax(jax.tree.map(np.asarray, jg))
    assert set(want) == set(tg)
    for k, v in want.items():
        _close(tg[k], v, 1e-3, k)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
