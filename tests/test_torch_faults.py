"""The port's repaired faults, on the CPU, against the JAX package where it
has the same function: the pooler registry's ``register_pooler`` and
``unregister_pooler``; ``select.degree_scorer``, ``datasets.synthetic.
csbm_graph`` and the 20 names of ``tgp_tpu.ops``; the ``remat`` flag of
both classifiers (the same loss and gradients with and without it, as
``tests/test_models.py::test_remat_gradient_invariance`` pins JAX's); the
fixed-order sums (``segment_sum`` on floats, the merge of ``coalesce`` and
the adjacency of ``to_dense``), equal to JAX's results (the merged edges
as a set where the port orders them receiver-major); and the sorted flag
of a pooled batch and of k-MIS's merged one, set only where the edges
ascend by receiver.  The repeat
bit-equality of the same sums on the card is held by the ``cuda`` tests
of ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu.ops as j_ops
import tgp_tpu_torch.ops as t_ops
from tgp_tpu.datasets.synthetic import csbm_graph as j_csbm
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.graph import to_dense as j_to_dense
from tgp_tpu.select import degree_scorer as j_degree
from tgp_tpu_torch import DenseTopkClassifier, PoolingClassifier, prepare_batch
from tgp_tpu_torch.datasets.synthetic import csbm_graph
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.graph import to_dense
from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.poolers import (get_pooler, pooler_map, register_pooler,
                                   unregister_pooler)
from tgp_tpu_torch.poolers.nopool import NoPool
from tgp_tpu_torch.select import degree_scorer

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _dup_graphs(seed, count=3, n=12, e=40, feat=5):
    """Weighted graphs whose edge lists repeat a third of their edges."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        s, r = np.concatenate([s, s[:e // 3]]), np.concatenate([r, r[:e // 3]])
        out.append((rng.normal(size=(n, feat)).astype(np.float32),
                    np.stack([s, r]),
                    rng.normal(size=s.shape[0]).astype(np.float32)))
    return out


def test_register_and_unregister_pooler_round_trip():
    assert "mine" not in pooler_map()

    @register_pooler("mine")
    class Mine(NoPool):
        pass

    try:
        assert pooler_map()["mine"] is Mine
        assert isinstance(get_pooler("mine"), Mine)
        assert register_pooler("mine2", Mine) is Mine
        pooler_map().pop("mine2")  # a copy: the registry keeps it
        assert pooler_map()["mine2"] is Mine
    finally:
        unregister_pooler("mine")
        unregister_pooler("mine2")
    assert "mine" not in pooler_map() and "mine2" not in pooler_map()
    unregister_pooler("mine")  # an unknown alias is a no-op
    with pytest.raises(ValueError, match="unknown pooler"):
        get_pooler("mine")


def test_degree_scorer_matches_jax():
    graphs = _dup_graphs(1)
    got = degree_scorer(t_from(graphs, **CPU))
    ref = j_degree(j_from(graphs))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("args", [(30, 3, 0.5, 0.05, 6),
                                  (8, 2, 0.0, 0.0, 3, 2.0)])
def test_csbm_graph_matches_jax(args):
    got = csbm_graph(np.random.default_rng(4), *args)
    ref = j_csbm(np.random.default_rng(4), *args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_ops_reexports_jax_names():
    assert t_ops.__all__ == j_ops.__all__ and len(t_ops.__all__) == 20
    assert all(callable(getattr(t_ops, n)) for n in t_ops.__all__)


#: modules of ``tgp_tpu`` whose names the port does not carry: the Pallas
#: kernels (ported as ``csrc/*.cu`` with ``ops/kernels/*.py``) and the
#: native library's binary
_NOT_MIRRORED = ("tgp_tpu.ops.pallas", "tgp_tpu._native.libtgp_native")


def _jax_modules_with_all():
    import importlib
    import pkgutil

    import tgp_tpu

    names = ["tgp_tpu"]
    for m in pkgutil.walk_packages(tgp_tpu.__path__, "tgp_tpu."):
        if not m.name.startswith(_NOT_MIRRORED):
            names.append(m.name)
    return [n for n in names
            if hasattr(importlib.import_module(n), "__all__")]


@pytest.mark.parametrize("name", _jax_modules_with_all())
def test_port_exports_every_jax_name(name):
    """JAX's ``__all__`` ⊆ the names of the port's module of the same path
    (``tgp_tpu.ops`` is one case: its 20 names)."""
    import importlib

    jm = importlib.import_module(name)
    tm = importlib.import_module("tgp_tpu_torch" + name[len("tgp_tpu"):])
    missing = [n for n in jm.__all__ if not hasattr(tm, n)]
    assert not missing, f"{tm.__name__} lacks {missing}"
    if hasattr(tm, "__all__"):
        assert set(jm.__all__) <= set(tm.__all__), name


def test_graclus_accepts_reduce_red_op_and_ignores_it():
    """JAX's ``GraclusPooling`` has a ``reduce_red_op`` field that it never
    reads; the port accepts the argument on direct construction and pools
    the same as without it."""
    from tgp_tpu.poolers.graclus import GraclusPooling as JGraclus
    from tgp_tpu_torch.poolers.graclus import GraclusPooling

    graphs = _dup_graphs(3)
    tb = t_from(graphs, **CPU)
    got = GraclusPooling(reduce_red_op="mean")(tb)
    ref = GraclusPooling()(tb)
    jout = JGraclus(reduce_red_op="mean").apply({}, j_from(graphs))
    assert got.graph.x.shape == ref.graph.x.shape
    assert torch.equal(got.graph.x, ref.graph.x)
    np.testing.assert_allclose(_np(got.graph.x), _np(jout.graph.x),
                               atol=1e-5, rtol=1e-5)
    assert GraclusPooling(reduce_red_op="max").reduce_red_op == "max"


def _dense_batch():
    graphs = _dup_graphs(2, feat=8)
    return prepare_batch(t_from(graphs, **CPU), densify=True)


def _grads(model, batch, remat):
    model.remat = remat
    model.zero_grad(set_to_none=True)
    logits, out = model(batch)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.tensor([0, 1, 2]))
    if hasattr(out, "loss_sum"):
        loss = loss + out.loss_sum()
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


@pytest.mark.parametrize("which", ["pooling", "dense_topk"])
def test_remat_gradient_invariance(which):
    """The same parameter names, loss and gradients with and without
    ``remat`` (the GCN layers recomputed in the backward pass)."""
    if which == "pooling":
        make = lambda remat: PoolingClassifier(  # noqa: E731
            get_pooler("mincut", in_channels=16, k=4, **CPU), 3, hidden=16,
            in_channels=8, remat=remat, **CPU,
            generator=torch.Generator().manual_seed(0))
    else:
        make = lambda remat: DenseTopkClassifier(  # noqa: E731
            3, hidden=16, in_channels=8, remat=remat, **CPU,
            generator=torch.Generator().manual_seed(0))
    plain, rm = make(False), make(True)
    assert plain.state_dict().keys() == rm.state_dict().keys()
    rm.load_state_dict(plain.state_dict())
    batch = _dense_batch()
    l0, g0 = _grads(plain, batch, False)
    l1, g1 = _grads(rm, batch, True)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6)


def _index_add_sum(data, ids, n, mask=None):
    """The scatter the fixed-order sum replaced: masked ``index_add_``."""
    keep = (ids >= 0) & (ids < n)
    if mask is not None:
        keep = keep & mask
    data = torch.where(keep.reshape(keep.shape + (1,) * (data.dim() - 1)),
                       data, 0)
    return torch.zeros((n,) + data.shape[1:], dtype=data.dtype).index_add_(
        0, torch.where(keep, ids, 0), data)


def test_segment_sum_ordered_matches_segment_sum():
    """The fixed-order sum (``segment_sum`` on floats): the values of a
    masked ``index_add_`` (masks, ids out of range, sorted or not), and
    the gradient of a gather."""
    rng = np.random.default_rng(5)
    data = torch.tensor(rng.normal(size=(300, 4)).astype(np.float32),
                        requires_grad=True)
    ids = torch.tensor(rng.integers(-2, 23, 300))
    mask = torch.tensor(rng.random(300) < 0.8)
    got = segment_sum(data, ids, 20, mask=mask)
    ref = _index_add_sum(data.detach(), ids, 20, mask=mask)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    got.pow(2).sum().backward()
    keep = (ids >= 0) & (ids < 20) & mask
    want = torch.where(keep[:, None], 2 * ref.detach()[ids.clamp(0, 19)], 0.0)
    torch.testing.assert_close(data.grad, want)
    s_ids, order = torch.sort(ids.clamp(0, 19))
    torch.testing.assert_close(
        segment_sum(data.detach()[order], s_ids, 20, ids_sorted=True),
        _index_add_sum(data.detach(), ids.clamp(0, 19), 20), rtol=0,
        atol=1e-5)
    ints = torch.tensor(rng.integers(0, 9, 300), dtype=torch.int32)
    assert torch.equal(segment_sum(ints, ids, 20),
                       _index_add_sum(ints, ids, 20))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_coalesce_lays_out_receiver_major(reduce):
    """The merge puts the masked slots first (weight 0), then the heads
    ascending by ``(receiver, sender)``, one head a key, JAX's merged
    weights on them."""
    from tgp_tpu.ops.sparse import coalesce as j_coalesce

    rng = np.random.default_rng(6)
    n, e = 15, 120
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    m = rng.random(e) < 0.9
    js, jr, jw, jm = (np.asarray(a) for a in j_coalesce(
        jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), jnp.asarray(m), n,
        reduce=reduce))
    ts, tr, tw, tm = (a.numpy() for a in t_ops.coalesce(
        torch.tensor(s), torch.tensor(r), torch.tensor(w), torch.tensor(m),
        n, reduce=reduce))
    n_masked = int((~tm).sum())
    assert not tm[:n_masked].any() and tm[n_masked:].all()
    assert not tw[~tm].any() and (np.diff(tr) >= 0).all()
    key = tr[tm].astype(np.int64) * n + ts[tm]
    assert (np.diff(key) > 0).all()
    jo = np.lexsort((js[jm], jr[jm]))
    np.testing.assert_allclose(tw[tm], jw[jm][jo], atol=1e-6, rtol=0)


@pytest.mark.parametrize("alias", ["topk", "graclus", "kmis", "ec"])
def test_pooled_batch_is_flagged_sorted_only_where_it_is(alias):
    """``sparse_connect`` flags the layout it makes: a total assignment's
    merged edges ascend by receiver and the pooled batch says so; top-k's
    keep the input's order with dropped edges masked in place, unflagged
    (its input sorted)."""
    batch = t_from(_dup_graphs(8), sort_edges=True, **CPU)
    pooler = get_pooler(alias, in_channels=5, ratio=0.5,
                        generator=torch.Generator().manual_seed(0), **CPU)
    with torch.no_grad():
        graph = pooler(batch).graph
    assert graph.edges_sorted == (alias != "topk")
    if graph.edges_sorted:
        assert (graph.receivers.diff() >= 0).all()
    else:
        assert not (graph.receivers.diff() >= 0).all()


def test_kmis_undirected_merge_is_sorted_as_flagged(monkeypatch):
    """k-MIS's ``force_undirected`` merge is flagged sorted, so its
    heuristic sums without a sort: the ids it hands the sum ascend, and
    the heuristic equals the one summed as unsorted ids."""
    import tgp_tpu_torch.select.kmis as kmis_mod

    seen = []

    def spy(data, ids, n, *, ids_sorted=False):
        seen.append((ids, ids_sorted))
        return segment_sum(data, ids, n, ids_sorted=ids_sorted)

    batch = t_from(_dup_graphs(9), **CPU)
    sel = kmis_mod.KMISSelect(5, order_k=2, score_heuristic="weighted",
                              force_undirected=True,
                              generator=torch.Generator().manual_seed(0),
                              **CPU)
    monkeypatch.setattr(kmis_mod, "segment_sum", spy)
    with torch.no_grad():
        rank = sel(batch).extras["rank"]
        assert len(seen) == 2
        assert all(flag and (ids.diff() >= 0).all() for ids, flag in seen)
        seen.clear()
        monkeypatch.setattr(
            kmis_mod, "segment_sum",
            lambda d, i, n, ids_sorted=False: segment_sum(d, i, n))
        assert torch.equal(sel(batch).extras["rank"], rank)


def test_to_dense_sums_duplicate_edges_as_jax():
    """Features, mask and the adjacency (duplicate edges summed) equal
    JAX's ``to_dense``."""
    graphs = _dup_graphs(7)
    got = to_dense(t_from(graphs, **CPU))
    ref = j_to_dense(j_from(graphs))
    np.testing.assert_array_equal(_np(got.x), _np(ref.x))
    np.testing.assert_array_equal(_np(got.mask), _np(ref.mask))
    np.testing.assert_allclose(_np(got.adj), _np(ref.adj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(40, 6), (40,)], ids=["rows", "vector"])
def test_gather_rows_gives_index_selects_values_and_gradients(shape):
    """``gather_rows``: ``index_select``'s rows, and its gradient (each
    row's cotangents summed by K4's plain version, in the order of a
    stable sort of the ids) within f32 rounding of ``index_select``'s
    ``index_add_``; one K4 call a backward, none forward."""
    import tgp_tpu_torch.ops.kernels.segment_spmm as K
    from tgp_tpu_torch.ops.segment import gather_rows

    rng = np.random.default_rng(50)
    x0 = torch.tensor(rng.normal(size=shape).astype(np.float32))
    idx = torch.tensor(rng.integers(0, shape[0], 500))
    g = torch.tensor(rng.normal(size=(500,) + shape[1:]).astype(np.float32))
    calls = []
    real = K._k4_sum
    x = x0.clone().requires_grad_(True)
    try:
        K._k4_sum = lambda *a: calls.append(True) or real(*a)
        out = gather_rows(x, idx, shape[0])
        assert calls == []
        (out * g).sum().backward()
    finally:
        K._k4_sum = real
    assert calls == [True]
    ref = x0.clone().requires_grad_(True)
    r_out = ref.index_select(0, idx)
    (r_out * g).sum().backward()
    assert torch.equal(out.detach(), r_out.detach())
    torch.testing.assert_close(x.grad, ref.grad, rtol=1e-5, atol=1e-5)
    # a tensor without a gradient, or an integer one, is gathered as it is
    assert torch.equal(gather_rows(x0, idx, shape[0]), x0[idx])
    ints = torch.arange(shape[0])
    assert torch.equal(gather_rows(ints, idx, shape[0]), idx)
    with pytest.raises(ValueError, match="rows"):
        gather_rows(x0, idx, shape[0] + 1)


def test_float_segment_sum_takes_the_fixed_order(monkeypatch):
    """``segment_sum`` of f32 and bf16 rows goes through K4's entry once,
    with the rows' sort order and mask (its plain path here), never
    through ``index_add_``'s scatter; integer rows keep the scatter."""
    import tgp_tpu_torch.ops.kernels.segment_spmm as K

    calls = []
    real = K._k4_sum

    def spy(x, perm, keep, row_ptr, num_rows, route):
        calls.append((x.dtype, perm is not None, keep is not None))
        return real(x, perm, keep, row_ptr, num_rows, route)

    monkeypatch.setattr(K, "_k4_sum", spy)
    rng = np.random.default_rng(51)
    ids = torch.tensor(rng.integers(0, 7, 90))
    mask = torch.tensor(rng.random(90) < 0.8)
    for dtype in (torch.float32, torch.bfloat16):
        data = torch.tensor(rng.normal(size=(90, 3)).astype(np.float32)
                            ).to(dtype)
        got = segment_sum(data, ids, 7, mask=mask)
        want = torch.zeros(7, 3).index_add_(
            0, ids, torch.where(mask[:, None], data.float(), 0.0))
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    assert calls == [(torch.float32, True, True), (torch.bfloat16, True, True)]
    segment_sum(torch.ones(90, dtype=torch.int32), ids, 7, mask=mask)
    segment_sum(torch.ones(90, dtype=torch.float64), ids, 7)
    assert len(calls) == 2


@pytest.mark.parametrize("normalize", [True, False])
def test_pan_scale_still_equals_jax(normalize):
    """PAN's dense MET scale is now an indexed write (each valid node owns
    its cell, padding writes a spare one) where it was an ``index_put``
    with ``accumulate=True``: the MET weights, degrees and output still
    equal JAX's on a padded batch whose padding nodes alias a real
    node's cell."""
    import jax

    from tgp_tpu.mp.pan import PANConv as JPAN
    from tgp_tpu_torch.models.convert import params_from_flax
    from tgp_tpu_torch.mp import PANConv

    graphs = [g[:2] for g in _dup_graphs(52, count=3)]
    kw = dict(pad_nodes=48, pad_edges=256)
    jb, tb = j_from(graphs, **kw), t_from(graphs, **kw, **CPU)
    jconv = JPAN(4, filter_size=2, normalize=normalize,
                 exact_met_support=True)
    p = jconv.init(jax.random.key(0), jb)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(53)
    p = jax.tree.unflatten(tree, [jnp.asarray(np.asarray(v) + 0.1 * rng.normal(
        size=v.shape).astype(np.float32)) for v in leaves])
    tconv = PANConv(5, 4, filter_size=2, normalize=normalize,
                    exact_met_support=True, **CPU)
    sd = params_from_flax({"PANConv_0": p["params"]})
    tconv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    for got, ref in zip(tconv(tb), jconv.apply(p, jb)):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=1e-5 * max(1, np.abs(_np(ref)).max()))


# ---------------------------------------------------------------------------
# gathers whose gradient was an accumulating index_put (sparse losses, the
# sparse lift), and masked dense_rows / the batched quantile
# ---------------------------------------------------------------------------

def _loss_case(name):
    """``(fn, inputs)``: a loss or lift of the port on a padded two-graph
    batch, ``fn(S)`` for a leaf ``S`` that takes a gradient."""
    from tgp_tpu_torch import losses as L
    from tgp_tpu_torch.lift.base import lift_sparse
    from tgp_tpu_torch.ops.segment import dense_rows
    from tgp_tpu_torch.select.base import SelectOutput

    graphs = [g[:2] for g in _dup_graphs(61, count=2)]
    tb = t_from(graphs, pad_nodes=40, pad_edges=256, **CPU)
    N, B = tb.num_nodes, tb.num_graphs
    edges = (tb.senders, tb.receivers, tb.edge_weight)
    rng = np.random.default_rng(62)
    S = torch.tensor(rng.random((N, 3)).astype(np.float32),
                     requires_grad=True)
    graph = (tb.node_graph, B)
    if name == "sparse_mincut":
        return lambda s: L.sparse_mincut_loss(*edges, s, *graph,
                                              tb.node_mask), S
    if name == "sparse_totvar":
        return lambda s: L.sparse_totvar_loss(*edges, s, *graph), S
    if name == "sparse_spectral":
        return lambda s: L.sparse_spectral_loss(*edges, s, *graph,
                                                tb.node_mask), S
    if name == "unbatched_asym_norm":
        return lambda s: L.unbatched_asym_norm_loss(s, 3, *graph,
                                                    tb.node_mask), S
    if name == "asym_norm":
        d = to_dense(tb)
        Sd = torch.tensor(rng.random(d.mask.shape + (3,)).astype(np.float32),
                          requires_grad=True)
        return lambda s: L.asym_norm_loss(s, 3, mask=d.mask), Sd
    if name == "dense_rows":
        return lambda s: dense_rows(s, tb.node_graph, tb.node_pos, B,
                                    tb.max_nodes, tb.node_mask), S
    # lift_sparse: every node of a graph in one of two clusters
    ci = (tb.node_graph.long() * 2 + tb.node_pos.long() % 2).to(torch.int32)
    so = SelectOutput(cluster_index=ci, num_clusters=2 * B,
                      weight=torch.linspace(0.5, 1.5, N),
                      node_sel_mask=tb.node_mask, s_inv_op=name[5:])
    xp = torch.tensor(rng.random((2 * B, 4)).astype(np.float32),
                      requires_grad=True)
    return lambda x: lift_sparse(x, so), xp


_GATHER_CASES = ["sparse_mincut", "sparse_totvar", "sparse_spectral",
                 "unbatched_asym_norm", "asym_norm", "dense_rows",
                 "lift_transpose", "lift_inverse"]


@pytest.mark.parametrize("name", _GATHER_CASES)
def test_loss_and_lift_gradients_add_in_a_fixed_order(name, monkeypatch):
    """The sparse losses' ``S[senders]``/``S[receivers]`` and the
    quantile's ``quant[node_graph]``, and the sparse lift's
    ``x_pool[cluster]``, were advanced-index gathers, whose gradient is
    an accumulating ``index_put`` (float atomics on the card); the batched
    quantile's ``torch.gather`` backward was a ``scatter_add``, and
    ``dense_rows`` an ``index_add``.  Now the gathers are
    :func:`~tgp_tpu_torch.ops.segment.gather_rows` (a fixed-order K4
    gradient), the quantile a masked sum and ``dense_rows`` an indexed
    write: no float scatter forward or backward, and the same values and
    gradients as the indexing they replace."""
    from tests.float_scatter_spy import spy_with_k4_paused

    fn, leaf = _loss_case(name)
    spy = spy_with_k4_paused(monkeypatch)
    with spy:
        out = fn(leaf)
        cot = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (out * cot).sum().backward()
    assert spy.seen == [], spy.seen
    # the values and gradient equal plain autograd over torch indexing
    got, grad = out.detach(), leaf.grad.clone()
    leaf.grad = None
    import tgp_tpu_torch.losses as L
    import tgp_tpu_torch.lift.base as LB
    import tgp_tpu_torch.ops.segment as seg

    plain = lambda x, i, n: x[i.long()]  # noqa: E731
    for mod in (L, LB):
        monkeypatch.setattr(mod, "gather_rows", plain)
    out2 = fn(leaf)
    (out2 * cot).sum().backward()
    torch.testing.assert_close(got, out2.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad, leaf.grad, rtol=1e-5, atol=1e-6)
    assert seg.gather_rows is not plain
