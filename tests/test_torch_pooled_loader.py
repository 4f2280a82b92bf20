"""``tgp_tpu_torch.data.pooled_loader`` against ``tgp_tpu``'s on the same
precoarsened graphs: ``collate_level`` element for element (the sparse,
dense and eigen kinds; a dense level's ``s`` is the port's unbatched
``assignment``, with each node's graph position and the previous level's
largest graph), ``separate_level`` and the round trip, and
``PooledGraphLoader`` over a short dataset (cycled) and a shuffled one,
batch for batch."""

import numpy as np
import pytest
import torch

from tgp_tpu.data.pooled_loader import PooledGraphLoader as JLoader
from tgp_tpu.data.pooled_loader import collate_level as j_collate
from tgp_tpu.data.pooled_loader import separate_level as j_separate
from tgp_tpu.precoarsen import PreCoarsening as JPreCoarsening
from tgp_tpu_torch.data.pooled_loader import (LevelBatch, PooledGraphLoader,
                                              collate_level, separate_level)
from tgp_tpu_torch.precoarsen import PreCoarsening

SCHEDULES = {
    "graclus": dict(poolers="graclus", levels=2),
    "mixed": dict(poolers=[("ndp", {}), ("graclus", {})]),
    "sep": dict(poolers="sep", levels=2),
    "nmf": dict(poolers=("nmf", {"k": 4}), levels=2),
    "eigen": dict(poolers=[("eigen", {"k": 6}), ("eigen", {"k": 3})]),
}
SO_FIELDS = ("cluster_index", "weight", "node_sel_mask", "node_graph",
             "node_mask", "cluster_graph", "cluster_pos")
GRAPH_FIELDS = ("senders", "receivers", "edge_weight", "edge_mask",
                "node_graph", "node_pos", "node_mask")


def _graphs(count, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(12, 32, count):
        up = np.triu(rng.random((n, n)) < 0.2, 1)
        s, r = np.nonzero(up | up.T)
        out.append((rng.normal(size=(n, 5)).astype(np.float32),
                    np.stack([s, r]).astype(np.int64)))
    return out


def _precoarsened(schedule, count=7, seed=0):
    return [PreCoarsening(**SCHEDULES[schedule])(g)
            for g in _graphs(count, seed)]


def _np(t):
    return np.asarray(t) if not isinstance(t, torch.Tensor) else t.numpy()


def assert_level_equal(t: LevelBatch, j):
    for f in SO_FIELDS:
        a, b = getattr(t.so, f), getattr(j.so, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
    if j.so.s is not None:
        np.testing.assert_array_equal(_np(t.so.assignment), _np(j.so.s))
        assert t.so.num_modes == j.so.num_modes
    for f in ("num_clusters", "num_graphs", "max_clusters", "partial"):
        assert getattr(t.so, f) == getattr(j.so, f), f
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(t.graph, f)),
                                      _np(getattr(j.graph, f)), err_msg=f)
    assert t.graph.x.shape == j.graph.x.shape
    assert (t.graph.num_graphs, t.graph.max_nodes) == \
        (j.graph.num_graphs, j.graph.max_nodes)


def _first_levels(schedule):
    graphs = _precoarsened(schedule)
    levels = [g[-1][0] for g in graphs[:4]]
    n_per = [g[0].shape[0] for g in graphs[:4]]
    offs = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    k_tot = sum(int(lv["num_clusters"]) for lv in levels)
    e_tot = sum(lv["edge_index"].shape[1] for lv in levels)
    kmax = max(int(lv["num_clusters"]) for lv in levels)
    args = (levels, offs, sum(n_per) + 5, k_tot + 3, e_tot + 20, kmax)
    return args, n_per


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_collate_level_matches_jax(schedule):
    args, n_per = _first_levels(schedule)
    got = collate_level(*args, feature_dim=5, device="cpu")
    want = j_collate(*args, feature_dim=5)
    assert_level_equal(got, want)
    # the unbatched layout's extra fields: positions and the bound on them
    if got.so.assignment is not None:
        pos = got.so.node_pos.numpy()
        mask = got.so.node_mask.numpy()
        assert got.so.max_nodes == max(n_per)
        np.testing.assert_array_equal(
            pos[mask], np.concatenate([np.arange(n) for n in n_per]))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_separate_level_matches_jax_and_round_trips(schedule):
    args, n_per = _first_levels(schedule)
    offs = args[1]
    got = separate_level(collate_level(*args, device="cpu"), offs, n_per)
    want = j_separate(j_collate(*args), offs, n_per)
    assert len(got) == len(want) == len(args[0])
    for a, b, orig in zip(got, want, args[0]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        # the round trip gives the level back
        assert a["kind"] == orig["kind"]
        assert a["num_clusters"] == orig["num_clusters"]
        np.testing.assert_array_equal(a["edge_index"], orig["edge_index"])
        np.testing.assert_array_equal(a["edge_weight"], orig["edge_weight"])
        key = {"sparse": "cluster_index", "dense": "s",
               "eigen": "theta"}[orig["kind"]]
        np.testing.assert_array_equal(
            a[key], np.asarray(orig[key], a[key].dtype))


def test_collate_level_refuses_a_ragged_dense_level():
    args, _ = _first_levels("nmf")
    levels = [dict(lv) for lv in args[0]]
    levels[1]["num_clusters"] = 3
    with pytest.raises(ValueError, match="uniform per-graph"):
        collate_level(levels, *args[1:], device="cpu")


def test_collate_level_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args, _ = _first_levels("graclus")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collate_level(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PooledGraphLoader(_precoarsened("graclus", 3), batch_size=2)


def _assert_batches_equal(t_loader, j_loader):
    n = 0
    for (tb, tls, ty, ti), (jb, jls, jy, ji) in zip(
            t_loader._iter_with_indices(), j_loader._iter_with_indices()):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x))
        np.testing.assert_array_equal(tb.senders.numpy(),
                                      np.asarray(jb.senders))
        assert len(tls) == len(jls)
        for t, j in zip(tls, jls):
            assert_level_equal(t, j)
        n += 1
    assert n == len(t_loader) == len(j_loader)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_pooled_loader_cycles_a_short_dataset_as_jax(schedule):
    graphs = _precoarsened(schedule, count=3)
    labels = np.arange(3)
    t = PooledGraphLoader(graphs, labels, batch_size=8, device="cpu")
    j = JLoader(graphs, labels, batch_size=8)
    assert t.level_budgets == j.level_budgets
    _assert_batches_equal(t, j)


@pytest.mark.parametrize("schedule", ["graclus", "eigen"])
def test_pooled_loader_shuffles_as_jax(schedule):
    graphs = _precoarsened(schedule, count=10, seed=1)
    labels = np.arange(10) % 3
    t = PooledGraphLoader(graphs, labels, batch_size=4, shuffle=True,
                          seed=3, device="cpu")
    j = JLoader(graphs, labels, batch_size=4, shuffle=True, seed=3)
    for _ in range(2):  # two epochs: the same shuffles
        _assert_batches_equal(t, j)


def test_pooled_loader_takes_weighted_graphs_and_yields_without_labels():
    graphs = [(x, ei, np.full(ei.shape[1], 0.5, np.float32))
              for x, ei in _graphs(5)]
    tf = PreCoarsening("graclus", levels=1)
    pooled = [tf(g) for g in graphs]
    t = PooledGraphLoader(pooled, batch_size=2, device="cpu")
    j = JLoader([JPreCoarsening("graclus", levels=1)(g) for g in graphs],
                batch_size=2)
    for (tb, tls), (jb, jls) in zip(t, j):
        np.testing.assert_array_equal(tb.edge_weight.numpy(),
                                      np.asarray(jb.edge_weight))
        assert_level_equal(tls[0], jls[0])


def test_place_features_pads_and_masks():
    args, _ = _first_levels("nmf")
    lb = collate_level(*args, feature_dim=2, device="cpu")
    B, K = lb.so.num_graphs, lb.so.num_clusters
    x = torch.ones(B, K, 2)
    out = lb.place_features(x)
    assert out.shape == (lb.graph.num_nodes, 2)
    np.testing.assert_array_equal(out.sum(1).numpy() > 0,
                                  lb.graph.node_mask.numpy())
    assert lb.to("cpu").so.assignment is not None
