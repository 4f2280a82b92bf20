"""The port's data pipeline against the JAX package's on the same numpy
graphs: ``data/transforms.py`` (exact numpy results), ``compute_budgets``
and ``worst_case_cycled``, ``GraphLoader`` and ``BucketedGraphLoader``
(the same graphs in the same order for a seed, and identical batches,
CSR metadata included), the port's auto sort threshold, and
``SyntheticGraphClassification``."""

import dataclasses

import numpy as np
import pytest
import torch

from tgp_tpu.data.loaders import BucketedGraphLoader as JBucketed
from tgp_tpu.data.loaders import GraphLoader as JLoader
from tgp_tpu.data.loaders import compute_budgets as j_budgets
from tgp_tpu.data.loaders import worst_case_cycled as j_worst
from tgp_tpu.data.transforms import NormalizeAdj as JNormalizeAdj
from tgp_tpu.data.transforms import SortNodes as JSortNodes
from tgp_tpu.data.transforms import split_graph_tuple as j_split
from tgp_tpu.datasets.synthetic import SyntheticGraphClassification as JSynth
from tgp_tpu_torch.data import (BucketedGraphLoader, GraphLoader,
                                NormalizeAdj, SortNodes, compute_budgets,
                                split_graph_tuple, worst_case_cycled)
from tgp_tpu_torch.data.loaders import _auto_sort_edges
from tgp_tpu_torch.datasets import SyntheticGraphClassification
from tgp_tpu_torch.ops.sparse import PALLAS_MIN_EDGES

torch.set_num_threads(1)


def _graphs(seed, count=23, lo=4, hi=40, weighted=False):
    """Graphs of skewed sizes (some share a node count), with a few
    duplicate edges and loops."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        e = int(rng.integers(n, 4 * n))
        ei = rng.integers(0, n, (2, e))
        x = rng.normal(size=(n, 5)).astype(np.float32)
        if weighted:
            out.append((x, ei, rng.random(e).astype(np.float32) + 0.1))
        else:
            out.append((x, ei))
    return out


def _same_batch(jb, tb):
    names = {f.name for f in dataclasses.fields(jb)}
    for f in dataclasses.fields(tb):
        if f.name not in names:
            continue
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)
        else:
            assert a is None if b is None else a == b, f.name


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _labelled(seed, n=12, e=30):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    ei = rng.integers(0, n, (2, e))
    ew = rng.random(e).astype(np.float32) + 0.2
    y = rng.integers(0, 4, n)
    return x, ei, ew, y


def _assert_same_tuple(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["x_ei", "x_ei_ew", "x_ei_y", "x_ei_ew_y",
                                  "x_ei_none_y"])
def test_split_graph_tuple_matches_jax(form):
    x, ei, ew, y = _labelled(0)
    graph = {"x_ei": (x, ei), "x_ei_ew": (x, ei, ew), "x_ei_y": (x, ei, y),
             "x_ei_ew_y": (x, ei, ew, y), "x_ei_none_y": (x, ei, None, y)
             }[form]
    _assert_same_tuple(split_graph_tuple(graph), j_split(graph))


def test_split_graph_tuple_rejects_the_ambiguous_shorthand():
    x, _, _, _ = _labelled(1, n=6)
    ei = np.array([[0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 0]])
    lab = np.arange(6)  # N == E: labels or integer weights
    for split in (split_graph_tuple, j_split):
        with pytest.raises(ValueError, match="ambiguous"):
            split((x, ei, lab))


@pytest.mark.parametrize("form", ["x_ei", "x_ei_ew", "x_ei_ew_y", "x_ei_y"])
@pytest.mark.parametrize("delta", [0.85, 0.5])
def test_normalize_adj_matches_jax(form, delta):
    x, ei, ew, y = _labelled(2)
    graph = {"x_ei": (x, ei), "x_ei_ew": (x, ei, ew),
             "x_ei_ew_y": (x, ei, ew, y), "x_ei_y": (x, ei, y)}[form]
    _assert_same_tuple(NormalizeAdj(delta)(graph),
                       JNormalizeAdj(delta)(graph))


@pytest.mark.parametrize("form", ["x_ei_y", "x_ei_ew_y", "x_ei_none_y"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_nodes_matches_jax(form, descending):
    x, ei, ew, y = _labelled(3)
    graph = {"x_ei_y": (x, ei, y), "x_ei_ew_y": (x, ei, ew, y),
             "x_ei_none_y": (x, ei, None, y)}[form]
    _assert_same_tuple(SortNodes(descending)(graph),
                       JSortNodes(descending)(graph))
    with pytest.raises(ValueError, match="labels"):
        SortNodes()((x, ei))


# ---------------------------------------------------------------------------
# budgets and loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [1, 4, 23, 40])
def test_budgets_match_jax(batch_size):
    graphs = _graphs(4)
    assert compute_budgets(graphs, batch_size) == j_budgets(graphs,
                                                            batch_size)
    per = [g[1].shape[1] for g in graphs]
    assert worst_case_cycled(per, batch_size) == j_worst(per, batch_size)


@pytest.mark.parametrize("sort_edges", [False, True])
@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 7)])
@pytest.mark.parametrize("weighted", [False, True])
def test_graph_loader_matches_jax(shuffle, seed, sort_edges, weighted):
    """Two epochs: the same graphs in the same order (a short last batch
    cycles the order), the same labels and identical batches."""
    graphs = _graphs(5, weighted=weighted)
    labels = np.arange(len(graphs)) % 3
    kw = dict(batch_size=5, shuffle=shuffle, seed=seed,
              sort_edges=sort_edges)
    jl = JLoader(graphs, labels, **kw)
    tl = GraphLoader(graphs, labels, device="cpu", **kw)
    assert (tl.pad_nodes, tl.pad_edges, tl.max_nodes, len(tl)) == (
        jl.pad_nodes, jl.pad_edges, jl.max_nodes, len(jl))
    for _ in range(2):
        got = list(tl._iter_with_indices())
        ref = list(jl._iter_with_indices())
        assert len(got) == len(ref) == 5
        for (tb, ty, ti), (jb, jy, ji) in zip(got, ref):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ty, jy)
            assert tb.device.type == "cpu"
            _same_batch(jb, tb)
    # plain iteration yields (batch, labels), or batches without labels
    assert all(len(item) == 2 for item in tl)
    assert all(not isinstance(b, tuple)
               for b in GraphLoader(graphs, device="cpu"))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_buckets", [1, 3, 6])
def test_bucketed_loader_matches_jax(shuffle, num_buckets):
    graphs = _graphs(6, count=31, lo=3, hi=60)
    labels = np.arange(len(graphs)) % 4
    kw = dict(batch_size=4, num_buckets=num_buckets, shuffle=shuffle,
              seed=3)
    jl = JBucketed(graphs, labels, **kw)
    tl = BucketedGraphLoader(graphs, labels, device="cpu", **kw)
    assert tl.budgets == jl.budgets and len(tl) == len(jl)
    for a, b in zip(tl.buckets, jl.buckets):
        np.testing.assert_array_equal(a, b)
    for _ in range(2):
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref)
        for (tb, ty), (jb, jy) in zip(got, ref):
            np.testing.assert_array_equal(ty, jy)
            _same_batch(jb, tb)


def test_auto_sort_threshold_is_where_the_csr_kernel_engages():
    """``sort_edges=None`` sorts exactly where ``use_kernel_spmm`` sends a
    sorted batch to K1: an edge budget of at least PALLAS_MIN_EDGES, on
    CUDA; never on the CPU, where no kernel runs."""
    for dev in ("cuda", torch.device("cuda")):
        assert _auto_sort_edges(None, PALLAS_MIN_EDGES, torch.device(dev))
        assert not _auto_sort_edges(None, PALLAS_MIN_EDGES - 1,
                                    torch.device(dev))
    assert not _auto_sort_edges(None, 4 * PALLAS_MIN_EDGES,
                                torch.device("cpu"))
    for flag in (False, True):
        assert _auto_sort_edges(flag, 0, torch.device("cpu")) is flag
    graphs = _graphs(7, count=4)
    big = dict(pad_edges=PALLAS_MIN_EDGES, device="cpu")
    assert not GraphLoader(graphs, **big).sort_edges
    assert GraphLoader(graphs, sort_edges=True, **big).sort_edges
    assert not BucketedGraphLoader(graphs, device="cpu").__iter__(
        ).__next__().edges_sorted


def test_loaders_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphLoader(_graphs(8, count=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BucketedGraphLoader(_graphs(8, count=2))


@pytest.mark.parametrize("seed,num_features", [(0, 8), (42, 5)])
def test_synthetic_dataset_matches_jax(seed, num_features):
    kw = dict(num_graphs=30, num_features=num_features, seed=seed)
    got, gy = SyntheticGraphClassification(**kw).generate()
    ref, ry = JSynth(**kw).generate()
    np.testing.assert_array_equal(gy, ry)
    assert gy.dtype == ry.dtype
    for (x, ei), (jx, jei) in zip(got, ref):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(ei, jei)
