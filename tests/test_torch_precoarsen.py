"""``tgp_tpu_torch.precoarsen`` and ``tgp_tpu_torch._native`` against
``tgp_tpu``'s on the same seeded numpy graphs (10–40 nodes: ER, SBM,
weighted, and the degenerate graphs of ``tests/data/test_precoarsening.py``).

* Graclus (the native library and the numpy twin), NDP and SEP (the native
  merge and the Python one): level dicts exactly equal to JAX's, key by
  key, dtype and bits.
* NMF: the port's numpy coordinate descent against JAX's level, which runs
  scikit-learn: the whole level dict bit-equal (tolerance 0).
* EigenPool: the labels of the port's numpy spectral clustering equal
  scikit-learn's (through JAX's level); Θ and the pooled edges equal given
  JAX's ``cluster_index``.
* NDP with ``eigensolver="lobpcg"`` (the port's LOBPCG on the CPU), and
  NDP at 40 nodes and more (ARPACK, which JAX starts unseeded): the kept
  nodes are JAX's or their complement, isolated nodes aside — an
  eigenvector's sign is arbitrary and the start vectors differ.
* The native build: named by a hash of its source, built under
  ``build/``, a failing build raises with the compiler's output, and the
  numpy twins run only where no compiler is found.
"""

import numpy as np
import pytest

pytest.importorskip("sklearn")

import tgp_tpu._native as j_native_mod
import tgp_tpu.precoarsen.sep as j_sep_mod
from tgp_tpu.precoarsen import PreCoarsening as JPreCoarsening
from tgp_tpu.precoarsen import precoarsen_graph as j_precoarsen
from tgp_tpu.precoarsen.eigenpool import eigenpool_level as j_eigen
from tgp_tpu.precoarsen.ndp import ndp_level as j_ndp
from tgp_tpu.precoarsen.nmf import nmf_level as j_nmf
from tgp_tpu_torch import _native
from tgp_tpu_torch.precoarsen import (PRECOARSENERS, PreCoarsening,
                                      precoarsen_graph, register_precoarsener)
from tgp_tpu_torch.precoarsen.eigenpool import (eigenpool_from_labels,
                                                eigenpool_level,
                                                spectral_clustering)
from tgp_tpu_torch.precoarsen.ndp import ndp_level
from tgp_tpu_torch.precoarsen.nmf import nmf_level, non_negative_factorization


def er_graph(n, p, seed, weighted=False):
    rng = np.random.default_rng(seed)
    up = np.triu(rng.random((n, n)) < p, 1)
    s, r = np.nonzero(up | up.T)
    ei = np.stack([s, r]).astype(np.int64)
    w = None
    if weighted:
        wu = rng.random((n, n)) + 0.1
        w = (wu + wu.T)[s, r]
    return ei, n, w


def sbm_graph(sizes, p_in, p_out, seed):
    rng = np.random.default_rng(seed)
    block = np.repeat(np.arange(len(sizes)), sizes)
    n = block.size
    p = np.where(block[:, None] == block[None, :], p_in, p_out)
    up = np.triu(rng.random((n, n)) < p, 1)
    s, r = np.nonzero(up | up.T)
    return np.stack([s, r]).astype(np.int64), n, None


GRAPHS = {
    "er": lambda: er_graph(30, 0.15, 0),
    "er_small": lambda: er_graph(10, 0.4, 1),
    "er_large": lambda: er_graph(40, 0.1, 2),
    "sbm": lambda: sbm_graph([12, 12, 12], 0.5, 0.04, 3),
    "weighted": lambda: er_graph(25, 0.2, 4, weighted=True),
    "edgeless": lambda: (np.zeros((2, 0), np.int64), 3, None),
    "single": lambda: (np.zeros((2, 0), np.int64), 1, None),
    "two_components": lambda: (np.asarray([[0, 1, 3, 4], [1, 0, 4, 3]]), 6,
                               None),
}
KWARGS = {"graclus": {}, "ndp": {}, "sep": {}, "nmf": {"k": 4},
          "eigen": {"k": 4}}


def assert_levels_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.fixture
def numpy_engine(monkeypatch):
    """The port with no C++ compiler on PATH (its numpy twins)."""
    monkeypatch.setattr(_native, "compiler", lambda: None)
    monkeypatch.setattr(_native, "_lib", None)


@pytest.fixture
def jax_python_engines(monkeypatch):
    """JAX's level functions on their numpy/Python twins (its loader
    falls back to them on any exception)."""
    def fail(*a, **k):
        raise OSError("native library disabled")

    monkeypatch.setattr(j_native_mod, "native_graclus_matching", fail)
    monkeypatch.setattr(j_sep_mod, "_sep_coding_tree_native", fail)


#: graphs of 40 nodes and more: NDP's eigenvector from ARPACK, whose start
#: JAX leaves unseeded (held by the next test instead)
ARPACK_GRAPHS = ("er_large",)


def same_side_or_complement(got, want, edge_index):
    """Whether the kept nodes of two NDP levels are the same or each
    other's complement, on the nodes with an edge (an isolated node's
    eigenvector entry is 0: kept on either sign)."""
    n = got["cluster_index"].shape[0]
    has_edge = np.bincount(np.asarray(edge_index).reshape(-1),
                           minlength=n) > 0
    kept = (got["cluster_index"] >= 0)[has_edge]
    j_kept = (want["cluster_index"] >= 0)[has_edge]
    return np.array_equal(kept, j_kept) or np.array_equal(kept, ~j_kept)


@pytest.mark.parametrize("alias,graph", [
    (a, g) for a in ("graclus", "ndp", "sep") for g in sorted(GRAPHS)
    if not (a == "ndp" and g in ARPACK_GRAPHS)])
def test_levels_equal_jax_native(alias, graph):
    ei, n, w = GRAPHS[graph]()
    before = dict(_native.engine_runs)
    got = precoarsen_graph(alias, ei, n, w, levels=2)
    if alias != "ndp":
        assert _native.engine_runs["native"] > before["native"]
        assert _native.engine_runs["numpy"] == before["numpy"]
    assert_levels_equal(got, j_precoarsen(alias, ei, n, w, levels=2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ndp_arpack_level_is_seeded_where_jax_flips(seed):
    """At 40 nodes and more NDP's eigenvector comes from ARPACK, whose
    start JAX leaves unseeded: its kept side flips from call to call.  The
    port's start is drawn from ``seed``: the same level every call, which
    keeps JAX's nodes or their complement (and equals JAX's level when it
    keeps the same side)."""
    ei, n, w = er_graph(40 + 10 * seed, 0.12, seed)
    got = ndp_level(ei, n, w, seed=seed)
    assert_levels_equal([ndp_level(ei, n, w, seed=seed)], [got])
    want = j_ndp(ei, n, w, seed=seed)
    assert same_side_or_complement(got, want, ei)
    if np.array_equal(got["cluster_index"], want["cluster_index"]):
        assert_levels_equal([got], [want])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("alias", ["graclus", "sep"])
def test_levels_equal_jax_numpy_engine(alias, graph, numpy_engine,
                                       jax_python_engines):
    ei, n, w = GRAPHS[graph]()
    before = dict(_native.engine_runs)
    got = precoarsen_graph(alias, ei, n, w, levels=2)
    assert _native.engine_runs["numpy"] > before["numpy"]
    assert _native.engine_runs["native"] == before["native"]
    assert_levels_equal(got, j_precoarsen(alias, ei, n, w, levels=2))


@pytest.mark.parametrize("max_height", [2, 3])
def test_sep_deeper_trees_equal_jax(max_height):
    ei, n, w = GRAPHS["sbm"]()
    got = precoarsen_graph("sep", ei, n, w, levels=max_height - 1,
                           max_height=max_height)
    assert_levels_equal(got, j_precoarsen("sep", ei, n, w,
                                          levels=max_height - 1,
                                          max_height=max_height))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_nmf_level_equals_sklearn_through_jax(graph):
    ei, n, w = GRAPHS[graph]()
    for k in (1, 4, 8):
        assert_levels_equal([nmf_level(ei, n, w, k=k, seed=3)],
                            [j_nmf(ei, n, w, k=k, seed=3)])


def test_non_negative_factorization_matches_sklearn():
    from sklearn.decomposition import non_negative_factorization as sk_nmf

    rng = np.random.default_rng(0)
    for shape, k in (((20, 20), 4), ((30, 12), 3)):
        X = np.abs(rng.normal(size=shape))
        W, H, it = non_negative_factorization(X, k, seed=5, max_iter=300)
        sW, sH, sit = sk_nmf(X, n_components=k, init="random",
                             random_state=5, max_iter=300)
        assert it == sit
        np.testing.assert_array_equal(W, sW)
        np.testing.assert_array_equal(H, sH)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_eigenpool_labels_equal_sklearn_through_jax(graph):
    ei, n, w = GRAPHS[graph]()
    for k, modes in ((4, 3), (8, 2)):
        want = j_eigen(ei, n, w, k=k, num_modes=modes, seed=2)
        got = eigenpool_level(ei, n, w, k=k, num_modes=modes, seed=2)
        np.testing.assert_array_equal(got["cluster_index"],
                                      want["cluster_index"])
        assert_levels_equal([got], [want])


@pytest.mark.parametrize("graph", ["er", "sbm", "weighted", "two_components"])
@pytest.mark.parametrize("normalized,degree_norm", [(True, True),
                                                    (False, False)])
def test_eigenpool_theta_and_pooled_edges_from_jax_labels(graph, normalized,
                                                          degree_norm):
    ei, n, w = GRAPHS[graph]()
    want = j_eigen(ei, n, w, k=6, num_modes=3, seed=1,
                   normalized=normalized, degree_norm=degree_norm)
    got = eigenpool_from_labels(ei, n, w, labels=want["cluster_index"], k=6,
                                num_modes=3, normalized=normalized,
                                degree_norm=degree_norm)
    assert_levels_equal([got], [want])


def test_spectral_clustering_matches_sklearn():
    from sklearn.cluster import SpectralClustering

    ei, n, _ = GRAPHS["sbm"]()
    A = np.zeros((n, n))
    A[ei[0], ei[1]] = 1.0
    for k, seed in ((3, 0), (5, 7)):
        want = SpectralClustering(n_clusters=k, affinity="precomputed",
                                  random_state=seed,
                                  assign_labels="discretize").fit_predict(
                                      A + 1e-12)
        np.testing.assert_array_equal(spectral_clustering(A + 1e-12, k, seed),
                                      want)


@pytest.mark.parametrize("graph", ["er", "er_large", "sbm", "weighted"])
def test_ndp_lobpcg_keeps_jax_nodes_or_their_complement(graph):
    ei, n, w = GRAPHS[graph]()
    got = ndp_level(ei, n, w, eigensolver="lobpcg", device="cpu")
    want = j_ndp(ei, n, w, eigensolver="lobpcg")
    assert same_side_or_complement(got, want, ei)
    if np.array_equal(got["cluster_index"], want["cluster_index"]):
        assert_levels_equal([got], [want])


def test_ndp_lobpcg_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ei, n, w = GRAPHS["er"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ndp_level(ei, n, w, eigensolver="lobpcg")
    ndp_level(ei, n, w)  # the host eigensolvers need no device


@pytest.mark.parametrize("poolers,levels,kwargs", [
    ("graclus", 2, {}),
    (("nmf", {"k": 4}), 2, {}),
    ([("ndp", {}), ("graclus", {})], 1, {}),
    (["graclus", "graclus", ("sep", {})], 1, {}),
    ("eigen", 1, {"k": 5, "num_modes": 2}),
    ([("eigen", {"k": 8}), ("eigen", {"k": 3})], 1, {}),
])
@pytest.mark.parametrize("with_weight_and_label", [False, True])
def test_precoarsening_transform_equals_jax(poolers, levels, kwargs,
                                            with_weight_and_label):
    ei, n, w = GRAPHS["sbm"]()
    x = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    g = (x, ei)
    if with_weight_and_label:
        g = (x, ei, np.ones(ei.shape[1], np.float32), np.int64(1))
    got = PreCoarsening(poolers, levels, kwargs)(g)
    want = JPreCoarsening(poolers, levels, kwargs)(g)
    assert len(got) == len(want)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    assert_levels_equal(got[-1], want[-1])


def test_precoarsening_rejects_a_bad_config():
    ei, n, _ = GRAPHS["er"]()
    g = (np.zeros((n, 2), np.float32), ei)
    with pytest.raises(ValueError, match="per-level pooler config"):
        PreCoarsening([("graclus", {}), 3])(g)
    with pytest.raises(ValueError, match="unknown precoarsener"):
        precoarsen_graph("bogus", ei, n)


def test_register_precoarsener_both_forms():
    def fake(edge_index, num_nodes, edge_weight=None, **kw):
        return {"kind": "sparse", "cluster_index": np.zeros(num_nodes,
                                                            np.int64),
                "weight": np.ones(num_nodes, np.float32), "num_clusters": 1,
                "edge_index": np.zeros((2, 0), np.int64),
                "edge_weight": np.zeros(0, np.float32), "partial": False}

    try:
        register_precoarsener("fake_call", fake)
        register_precoarsener("fake_deco")(fake)
        for alias in ("fake_call", "fake_deco"):
            out = precoarsen_graph(alias, np.zeros((2, 0), np.int64), 4,
                                   levels=2)
            assert [lv["num_clusters"] for lv in out] == [1, 1]
    finally:
        PRECOARSENERS.pop("fake_call", None)
        PRECOARSENERS.pop("fake_deco", None)


def test_native_library_is_built_from_the_port_and_named_by_its_hash():
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.name.startswith("libtgp_native-")
    assert "tgp_tpu_torch" not in str(path.parent) and \
        path.parent.name == "build"
    _native.load()
    assert path.exists()


def test_native_build_failure_raises_with_compiler_output(monkeypatch,
                                                          tmp_path):
    if _native.compiler() is None:
        pytest.skip("no C++ compiler")
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        _native.load()
    # a level function does not fall back to numpy on a failing build
    ei, n, w = GRAPHS["er"]()
    with pytest.raises(RuntimeError, match="building native.cpp failed"):
        precoarsen_graph("graclus", ei, n, w)


def test_numpy_twins_only_without_a_compiler(monkeypatch):
    monkeypatch.setattr(_native, "_lib", None)
    assert _native.available() == (_native.compiler() is not None)
    monkeypatch.setattr(_native, "compiler", lambda: None)
    assert not _native.available()
    before = dict(_native.engine_runs)
    ei, n, w = GRAPHS["er"]()
    precoarsen_graph("graclus", ei, n, w)
    assert _native.engine_runs["numpy"] == before["numpy"] + 1
    assert _native.engine_runs["native"] == before["native"]


def test_native_functions_refuse_edge_ids_out_of_range():
    ei = np.array([[0, 5], [1, 0]])
    for call in (lambda: _native.native_graclus_matching(ei, 3),
                 lambda: _native.native_sep_merge(ei, 3),
                 lambda: _native.native_maximal_matching(ei, 3, [0, 1]),
                 lambda: _native.native_propagate_assignments(
                     ei, np.full(3, -1), 2, 1)):
        with pytest.raises(ValueError, match="edge ids"):
            call()


def test_native_matching_and_propagation_match_jax():
    """The two native functions off the precoarsening path give JAX's
    library's output on the same inputs."""
    ei, n, _ = GRAPHS["sbm"]()
    rank = np.random.default_rng(0).permutation(ei.shape[1])
    np.testing.assert_array_equal(
        _native.native_maximal_matching(ei, n, rank),
        j_native_mod.native_maximal_matching(ei, n, rank))
    assign = np.full(n, -1)
    assign[[0, 12, 24]] = [0, 1, 2]
    np.testing.assert_array_equal(
        _native.native_propagate_assignments(ei, assign, 10, 3),
        j_native_mod.native_propagate_assignments(ei, assign, 10, 3))
