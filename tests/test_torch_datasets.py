"""The port's datasets (numpy copies) against ``tgp_tpu``'s: every
generator on the same seeds, every parser on ``tests/fixtures/`` and on
files written here, bit for bit, and the same errors.  The Gset download
is monkeypatched to fail in both packages, so no test reaches the
network."""

import shutil
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import tgp_tpu.datasets as J
import tgp_tpu_torch.datasets as T
from tgp_tpu_torch.graph import GraphBatch

FIX = Path("tests/fixtures")


def _same(a, b, what=""):
    """Equal nested tuples/lists/dicts of arrays and scalars, dtypes
    included."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def test_public_names():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert len(T.__all__) == 13
    assert T.PYGSP_GRAPHS == J.PYGSP_GRAPHS


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_graphs=3, num_nodes=40, num_communities=3, seed=5),
    dict(num_nodes=150, num_communities=4, p_in=0.35, p_out=0.03,
         feature_dim=16, mu=1.2, seed=1),
    dict(num_nodes=60, gmm_components=3, seed=2),
    dict(num_nodes=80, p_in=0.01, p_out=0.001, require_connected=False,
         seed=3)])
def test_csbm_equal(kw):
    a, b = J.CSBMDataset(**kw), T.CSBMDataset(**kw)
    assert len(a) == len(b)
    for i in range(len(a)):
        _same(a[i], b[i], f"csbm {kw} #{i}")


def test_csbm_disconnected_raises_alike():
    kw = dict(num_nodes=50, p_in=0.0, p_out=0.0, max_retries=3)
    for mod in (J, T):
        with pytest.raises(RuntimeError, match="stayed disconnected"):
            mod.CSBMDataset(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(parts=(3, 5, 2, 4),
                                             feature_dim=3, seed=9)])
def test_multipartite_equal(kw):
    a, b = J.MultipartiteGraphDataset(**kw), T.MultipartiteGraphDataset(**kw)
    assert len(a) == len(b) == 1
    _same(a[0], b[0], "multipartite")


def test_synthetic_equal():
    a = J.SyntheticGraphClassification(num_graphs=30, seed=4).generate()
    b = T.SyntheticGraphClassification(num_graphs=30, seed=4).generate()
    _same(a, b, "synthetic")
    args = (40, 3, 0.3, 0.05, 5)
    _same(J.csbm_graph(np.random.default_rng(2), *args),
          T.csbm_graph(np.random.default_rng(2), *args), "csbm_graph")


@pytest.mark.parametrize("name", J.PYGSP_GRAPHS)
def test_pygsp_graph_equal(name):
    _same(J.pygsp_graph(name, n=36, seed=1), T.pygsp_graph(name, n=36,
                                                           seed=1), name)


@pytest.mark.parametrize("name,match", [("Minnesota", "pygsp"),
                                        ("Bogus", "not available")])
def test_pygsp_errors_alike(name, match):
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            mod.pygsp_graph(name)
    for mod in (J, T):
        with pytest.raises(ValueError, match="n·k even"):
            mod.pygsp_graph("RandomRegular", n=5, k=3)


def test_pygsp_dataset_batch_is_the_ports():
    ds = T.PyGSPDataset(name="Sensor", n=32, seed=0)
    _same(ds.load(), J.PyGSPDataset(name="Sensor", n=32, seed=0).load())
    batch = ds.as_graph_batch(device="cpu")
    jb = J.PyGSPDataset(name="Sensor", n=32, seed=0).as_graph_batch()
    assert isinstance(batch, GraphBatch)
    for f in ("x", "senders", "receivers", "edge_weight", "node_mask",
              "edge_mask"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ds.as_graph_batch()


@pytest.mark.parametrize("name", ["MINI", "MINI2", "PROTEINS_SYN",
                                  "NCI1_SYN"])
@pytest.mark.parametrize("attrs", [(True, True), (False, True),
                                   (True, False)])
def test_tu_parse_equal(name, attrs):
    a = J.parse_tu_dir(FIX / "tu", name, *attrs)
    b = T.parse_tu_dir(FIX / "tu", name, *attrs)
    _same(a, b, name)
    da = J.TUDataset(root=str(FIX / "tu"), name=name)
    db = T.TUDataset(root=str(FIX / "tu"), name=name)
    _same(da.load(), db.load(), name)
    assert (da.num_classes, da.num_features) == (db.num_classes,
                                                 db.num_features)
    _same(da.edge_attributes(), db.edge_attributes())


def test_tu_edge_attributes_with_labels_equal(tmp_path):
    src, dst = FIX / "tu" / "MINI2", tmp_path / "MINI2"
    shutil.copytree(src, dst)
    n_edges = len((src / "MINI2_A.txt").read_text().strip().splitlines())
    attrs = "\n".join(f"{i * 0.5}, {i * 0.25}" for i in range(n_edges))
    (dst / "MINI2_edge_attributes.txt").write_text(attrs + "\n")
    _same(J.parse_tu_dir(str(tmp_path), "MINI2"),
          T.parse_tu_dir(str(tmp_path), "MINI2"))


def test_tu_degree_feature_fallback_equal(tmp_path):
    """A TU directory without node labels or attributes: degree
    features in both."""
    dst = tmp_path / "BARE"
    dst.mkdir()
    src = FIX / "tu" / "MINI2"
    for part in ("A", "graph_indicator", "graph_labels"):
        shutil.copy(src / f"MINI2_{part}.txt", dst / f"BARE_{part}.txt")
    _same(J.parse_tu_dir(str(tmp_path), "BARE"),
          T.parse_tu_dir(str(tmp_path), "BARE"))


def test_tu_missing_raises_alike(tmp_path):
    for mod in (J, T):
        with pytest.raises(FileNotFoundError, match="NOPE"):
            mod.TUDataset(root=str(tmp_path), name="NOPE").load()


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_gcb_equal(split):
    a = J.GraphClassificationBench(root=str(FIX / "gcb"), split=split).load()
    b = T.GraphClassificationBench(root=str(FIX / "gcb"), split=split).load()
    _same(a, b, split)


def test_gcb_names_and_errors_alike(tmp_path):
    for easy in (True, False):
        for small in (True, False):
            assert (J.GraphClassificationBench(easy=easy,
                                               small=small).file_name
                    == T.GraphClassificationBench(easy=easy,
                                                  small=small).file_name)
    for mod in (J, T):
        with pytest.raises(RuntimeError, match="zero-egress"):
            mod.GraphClassificationBench(root=str(tmp_path)).load()
        with pytest.raises(AssertionError):
            mod.GraphClassificationBench(root=str(FIX / "gcb"),
                                         split="dev").load()


def test_expwl1_equal():
    _same(J.EXPWL1Dataset(root=str(FIX / "expwl1")).load(),
          T.EXPWL1Dataset(root=str(FIX / "expwl1")).load())


def test_expwl1_missing_raises_alike(tmp_path):
    for mod in (J, T):
        with pytest.raises(RuntimeError, match="zero-egress"):
            mod.EXPWL1Dataset(root=str(tmp_path)).load()


def test_parse_gset_equal(tmp_path):
    f = tmp_path / "G99"
    rng = np.random.default_rng(0)
    lines = ["12 20"] + [f"{rng.integers(1, 13)} {rng.integers(1, 13)} "
                         f"{rng.choice([-1, 1])}" for _ in range(20)]
    f.write_text("\n".join(lines) + "\n")
    _same(J.parse_gset(f), T.parse_gset(f))


def test_gset_download_fails_alike(tmp_path, monkeypatch):
    """A missing file: the loader tries the download (here a stub that
    fails, as without a network) and raises naming the path."""
    tried = []

    def no_network(url, path):
        tried.append(url)
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    for mod in (J, T):
        root = tmp_path / mod.__name__
        with pytest.raises(RuntimeError,
                           match="not found and download failed") as err:
            mod.GsetDataset(name="G0", root=str(root)).load()
        assert str(root / "G0") in str(err.value)
    assert len(tried) == 2 and tried[0] == tried[1]


def test_gset_present_file_is_parsed(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda *a: pytest.fail("download attempted"))
    (tmp_path / "G1").write_text("3 2\n1 2 1\n2 3 -1\n")
    _same(J.GsetDataset(name="G1", root=str(tmp_path)).load(),
          T.GsetDataset(name="G1", root=str(tmp_path)).load())


def test_typing_aliases_equal():
    import typing

    from tgp_tpu.utils import typing as jt
    from tgp_tpu_torch.utils import typing as tt

    assert tt.__all__ == jt.__all__
    for name in jt.__all__:
        assert typing.get_args(getattr(tt, name)) == \
            typing.get_args(getattr(jt, name)), name
