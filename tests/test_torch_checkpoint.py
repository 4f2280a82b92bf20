"""The port's checkpoints (``torch.save`` of a state dict, published
atomically), its precoarsening cache (a numpy copy of ``tgp_tpu``'s: the
same config key and graph hash, an atomic ``put``, a corrupt entry as a
miss, a hit equal to the cold transform) and its capability cheatsheet
(every flag column equal to JAX's)."""

import os

import numpy as np
import pytest
import torch

from tests.utils_graphs import erdos_renyi_graph
from tgp_tpu.utils import cheatsheet as j_cheat
from tgp_tpu.utils import checkpoint as j_ckpt
from tgp_tpu_torch.models.clustering import ClusteringModel
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.precoarsen import PreCoarsening
from tgp_tpu_torch.utils import cheatsheet as cheat
from tgp_tpu_torch.utils import checkpoint as ckpt
from tgp_tpu_torch.utils.checkpoint import (PrecoarsenCache, restore_params,
                                            save_params)

CPU = dict(device="cpu")


def _model(seed):
    g = torch.Generator().manual_seed(seed)
    return ClusteringModel(get_pooler("mincut", in_channels=8, k=3,
                                      generator=g, **CPU),
                           hidden=8, in_channels=5, mp_type="gtv",
                           generator=g, **CPU)


@pytest.mark.parametrize("target", ["ck", "nested/ck"])
def test_params_roundtrip(tmp_path, target):
    a, b = _model(0), _model(1)
    path = tmp_path / target
    written = save_params(path, a)
    assert written == path.absolute() / ckpt.PARAMS_FILE and written.exists()
    assert not any(p.name.startswith(".") for p in written.parent.iterdir())
    assert restore_params(path, like=b) is b
    for (k, v), (k2, v2) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    sd = restore_params(path, **CPU)
    assert set(sd) == set(a.state_dict())
    assert all(v.device.type == "cpu" for v in sd.values())
    # a state dict saves the same way, and a second save replaces the first
    save_params(path, _model(2).state_dict())
    restore_params(path, like=b)
    assert torch.equal(b.conv.weight, _model(2).conv.weight)


def test_restore_defaults_to_the_card(tmp_path):
    save_params(tmp_path, _model(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            restore_params(tmp_path)


def test_restored_model_computes_the_same(tmp_path):
    from tgp_tpu_torch.graph import from_graphs

    graphs = [erdos_renyi_graph(12, p=0.4, num_features=5, seed=i)
              for i in range(2)]
    batch = from_graphs(graphs, **CPU)
    a = _model(0)
    torch.optim.SGD(a.parameters(), lr=0.1).zero_grad()
    a(batch)[1].loss_sum().backward()
    torch.optim.SGD(a.parameters(), lr=0.1).step()
    save_params(tmp_path, a)
    b = restore_params(tmp_path, like=_model(3))
    assert torch.equal(a(batch)[0], b(batch)[0])


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails while writing leaves the published checkpoint as
    it was and no file at the final name that a reader could take."""
    first = _model(0)
    save_params(tmp_path, first)
    before = (tmp_path / ckpt.PARAMS_FILE).read_bytes()
    real = torch.save
    seen = []

    def torn(obj, f, *a, **kw):
        seen.append(str(f))
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        save_params(tmp_path, _model(1))
    monkeypatch.setattr(torch, "save", real)
    assert seen and os.path.basename(seen[0]) != ckpt.PARAMS_FILE
    assert (tmp_path / ckpt.PARAMS_FILE).read_bytes() == before
    restore_params(tmp_path, like=_model(2))
    # and a fresh directory gets no final file at all
    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError):
        save_params(tmp_path / "new", first)
    assert not (tmp_path / "new" / ckpt.PARAMS_FILE).exists()


def _graphs():
    return [erdos_renyi_graph(12, p=0.4, num_features=3, seed=i)
            for i in range(3)]


def test_config_key_and_graph_hash_equal_jax():
    x, ei = _graphs()[0]
    w = np.linspace(0.5, 2, ei.shape[1]).astype(np.float32)
    for args in ((x, ei), (x, ei, w)):
        assert PrecoarsenCache.graph_hash(*args) == \
            j_ckpt.PrecoarsenCache.graph_hash(*args)
    cfg = {"poolers": "graclus", "levels": 2, "kwargs": {"a": 1}}
    assert ckpt._config_key(cfg) == j_ckpt._config_key(cfg)


def test_graph_hash_identity():
    """Shape, dtype and weights are part of a graph's identity."""
    x, ei = _graphs()[0]
    h = PrecoarsenCache.graph_hash
    base = h(x, ei)
    assert h(x.copy(), ei.copy()) == base
    assert h(x.reshape(x.shape[1], -1), ei) != base
    assert h(x.astype(np.float64), ei) != base
    assert h(x, ei.astype(np.int32)) != base
    w = np.ones(ei.shape[1], np.float32)
    assert h(x, ei, w) != base
    assert h(x, ei, w) != h(x, ei, 2 * w)
    # bytes moved across the x / edge_index boundary
    flat = np.concatenate([x.reshape(-1).view(np.uint8),
                           ei.reshape(-1).view(np.uint8)])
    x2 = flat[:x.nbytes - 4].view(np.uint8)
    assert h(x2, flat[x.nbytes - 4:]) != base


def _levels_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert set(la) == set(lb)
        for k in la:
            va, vb = la[k], lb[k]
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=k)
            else:
                assert va == vb, k


@pytest.mark.parametrize("poolers", ["graclus", "ndp"])
def test_cache_hit_returns_the_cold_levels(tmp_path, poolers):
    cache = PrecoarsenCache(root=str(tmp_path / "cache"))
    tf = PreCoarsening(poolers=poolers, levels=2)
    graphs = _graphs()
    cold = [tf(g) for g in graphs]
    first = cache.precoarsen_with_cache(tf, graphs)
    assert len(list((tmp_path / "cache").iterdir())) == len(graphs)
    hit = cache.precoarsen_with_cache(tf, graphs)
    for c, a, b in zip(cold, first, hit):
        assert len(c) == len(a) == len(b)
        for i in range(len(c) - 1):
            np.testing.assert_array_equal(c[i], b[i])
        _levels_equal(c[-1], a[-1])
        _levels_equal(c[-1], b[-1])


def test_cache_put_is_atomic_and_corrupt_entry_is_a_miss(tmp_path,
                                                         monkeypatch):
    cache = PrecoarsenCache(root=str(tmp_path))
    cfg = {"poolers": "graclus", "levels": 1, "kwargs": {}}
    levels = [{"cluster_index": np.arange(4)}]
    cache.put(cfg, "abc", levels)
    assert [p.name for p in tmp_path.iterdir()] == [
        cache._path(cfg, "abc").name]
    _levels_equal(cache.get(cfg, "abc"), levels)
    # a torn write: the final name is never touched
    real = np.savez_compressed

    def torn(path, **kw):
        open(path, "wb").write(b"PK\x03\x04 torn")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", torn)
    with pytest.raises(OSError):
        cache.put(cfg, "def", levels)
    monkeypatch.setattr(np, "savez_compressed", real)
    assert not cache._path(cfg, "def").exists()
    # a corrupt entry is a miss, and is removed
    cache._path(cfg, "bad").write_bytes(b"not an npz")
    assert cache.get(cfg, "bad") is None
    assert not cache._path(cfg, "bad").exists()
    assert cache.get(cfg, "missing") is None


def test_cheatsheet_flags_equal_jax():
    jr = {r["alias"]: r for r in j_cheat.cheatsheet_rows()}
    tr = {r["alias"]: r for r in cheat.cheatsheet_rows()}
    assert set(jr) == set(tr) and len(tr) == 21
    flags = ("sparse", "dense", "trainable", "aux_loss", "precoarsenable")
    for alias, r in tr.items():
        assert {f: r[f] for f in flags} == {f: jr[alias][f] for f in flags}, \
            alias
        assert r["class"] == jr[alias]["class"], alias
        assert isinstance(r["refs"], list) and len(r["refs"]) <= 2
    md = cheat.render_cheatsheet()
    assert md.startswith("| alias |") and md.count("\n") == 22
    # the table's check marks are the flags', row by row
    jmd = j_cheat.render_cheatsheet().splitlines()
    assert md.splitlines() == jmd
