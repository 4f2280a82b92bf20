"""Negative edge sampling in the port (``ops/sampling.py``) against the
JAX package: the two membership tests (exact keys, and the degree window
past 46,340 nodes), the per-graph cap and the bipartite sampler's
collision test, each on the same queries; then the sampler's contract,
as ``tests/ops/test_sampling.py`` checks JAX's (the draws themselves come
from a ``torch.Generator``, not JAX's keys).  Every comparison is exact
(integer and boolean results)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops import sampling as J
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.ops import sampling as T

CPU = dict(device="cpu")


def _edges(rng, n, e, n_dst=None):
    s = rng.integers(0, n, e)
    r = rng.integers(0, n if n_dst is None else n_dst, e)
    m = rng.random(e) < 0.85
    return s, r, m


def _queries(rng, s, r, m, n, q, n_dst=None):
    """Half real edges (some masked), half random pairs."""
    pick = rng.integers(0, s.shape[0], q // 2)
    qs = np.concatenate([s[pick], rng.integers(0, n, q - q // 2)])
    qr = np.concatenate([r[pick], rng.integers(
        0, n if n_dst is None else n_dst, q - q // 2)])
    return qs, qr


@pytest.mark.parametrize("n", [40, 46340])
def test_exact_membership_matches_jax(n):
    rng = np.random.default_rng(n)
    s, r, m = _edges(rng, n, 600)
    qs, qr = _queries(rng, s, r, m, n, 400)
    j = J._is_edge_exact(J._edge_key_table(*map(jnp.asarray, (s, r, m)), n),
                         jnp.asarray(qs), jnp.asarray(qr), n)
    t = T._is_edge_exact(T._edge_key_table(*map(torch.tensor, (s, r, m)), n),
                         torch.tensor(qs), torch.tensor(qr), n)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.any() and not t.all()


@pytest.mark.parametrize("cap", [256, 4])
def test_windowed_membership_matches_jax(cap):
    """The window past 46,340 nodes, a cap below some senders' degree
    included (both give the same false negatives)."""
    rng = np.random.default_rng(cap)
    n = 60000
    s, r, m = _edges(rng, 300, 900)  # senders of degree ~3, some above 4
    qs, qr = _queries(rng, s, r, m, 300, 400)
    j = J._is_edge_windowed(*map(jnp.asarray, (s, r, m)), n,
                            jnp.asarray(qs), jnp.asarray(qr), cap=cap)
    t = T._is_edge_windowed(*map(torch.tensor, (s, r, m)), n,
                            torch.tensor(qs), torch.tensor(qr), cap=cap)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.any()


def test_cap_samples_per_graph_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(200) < 0.7
    seg = np.sort(rng.integers(0, 6, 200))
    rng.shuffle(seg[100:])
    for cap in (1, 5, 40):
        j = J.cap_samples_per_graph(jnp.asarray(mask), jnp.asarray(seg), 6,
                                    cap)
        t = T.cap_samples_per_graph(torch.tensor(mask), torch.tensor(seg), 6,
                                    cap)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("num_src,num_dst", [(30, 50), (50000, 50000)],
                         ids=["exact", "windowed"])
def test_bipartite_collisions_match_jax(num_src, num_dst):
    """One round: a sample is kept iff JAX's collision test (the exact
    key table, or the window where ``num_src · num_dst`` passes int32) on
    the same pair says it is no edge; in range, fixed for a generator."""
    rng = np.random.default_rng(num_src)
    s, r, m = _edges(rng, min(num_src, 30), 400, n_dst=min(num_dst, 50))
    ts, tr, tm = map(torch.tensor, (s, r, m))

    def draw(seed, rounds):
        return T.bipartite_negative_edge_sampling(
            ts, tr, tm, num_src, num_dst, torch.Generator().manual_seed(seed),
            num_samples=300, num_rounds=rounds)

    src, dst, keep = draw(0, 1)
    assert src.shape == (300,) and 0 <= src.min() and src.max() < num_src
    assert 0 <= dst.min() and dst.max() < num_dst
    js, jr, jm = map(jnp.asarray, (s, r, m))
    q = (jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()))
    if num_src * num_dst <= 2 ** 31 - 1:
        hit = J._is_edge_exact(J._edge_key_table(js, jr, jm, num_dst), *q,
                               num_dst)
    else:
        hit = J._is_edge_windowed(js, jr, jm, num_src, *q)
    np.testing.assert_array_equal(keep.numpy(), ~np.asarray(hit))
    if num_src < 100:
        assert not keep.all()  # a dense bipartite graph collides
    a, b = draw(1, 3), draw(1, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _batch(sizes, seed, **kw):
    rng = np.random.default_rng(seed)
    graphs = []
    for n in sizes:
        e = max(1, int(0.3 * n * n)) if n < 100 else n // 4
        ei = rng.integers(0, n, (2, e))
        graphs.append((rng.normal(size=(n, 3)).astype(np.float32), ei))
    return graphs, t_from(graphs, **kw, **CPU), j_from(graphs, **kw)


@pytest.mark.parametrize("force_undirected", [False, True])
@pytest.mark.parametrize("sizes", [(10, 7, 12), (46400,)],
                         ids=["exact", "windowed"])
def test_negative_sampling_contract(sizes, force_undirected):
    """Each kept pair lies in its slot's graph, is no self-loop and no
    edge (nor a reversed one with ``force_undirected``); slots past the
    real edges stay masked; a generator's seed fixes the draws; after one
    round, the mask is exactly JAX's membership test on the same pairs."""
    graphs, tb, jb = _batch(sizes, len(sizes), pad_edges=None)

    def draw(seed, rounds=3):
        return T.negative_edge_sampling(
            tb, torch.Generator().manual_seed(seed), num_rounds=rounds,
            force_undirected=force_undirected)

    src, dst, mask = draw(0)
    ng, nm = tb.node_graph.numpy(), tb.node_mask.numpy()
    s, r, em = (a.numpy() for a in (tb.senders, tb.receivers, tb.edge_mask))
    real = set(zip(s[em].tolist(), r[em].tolist()))
    eg = ng[s]
    for e in np.nonzero(mask.numpy())[0]:
        a, b = int(src[e]), int(dst[e])
        assert nm[a] and nm[b] and ng[a] == ng[b] == eg[e] and a != b
        if len(sizes) > 1 or e < 2000:
            assert (a, b) not in real
            if force_undirected:
                assert (b, a) not in real
    assert not mask[~tb.edge_mask].any()
    assert int(mask.sum()) > 0.5 * int(em.sum())
    again = draw(0)
    assert all(torch.equal(x, y) for x, y in zip((src, dst, mask), again))
    assert not torch.equal(src, draw(1)[0])

    one = draw(2, rounds=1)
    N = tb.num_nodes
    js, jr, jm = (jnp.asarray(a) for a in (s, r, em))
    qs, qr = jnp.asarray(one[0].numpy()), jnp.asarray(one[1].numpy())
    if N <= J._EXACT_KEY_MAX_N:
        table = J._edge_key_table(js, jr, jm, N)
        hit = J._is_edge_exact(table, qs, qr, N)
        if force_undirected:
            hit = hit | J._is_edge_exact(table, qr, qs, N)
    else:
        hit = J._is_edge_windowed(js, jr, jm, N, qs, qr)
        if force_undirected:
            hit = hit | J._is_edge_windowed(js, jr, jm, N, qr, qs)
    want = em & ~np.asarray(hit | (qs == qr))
    np.testing.assert_array_equal(one[2].numpy(), want)


def test_bnpool_caps_its_negatives():
    """``num_neg_samples`` keeps at most that many negatives a graph."""
    from tgp_tpu_torch import get_pooler

    _, tb, _ = _batch((10, 7, 12), 9)
    pool = get_pooler("bnpool_u", in_channels=3, k=4, num_neg_samples=5,
                      sample_generator=torch.Generator().manual_seed(0),
                      **CPU)
    seen = {}
    real = T.negative_edge_sampling

    def spy(batch, generator, **kw):
        seen["neg"] = real(batch, generator, **kw)
        return seen["neg"]

    import tgp_tpu_torch.poolers.bnpool as bn

    bn.negative_edge_sampling, saved = spy, bn.negative_edge_sampling
    try:
        with torch.no_grad():
            pool(tb)
    finally:
        bn.negative_edge_sampling = saved
    src, _, mask = seen["neg"]
    capped = T.cap_samples_per_graph(mask, tb.node_graph[src.long()],
                                     tb.num_graphs, 5)
    counts = torch.bincount(tb.node_graph[src.long()][capped].long(),
                            minlength=3)
    assert (counts <= 5).all() and counts.sum() > 0
