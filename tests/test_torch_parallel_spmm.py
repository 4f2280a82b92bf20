"""``tgp_tpu_torch.parallel.spmm`` against ``tgp_tpu.parallel.spmm``, case
for case with ``tests/parallel/test_sharded.py`` (the SpMM cases) and
``tests/parallel/test_comm_model.py``: the port's gloo world of D = 4 CPU
ranks (one world for the file, every case run in it) against JAX on 4 of
its 8 virtual devices, on the same numpy inputs.  Partitions and
relabellings are equal; values within rtol = atol = 1e-4, as the JAX
tests ask; the comm model read from the port's collective log (one
``all_gather`` of ``[n_pad, F]`` and no ``psum`` for the gather variant;
one ``[rows_per, F]`` send a ring step and no ``all_gather`` for the
ring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tgp_tpu.ops.sparse import spmm
from tgp_tpu.parallel import spmm as J
from tgp_tpu_torch.parallel import spmm as T
from tgp_tpu_torch.parallel.launch import spawn_world
from tests.torch_parallel_ranks import spmm_cases

D = 4
TOL = dict(rtol=1e-4, atol=1e-4)


def _graph(seed, n=64, e=400, F=16):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return s, r, w, x


def _powerlaw_graph(n=256, e=4096, alpha=1.5, seed=0):
    rng = np.random.default_rng(seed)
    p = (1.0 + np.arange(n)) ** -alpha
    p /= p.sum()
    r = rng.choice(n, size=e, p=p).astype(np.int32)
    s = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    return s, r, w, n


def _cotangent(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    cases = {}
    for name, seed in (("sharded", 0), ("ring", 3)):
        s, r, w, x = _graph(seed)
        cases[name] = (s, r, w, x, _cotangent(seed + 10, x.shape))
    for name, seed in (("gather_comm", 1), ("ring_comm", 2)):
        s, r, w, _ = _graph(seed, n=128, e=1024)
        cases[name] = (s, r, w, 128, 16)
    s, r, w, n = _powerlaw_graph(n=64, e=1024, seed=3)
    x = np.random.default_rng(4).normal(size=(n, 8)).astype(np.float32)
    cases["balanced"] = (s, r, w, x)
    ranks = spawn_world(spmm_cases, D, "gloo", 120, args=(cases,))
    return cases, ranks


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:D]), ("gp",))


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _spmm_and_grad(s, r, w, x, g):
    fn = lambda xx: spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),  # noqa: E731
                         xx, x.shape[0])
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def test_partitions_equal_jax():
    s, r, w, _ = _graph(0)
    for part in ("partition_edges", "partition_edges_2d"):
        for d in (1, 3, D):
            got = getattr(T, part)(s, r, w, 64, d, device="cpu")
            ref = getattr(J, part)(s, r, w, 64, d)
            for a, b in zip(got[:3], ref[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert got[3:] == ref[3:]


def test_sharded_spmm_matches_single_device(world, jmesh):
    cases, ranks = world
    s, r, w, x, g = cases["sharded"]
    expect, expect_dx = _spmm_and_grad(s, r, w, x, g)
    n = x.shape[0]
    np.testing.assert_allclose(_rows(ranks, "sharded")[:n], expect, **TOL)
    # the all_gather's backward (a reduce-scatter) gives each rank its
    # whole cotangent: off by a factor of D if the convention slipped
    np.testing.assert_allclose(_rows(ranks, "sharded_dx")[:n], expect_dx,
                               **TOL)
    # and JAX's own sharded SpMM on 4 devices
    S, R, W, n_pad, rows_per = J.partition_edges(s, r, w, n, D)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n] = x
    with jmesh:
        jout = J.make_sharded_spmm(jmesh, rows_per)(jnp.asarray(x_pad), S,
                                                    R, W)
    np.testing.assert_allclose(_rows(ranks, "sharded"), np.asarray(jout),
                               **TOL)
    assert all(rk["sharded_repeat_equal"] for rk in ranks)


def test_ring_halo_spmm_matches(world, jmesh):
    cases, ranks = world
    s, r, w, x, g = cases["ring"]
    expect, expect_dx = _spmm_and_grad(s, r, w, x, g)
    n = x.shape[0]
    np.testing.assert_allclose(_rows(ranks, "ring")[:n], expect, **TOL)
    np.testing.assert_allclose(_rows(ranks, "ring_dx")[:n], expect_dx, **TOL)
    S, R, W, n_pad, rows_per = J.partition_edges_2d(s, r, w, n, D)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n] = x
    with jmesh:
        jout = J.make_ring_halo_spmm(jmesh, rows_per, D)(jnp.asarray(x_pad),
                                                         S, R, W)
    np.testing.assert_allclose(_rows(ranks, "ring"), np.asarray(jout), **TOL)
    assert all(rk["ring_repeat_equal"] for rk in ranks)


def test_gather_spmm_comm_volume_matches_model(world):
    _, ranks = world
    for rk in ranks:
        log, n_pad, rows_per = rk["gather_comm"]
        gathers = [e for e in log if e[0] == "all_gather"]
        assert len(gathers) == 1, log
        # the gather materializes the full [N_pad, F] f32 matrix
        assert gathers[0][3] == n_pad * 16 * 4, log
        assert not [e for e in log if e[0] in ("psum", "ppermute")], log
        assert len(log) == 1


def test_ring_halo_comm_volume_matches_model(world):
    _, ranks = world
    for rk in ranks:
        log, n_pad, rows_per = rk["ring_comm"]
        sends = [e for e in log if e[0] == "ppermute"]
        assert len(sends) == D - 1, log
        # every rotation moves exactly one [rows_per, F] shard
        for e in sends:
            assert e[1] == (rows_per, 16) and e[3] == rows_per * 16 * 4, log
        assert not [e for e in log if e[0] == "all_gather"], log


def _bucket_counts(receivers, n_pad, rows_per):
    owner = np.asarray(receivers) // rows_per
    return np.bincount(owner, minlength=n_pad // rows_per)


def test_balanced_order_bounds_bucket_waste():
    s, r, w, n = _powerlaw_graph()
    n_pad = ((n + D - 1) // D) * D
    rows_per = n_pad // D
    contiguous = _bucket_counts(r, n_pad, rows_per)
    perm, inv = (t.numpy() for t in T.balanced_node_order(r, n, D,
                                                          device="cpu"))
    jperm, jinv = J.balanced_node_order(r, n, D)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    balanced = _bucket_counts(inv[r], n_pad, rows_per)
    mean = len(r) / D
    assert contiguous.max() > 2.0 * mean
    hub = int(np.bincount(r, minlength=n_pad).max())
    assert balanced.max() <= max(hub, int(4 / 3 * mean) + 1)
    assert balanced.max() <= 0.7 * contiguous.max()
    assert sorted(perm) == list(range(n_pad))
    np.testing.assert_array_equal(perm[inv], np.arange(n_pad))


def test_balanced_order_preserves_spmm_results(world):
    cases, ranks = world
    s, r, w, x = cases["balanced"]
    n = x.shape[0]
    expect = np.asarray(spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                             jnp.asarray(x), n))
    perm, inv = J.balanced_node_order(r, n, D, senders=s)
    out_perm = _rows(ranks, "balanced")
    np.testing.assert_allclose(out_perm[inv[:n]], expect, **TOL)


def test_balanced_order_unskewed_is_near_noop_waste():
    rng = np.random.default_rng(5)
    n, e = 256, 4096
    r = rng.integers(0, n, e).astype(np.int32)
    perm, inv = T.balanced_node_order(r, n, D, device="cpu")
    np.testing.assert_array_equal(inv.numpy(), J.balanced_node_order(r, n,
                                                                     D)[1])
    balanced = _bucket_counts(inv.numpy()[r], n, n // D)
    assert balanced.max() < 1.15 * e / D
