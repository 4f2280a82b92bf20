"""The port's sparse ``global_reduce`` against ``tgp_tpu``'s, values and
gradients, on the same seeded numpy inputs (f32).

The port sums each graph's rows in a fixed order: a stable sort of the
graph ids, then K4 (``gather_segment_sum``: the rows read through the sort
order, masked ones skipped; its plain version on the CPU) over per-graph
offsets.  Tolerance: 1e-5 of Σ|terms| of each output
element (the sums of the two packages may add in other orders); a mean
divides both by the graph's count.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu_torch.ops.kernels.segment_spmm as K
from tgp_tpu.reduce.global_reduce import global_reduce as j_readout
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.poolers import get_pooler as t_get
from tgp_tpu_torch.reduce.global_reduce import global_reduce as t_readout

# the module (the package's ``global_reduce`` name is the function)
t_gr = importlib.import_module("tgp_tpu_torch.reduce.global_reduce")
torch.set_num_threads(1)
REL_TOL = 1e-5


def _padded(rng, n=40, feat=6, graphs=3):
    """Ascending ids: ``graphs`` graphs, the last holding padding nodes
    (node_mask False), as ``from_graphs`` lays them out."""
    ng = np.sort(rng.integers(0, graphs, n)).astype(np.int32)
    nm = rng.random(n) > 0.2
    pad = 6
    ng = np.concatenate([ng, np.full(pad, graphs - 1, np.int32)])
    nm = np.concatenate([nm, np.zeros(pad, bool)])
    x = rng.normal(size=(n + pad, feat)).astype(np.float32)
    return x, ng, nm, graphs


def _empty_graph(rng):
    x, ng, nm, b = _padded(rng, graphs=4)
    nm[ng == 1] = False  # graph 1 keeps no node
    return x, np.where(ng == 2, 3, ng).astype(np.int32), nm, b  # 2 empty


def _out_of_range(rng):
    x, ng, nm, b = _padded(rng)
    ng = ng.copy()
    ng[[0, 5, 17]] = [-1, b, 1000]
    return x, ng, nm, b


def _unsorted(rng):
    x, ng, nm, b = _padded(rng, graphs=5)
    return x, rng.permutation(ng).astype(np.int32), nm, b


def _no_mask(rng):
    x, ng, _, b = _unsorted(rng)
    return x, ng, None, b


def _nan_in_masked_rows(rng):
    """NaN and inf in masked rows: the kernel skips them (JAX selects 0)."""
    x, ng, nm, b = _unsorted(rng)
    x = x.copy()
    x[np.flatnonzero(~nm)[:2]] = np.array([[np.nan], [np.inf]])
    return x, ng, nm, b


CASES = {"padding in the last graph": _padded, "empty graphs": _empty_graph,
         "ids out of range": _out_of_range, "ids not ascending": _unsorted,
         "no mask, ids not ascending": _no_mask,
         "NaN in masked rows": _nan_in_masked_rows}


def _jax(x, ng, nm, b, op):
    return np.asarray(j_readout(
        jnp.asarray(x), node_graph=jnp.asarray(ng), num_graphs=b,
        node_mask=None if nm is None else jnp.asarray(nm), op=op))


def _torch(x, ng, nm, b, op):
    return t_readout(x, node_graph=torch.tensor(ng), num_graphs=b,
                     node_mask=None if nm is None else torch.tensor(nm),
                     op=op)


def _scale(x, ng, nm, b, op):
    """Σ|terms| of each output element (JAX's sum of |x|, or its mean)."""
    return _jax(np.abs(x), ng, nm, b, op)


def _close(got, ref, scale, what):
    err = np.abs(np.asarray(got) - ref)
    assert (err <= REL_TOL * scale + 1e-30).all(), (
        f"{what}: max |err| {err.max()}, worst err/scale "
        f"{(err / (scale + 1e-30)).max()}")


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_readout_matches_jax(case, op):
    x, ng, nm, b = CASES[case](np.random.default_rng(5))
    got = _torch(torch.tensor(x), ng, nm, b, op)
    assert got.shape == (b, x.shape[1]) and got.dtype == torch.float32
    _close(got.numpy(), _jax(x, ng, nm, b, op), _scale(x, ng, nm, b, op),
           f"{case} {op}")


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_readout_gradient_matches_jax(case, op):
    rng = np.random.default_rng(6)
    x, ng, nm, b = CASES[case](rng)
    R = rng.normal(size=(b, x.shape[1])).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda v: (j_readout(v, node_graph=jnp.asarray(ng), num_graphs=b,
                             node_mask=None if nm is None
                             else jnp.asarray(nm), op=op) * R).sum())(
        jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    (_torch(tx, ng, nm, b, op) * torch.tensor(R)).sum().backward()
    # each gradient element is one term, R[g] (over the count for a mean)
    _close(tx.grad.numpy(), ref, np.abs(ref), f"{case} {op} gradient")


@pytest.mark.parametrize("mode", ["masked", "compact"])
def test_readout_of_pooled_graphs_matches_jax(mode):
    """The pooled graph's rows, ids and mask as the models read them out:
    masked pooling keeps the collated ids, compact pooling's are
    ``arange // kmax``."""
    rng = np.random.default_rng(7)
    graphs = []
    for n in (23, 9, 31):
        s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        graphs.append((rng.normal(size=(n, 8)).astype(np.float32),
                       np.stack([s, r])))
    tb = t_from(graphs, sort_edges=True, pad_nodes=80, device="cpu")
    pool = t_get("topk", in_channels=8, ratio=0.5, pool_mode=mode,
                 device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = pool(tb).graph
    ng = g.node_graph.numpy()
    assert (np.diff(ng) >= 0).all()
    x, nm = g.x.numpy(), g.node_mask.numpy()
    for op in ("sum", "mean"):
        got = _torch(torch.tensor(x), ng, nm, g.num_graphs, op)
        _close(got.numpy(), _jax(x, ng, nm, g.num_graphs, op),
               _scale(x, ng, nm, g.num_graphs, op), f"{mode} {op}")


def test_int_rows_keep_the_scatter():
    """K4 takes f32 and bf16 rows; integer rows keep ``segment_sum``."""
    x, ng, nm, b = _unsorted(np.random.default_rng(8))
    xi = (x * 100).astype(np.int32)
    got = _torch(torch.tensor(xi), ng, nm, b, "sum")
    np.testing.assert_array_equal(got.numpy(), _jax(xi, ng, nm, b, "sum"))


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_sparse_readout_takes_sorted_segment_sum(monkeypatch, op):
    """The sparse sum goes through K4's entry with the rows' sort order
    and mask (its plain path here), once, on the route the shape rule
    picks, and never through ``segment_sum``'s ``index_add_`` nor the
    unmasked sum."""
    calls = []
    real = K._k4_sum

    def spy(x, perm, keep, row_ptr, num_rows, route):
        calls.append((perm is not None, keep is not None, route))
        return real(x, perm, keep, row_ptr, num_rows, route)

    def refuse(*a, **kw):
        raise AssertionError("the readout took another sum")

    monkeypatch.setattr(K, "_k4_sum", spy)
    monkeypatch.setattr(K, "_csr_sum", refuse)
    monkeypatch.setattr(t_gr, "segment_sum", refuse)
    x, ng, nm, b = _padded(np.random.default_rng(9))
    tx = torch.tensor(x, requires_grad=True)
    _torch(tx, ng, nm, b, op).sum().backward()
    assert calls == [(True, True, K.segment_route(b, *x.shape))]
    assert tx.grad is not None


def test_readout_is_the_same_for_any_order_of_the_rows():
    """Rows and ids permuted together give the same bits: the stable sort
    restores one order of the rows, whatever order they came in."""
    x, ng, nm, b = _padded(np.random.default_rng(10), n=200)
    perm = np.random.default_rng(11).permutation(x.shape[0])
    # the order the sort gives the shuffled rows, handed over in advance
    p2 = perm[np.argsort(ng[perm], kind="stable")]
    shuffled = _torch(torch.tensor(x[perm]), ng[perm], nm[perm], b, "sum")
    assert torch.equal(
        shuffled, _torch(torch.tensor(x[p2]), ng[p2], nm[p2], b, "sum"))
    _close(shuffled.numpy(), _jax(x, ng, nm, b, "sum"),
           _scale(x, ng, nm, b, "sum"), "shuffled")
