"""K4's routes (``sorted_segment_sum``'s ``"long"`` and ``"wide"``), the
readout's gathered sum (``gather_segment_sum``) and K5's route rule on the
CPU: the plain versions against ``tgp_tpu``'s Pallas kernel in interpret
mode (``sorted_segment_sum_pallas``) and against ``jax.ops.segment_sum``,
on the same seeded numpy inputs.  The kernels themselves run on the card
(``tests/test_torch_cuda_kernels.py``).

Tolerance: 1e-5 of Σ|terms| (the sums add in other orders), one bf16
rounding more in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops.pallas.segment_spmm import sorted_segment_sum_pallas as j_k4
from tgp_tpu_torch.ops.kernels import segment_spmm as K

torch.set_num_threads(1)


@pytest.mark.parametrize("num_rows,n_edges,F,want", [
    (1, 65_536, 128, "long"),      # the serving readout: one graph
    (64, 16_384, 128, "long"),     # 64 graphs of 256 rows
    (65_536, 1 << 20, 128, "wide"),  # a banded spmm_sorted: 16 edges a row
    (1, 65_536, 4, "wide"),        # the narrow mode is edge-balanced already
    (1, 31, 128, "wide"),          # shorter than LONG_MIN_POSITIONS
    (3, 96, 5, "long"),
    (2, 64, 8, "long"),
    (512, 16_384, 128, "long"),    # a readout of 512 graphs of 32 rows
    (1024, 18_432, 128, "wide"),   # 1,024 graphs of 18 rows
    (1024, 65_536, 128, "long"),   # 1,024 graphs of 64 rows
    (4096, 1 << 18, 128, "wide"),  # more segments than LONG_MAX_SEGMENTS
])
def test_segment_route_rule(num_rows, n_edges, F, want):
    assert K.segment_route(num_rows, n_edges, F) == want


@pytest.mark.parametrize("rows", [300, 20])
def test_sorted_segment_sum_takes_its_route_by_shape(rows, monkeypatch):
    """One segment of 300 rows (``"long"``) or of 20 (``"wide"``): the
    call goes to K4's entry on that route, whose plain version runs
    here."""
    calls = []
    real = K._k4_sum
    monkeypatch.setattr(K, "_k4_sum", lambda *a: calls.append(a[-1])
                        or real(*a))
    msgs = torch.ones(rows, 8)
    rp = torch.tensor([0, rows], dtype=torch.int32)
    out = K.sorted_segment_sum(msgs, None, rp, 1)
    assert calls == [K.segment_route(1, rows, 8)]
    assert calls == ["long" if rows >= K.LONG_MIN_POSITIONS else "wide"]
    assert torch.equal(out, torch.full((1, 8), float(rows)))


def _segments(case, rng, F):
    """Segment lengths for a case, messages past ``row_ptr[num_rows]``
    (large: never summed), and the offsets over rows padded to 256 (the
    Pallas kernel's grid)."""
    lengths = {"one segment": [3000],
               "empty and long": [0, 700, 0, 0, 5, 1400, 1, 0, 300],
               "many short": list(rng.integers(0, 9, 200))}[case]
    num_rows = 256
    rp = np.zeros(num_rows + 1, np.int32)
    rp[1:len(lengths) + 1] = np.cumsum(lengths)
    rp[len(lengths) + 1:] = rp[len(lengths)]
    e = int(rp[-1])
    msgs = np.concatenate([rng.normal(size=(e, F)),
                           np.full((40, F), 1e4)]).astype(np.float32)
    rids = np.concatenate([np.repeat(np.arange(len(lengths)), lengths),
                           np.full(40, num_rows)]).astype(np.int32)
    return msgs, rids, rp, num_rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one segment", "empty and long",
                                  "many short"])
@pytest.mark.parametrize("entry", ["long", "rule"])
def test_sorted_segment_sum_routes_match_pallas(entry, case, dtype):
    """The ``"long"`` route's entry and ``sorted_segment_sum`` (the rule's
    pick, ``"wide"`` here) against the Pallas kernel."""
    rng = np.random.default_rng(len(case))
    msgs, rids, rp, n = _segments(case, rng, 36)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(j_k4(jnp.asarray(msgs, jdt), jnp.asarray(rids),
                          jnp.asarray(rp), n, interpret=True,
                          precision=jax.lax.Precision.HIGHEST), np.float32)
    m, r, p = torch.tensor(msgs).to(tdt), torch.tensor(rids), \
        torch.tensor(rp)
    got = (K._k4_sum(m, None, None, p, n, "long") if entry == "long"
           else K.sorted_segment_sum(m, r, p, n))
    assert got.dtype == tdt and got.shape == (n, 36)
    scale = K.sorted_segment_sum_plain(torch.tensor(np.abs(msgs)).to(tdt),
                                       None, torch.tensor(rp), n).float()
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    err = (got.float() - torch.tensor(ref)).abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= 1e-5 * scale + slack * torch.tensor(ref).abs()
            + 1e-30).all()


def _readout_inputs(rng, nan_rows):
    n, graphs = 500, 7
    ids = rng.integers(0, graphs, n).astype(np.int32)
    ids[3] = graphs - 1
    keep = rng.random(n) > 0.3
    x = rng.normal(size=(n, 12)).astype(np.float32)
    if nan_rows:
        x[np.flatnonzero(~keep)[:2]] = np.array([[np.nan], [np.inf]])
    return x, ids, keep, graphs


def _gathered(x, ids, keep, graphs, requires_grad=False):
    """``gather_segment_sum`` over the stable sort of ``ids``."""
    tids = torch.tensor(ids)
    rids, perm = torch.sort(tids, stable=True)
    rp = torch.searchsorted(rids, torch.arange(graphs + 1, dtype=torch.int32),
                            out_int32=True)
    tx = torch.tensor(x, requires_grad=requires_grad)
    out = K.gather_segment_sum(tx, perm.to(torch.int32), torch.tensor(keep),
                               tids, rp, graphs)
    return out, tx


@pytest.mark.parametrize("nan_rows", [False, True])
def test_gather_segment_sum_matches_jax_segment_sum(nan_rows):
    """Values and gradient against ``jax.ops.segment_sum`` of the kept
    rows (a select, so NaN and inf in masked rows are not added)."""
    rng = np.random.default_rng(11)
    x, ids, keep, graphs = _readout_inputs(rng, nan_rows)
    R = rng.normal(size=(graphs, 12)).astype(np.float32)

    def j_sum(v):
        return jax.ops.segment_sum(jnp.where(jnp.asarray(keep)[:, None], v,
                                             0.0), jnp.asarray(ids), graphs)

    ref = np.asarray(j_sum(jnp.asarray(x)))
    ref_grad = np.asarray(jax.grad(lambda v: (j_sum(v) * R).sum())(
        jnp.asarray(x)))
    out, tx = _gathered(x, ids, keep, graphs, requires_grad=True)
    scale = np.asarray(j_sum(jnp.abs(jnp.asarray(x))))
    assert np.isfinite(out.detach().numpy()).all()
    assert (np.abs(out.detach().numpy() - ref) <= 1e-5 * scale + 1e-30).all()
    (out * torch.tensor(R)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), ref_grad)


def test_gather_segment_sum_is_the_sorted_sum_of_the_kept_rows():
    """The same bits as ``sorted_segment_sum`` of the rows zeroed and put
    in sort order first (the plain version reads through the order)."""
    rng = np.random.default_rng(12)
    x, ids, keep, graphs = _readout_inputs(rng, False)
    out, _ = _gathered(x, ids, keep, graphs)
    rids, perm = torch.sort(torch.tensor(ids), stable=True)
    rp = torch.searchsorted(rids, torch.arange(graphs + 1, dtype=torch.int32),
                            out_int32=True)
    rows = torch.where(torch.tensor(keep)[:, None], torch.tensor(x), 0.0)
    assert torch.equal(out, K.sorted_segment_sum(rows[perm], rids, rp, graphs))


@pytest.mark.parametrize("graphs,rows", [(1, 300), (512, 32), (1024, 18),
                                         (3, 20)])
def test_gather_segment_sum_takes_its_route_by_shape(graphs, rows,
                                                     monkeypatch):
    """The readout's gathered sum goes to K4's entry on the route the
    rule picks from (graphs, positions, F), with its order and mask, and
    gives the kept rows' sums."""
    calls = []
    real = K._k4_sum

    def spy(x, perm, keep, row_ptr, num_rows, route):
        calls.append((perm is not None, keep is not None, route))
        return real(x, perm, keep, row_ptr, num_rows, route)

    monkeypatch.setattr(K, "_k4_sum", spy)
    n = graphs * rows
    ids = torch.arange(n, dtype=torch.int32) // rows
    keep = torch.arange(n) % 3 != 0
    rp = torch.arange(graphs + 1, dtype=torch.int32) * rows
    out = K.gather_segment_sum(torch.ones(n, 8), torch.arange(
        n, dtype=torch.int32), keep, ids, rp, graphs)
    route = K.segment_route(graphs, n, 8)
    assert route == ("long" if rows >= K.LONG_MIN_POSITIONS else "wide")
    assert calls == [(True, True, route)]
    want = keep.reshape(graphs, rows).sum(1, dtype=torch.float32)
    assert torch.equal(out, want[:, None].expand(graphs, 8))


def test_gather_segment_sum_checks_its_contract():
    x = torch.zeros(5, 3)
    perm = torch.arange(6, dtype=torch.int32)
    ok = torch.ones(5, dtype=torch.bool)
    rp = torch.tensor([0, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="perm's length"):
        K.gather_segment_sum(x, perm, ok, perm, rp, 1)
    with pytest.raises(ValueError, match="num_rows"):
        K.gather_segment_sum(x, perm[:5], ok, perm[:5], rp, 2)


def test_banded_route_rule():
    """K5 takes 16-byte copies where rows are a multiple of 16 bytes and
    x's base is aligned, element copies elsewhere."""
    assert K.banded_route(torch.zeros(10, 128)) == "vector"
    assert K.banded_route(torch.zeros(10, 8, dtype=torch.bfloat16)) == \
        "vector"
    assert K.banded_route(torch.zeros(10, 36)) == "vector"
    assert K.banded_route(torch.zeros(10, 33)) == "element"
    assert K.banded_route(torch.zeros(10, 36, dtype=torch.bfloat16)) == \
        "element"
    flat = torch.zeros(10 * 128 + 1)
    assert K.banded_route(flat[1:].view(10, 128)) == "element"
