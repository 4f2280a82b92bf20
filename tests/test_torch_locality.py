"""The locality SpMM path and the sorted-CSR family's remaining kernels
against the JAX package on the same numpy inputs: ``ops/ordering.py``
(RCM order, plans, ``locality_spmm`` with both engines), K4
(``sorted_segment_sum``, ``spmm_sorted``), K5 (``banded_sorted_spmm``,
``spmm_banded`` and its gradients), K6 (``banded_sddmm``,
``sddmm_banded`` and its gradients), ``check_band_contract`` and
``sort_edges_csr``.  JAX's Pallas kernels run in interpret mode; the
port's wrappers run their plain versions on CPU tensors.

Inputs include ones that break the band contract (senders outside a
block's window, ids outside a chunk's window, padding ids): the port keeps
the TPU kernels' windows, so it agrees there too.  Tolerances: f32 1e-5 of
the output's scale (f32 sums in another order); bf16 2e-2 of it (the two
packages round to bf16 at other places in the gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops import ordering as jord
from tgp_tpu.ops.pallas.sddmm import banded_sddmm_pallas as j_sddmm
from tgp_tpu.ops.pallas.sddmm import sddmm_banded as j_sddmm_banded
from tgp_tpu.ops.pallas.segment_spmm import (
    banded_sorted_spmm_pallas as j_banded)
from tgp_tpu.ops.pallas.segment_spmm import check_band_contract as j_check
from tgp_tpu.ops.pallas.segment_spmm import segment_sum_sorted as j_sss
from tgp_tpu.ops.pallas.segment_spmm import sort_edges_csr as j_sort
from tgp_tpu.ops.pallas.segment_spmm import (
    sorted_segment_sum_pallas as j_k4)
from tgp_tpu.ops.pallas.segment_spmm import spmm_banded as j_spmm_banded
from tgp_tpu.ops.pallas.segment_spmm import spmm_sorted as j_spmm_sorted
from tgp_tpu_torch.ops import ordering as tord
from tgp_tpu_torch.ops.kernels import sddmm as S
from tgp_tpu_torch.ops.kernels import segment_spmm as K

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} * {scale}"


def _rel(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


def _banded_case(seed, n=600, e=4000, bw=40, F=8, break_band=False,
                 pad=0):
    """Receiver-sorted edges with |s − r| ≤ bw; ``break_band`` sends every
    97th edge to a random node far outside its block's window; ``pad``
    masked edges go last with receiver −1 and weight 0 (``sort_edges_csr``'s
    layout)."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, e)).astype(np.int32)
    s = np.clip(r + rng.integers(-bw, bw + 1, e), 0, n - 1).astype(np.int32)
    if break_band:
        s[::97] = rng.integers(0, n, s[::97].shape[0])
    w = rng.normal(size=e).astype(np.float32)
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.int32)])
        r = np.concatenate([r, np.full(pad, -1, np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    x = rng.normal(size=(n, F)).astype(np.float32)
    return dict(s=s, r=r, w=w, x=x, n=n, rng=rng)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


def _er_union(seed, graphs=6, n=40, p=0.1):
    """Block-diagonal union of ER graphs (``bench.py::make_graphs``'s
    shape, smaller), its nodes shuffled so the order has work to do."""
    rng = np.random.default_rng(seed)
    eis, off = [], 0
    for _ in range(graphs):
        upper = np.triu(rng.random((n, n)) < p, 1)
        s, r = np.nonzero(upper | upper.T)
        eis.append(np.stack([s, r]) + off)
        off += n
    ei = np.concatenate(eis, 1)
    shuffle = rng.permutation(off)
    return shuffle[ei], off, rng


def test_rcm_order_and_helpers_match_jax():
    ei, n, rng = _er_union(1)
    perm = tord.rcm_order(ei, n)
    np.testing.assert_array_equal(perm, jord.rcm_order(ei, n))
    assert sorted(perm) == list(range(n))
    assert tord.band_after_order(ei, n, perm) == jord.band_after_order(
        ei, n, perm)
    assert tord.band_after_order(ei, n, perm) < tord.band_after_order(ei, n)
    assert tord.band_after_order(np.zeros((2, 0), int), n) == 0
    x = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.random(ei.shape[1]).astype(np.float32)
    for got, ref in zip(tord.apply_node_order(perm, x, ei, w),
                        jord.apply_node_order(perm, x, ei, w)):
        np.testing.assert_array_equal(got, ref)
    assert len(tord.apply_node_order(perm, x, ei)) == 3
    for bw in (0, 5, 100, 1000, 2000, 5000):
        for br in (64, 128):
            assert tord.choose_banded_window(bw, br) == \
                jord.choose_banded_window(bw, br)


@pytest.mark.parametrize("engine", ["auto", "sorted", "banded"])
def test_plan_locality_spmm_matches_jax(engine):
    ei, n, rng = _er_union(2)
    w = rng.random(ei.shape[1]).astype(np.float32)
    ref = jord.plan_locality_spmm(ei, n, w, engine=engine)
    got = tord.plan_locality_spmm(ei, n, w, engine=engine, **CPU)
    for k in ("engine", "window", "bandwidth"):
        assert got[k] == ref[k], k
    for k in ("perm", "inv"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("senders", "receivers", "edge_weight", "row_ptr"):
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["senders"].dtype == torch.int32
    with pytest.raises(ValueError, match="unknown engine"):
        tord.plan_locality_spmm(ei, n, engine="bogus", **CPU)
    with pytest.raises(ValueError, match="max_window"):
        tord.plan_locality_spmm(ei, n, engine="banded", max_window=128,
                                **CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["auto", "banded"])
def test_locality_spmm_matches_jax_and_plain_product(engine, dtype):
    """Both engines against JAX's, and mapped back with ``inv`` against
    the plain ``A·X`` of the graph in its own order."""
    ei, n, rng = _er_union(3)
    w = rng.random(ei.shape[1]).astype(np.float32)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    jplan = jord.plan_locality_spmm(ei, n, w, engine=engine)
    plan = tord.plan_locality_spmm(ei, n, w, engine=engine, **CPU)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jord.locality_spmm(jplan, jnp.asarray(x[jplan["perm"]], jdt),
                             interpret=True)
    before = (K.segment_sum_sorted.launches, K.banded_sorted_spmm.launches)
    got = tord.locality_spmm(plan, torch.tensor(x[plan["perm"]]).to(tdt))
    assert (K.segment_sum_sorted.launches,
            K.banded_sorted_spmm.launches) == before  # CPU: plain versions
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, _rel(dtype))
    dense = np.zeros((n, 5))
    np.add.at(dense, ei[1], w[:, None] * _np(torch.tensor(x).to(tdt))[ei[0]])
    _close(_np(got)[plan["inv"]], dense, 1e-5 if dtype == "float32" else
           1e-2)


# ---------------------------------------------------------------------------
# K4: sorted_segment_sum / spmm_sorted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
def test_sorted_segment_sum_matches_pallas(F, dtype):
    """256 rows, an empty row, a row longer than 256 edges, and 50 padding
    edges past ``row_ptr[num_rows]`` that the kernel must not read."""
    rng = np.random.default_rng(F)
    num_rows, e = 256, 3000
    r = np.sort(np.concatenate([rng.integers(0, num_rows, e - 400),
                                np.full(400, 77)])).astype(np.int32)
    r = r[r != 5]  # row 5 stays empty
    counts = np.bincount(r, minlength=num_rows)
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    msgs = rng.normal(size=(r.shape[0] + 50, F)).astype(np.float32)
    rids = np.concatenate([r, np.full(50, num_rows, np.int32)])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_k4(jnp.asarray(msgs, jdt), jnp.asarray(rids), jnp.asarray(rp),
               num_rows, interpret=True)
    before = K.sorted_segment_sum.launches
    got = K.sorted_segment_sum(torch.tensor(msgs).to(tdt),
                               torch.tensor(rids), torch.tensor(rp),
                               num_rows)
    assert K.sorted_segment_sum.launches == before
    assert got.dtype == tdt and got.shape == (num_rows, F)
    _close(got, ref, 1e-5 if dtype == "float32" else 1e-2)
    assert not _np(got)[5].any()
    np.testing.assert_array_equal(
        _np(K.sorted_segment_sum_plain(torch.tensor(msgs).to(tdt), None,
                                       torch.tensor(rp), num_rows)),
        _np(got))


def test_sorted_segment_sum_gradient_is_the_gather_of_k2():
    """K4's gradient is K2's: ``g[clip(rids)]`` (JAX's K4 has no VJP of
    its own; ``segment_sum_sorted`` with the same offsets is its
    reference)."""
    rng = np.random.default_rng(4)
    num_rows = 256
    r = np.sort(rng.integers(0, 200, 900)).astype(np.int32)
    rp = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=num_rows))]
                        ).astype(np.int32)
    msgs = rng.normal(size=(900, 6)).astype(np.float32)
    g = rng.normal(size=(num_rows, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda m: j_sss(m, jnp.asarray(r), num_rows,
                                     interpret=True, row_ptr=jnp.asarray(rp)),
                     jnp.asarray(msgs))
    (ref,) = vjp(jnp.asarray(g))
    tm = torch.tensor(msgs, requires_grad=True)
    K.sorted_segment_sum(tm, torch.tensor(r), torch.tensor(rp),
                         num_rows).backward(torch.tensor(g))
    np.testing.assert_array_equal(_np(tm.grad), _np(ref))
    with pytest.raises(ValueError, match="rids"):
        K.sorted_segment_sum(tm, None, torch.tensor(rp), num_rows)


def test_sorted_segment_sum_checks_its_contract():
    rp = torch.zeros(257, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_rows"):
        K.sorted_segment_sum(torch.zeros(3, 2), None, rp, 300)
    with pytest.raises(ValueError, match=r"\[E, F\]"):
        K.sorted_segment_sum(torch.zeros(3), None, rp, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_sorted_matches_jax(dtype):
    c = _banded_case(5, n=512, e=3000)
    rp = np.concatenate([[0], np.cumsum(np.bincount(c["r"], minlength=512))]
                        ).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_spmm_sorted(jnp.asarray(c["s"]), jnp.asarray(c["r"]),
                        jnp.asarray(rp), jnp.asarray(c["w"]).astype(jdt),
                        jnp.asarray(c["x"], jdt), 512, interpret=True)
    tx = torch.tensor(c["x"]).to(tdt).requires_grad_()
    got = K.spmm_sorted(torch.tensor(c["s"]), torch.tensor(c["r"]),
                        torch.tensor(rp), torch.tensor(c["w"]).to(tdt), tx,
                        512)
    _close(got, ref, 1e-5 if dtype == "float32" else 1e-2)
    # the gradient flows through the gather and the weight: d_x = Aᵀ g
    got.float().sum().backward()
    dense = np.zeros((512, 8))
    np.add.at(dense, c["s"], np.broadcast_to(
        _np(torch.tensor(c["w"]).to(tdt))[:, None], (3000, 8)))
    _close(tx.grad, dense, 1e-5 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------------------------
# K5: banded_sorted_spmm / spmm_banded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
@pytest.mark.parametrize("break_band", [False, True])
def test_banded_sorted_spmm_matches_pallas(break_band, F, dtype):
    """Windows per 128-row block: a layout that breaks the band loses the
    out-of-window senders in both packages alike."""
    c = _banded_case(10 + F, F=F, break_band=break_band)
    num_rows, window = 640, 256
    rp = np.concatenate([[0], np.cumsum(np.bincount(c["r"],
                                                    minlength=num_rows))]
                        ).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_banded(jnp.asarray(c["x"], jdt), jnp.asarray(c["s"]),
                   jnp.asarray(rp), jnp.asarray(c["w"]), num_rows,
                   window=window, interpret=True)
    before = K.banded_sorted_spmm.launches
    got = K.banded_sorted_spmm(torch.tensor(c["x"]).to(tdt),
                               torch.tensor(c["s"]), torch.tensor(rp),
                               torch.tensor(c["w"]), num_rows, window=window)
    assert K.banded_sorted_spmm.launches == before
    assert got.dtype == tdt and got.shape == (num_rows, F)
    _close(got, ref, 1e-5 if dtype == "float32" else 1e-2)
    contract = K.check_band_contract(c["s"], c["r"], np.ones_like(c["s"]),
                                     num_rows, window=window)
    assert contract == (not break_band)
    if break_band:  # the windows matter: the unwindowed product differs
        full = K.spmm_csr_plain(torch.tensor(c["x"]), torch.tensor(c["w"]),
                                torch.tensor(c["s"]), torch.tensor(rp),
                                num_rows)
        assert np.abs(_np(full) - _np(ref)).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["hub", "falling", "unsorted", "padding"])
def test_banded_sorted_spmm_ring_cases_match_pallas(case, dtype):
    """The layouts the CUDA tests hold the ring kernel to (a hub receiver,
    falling window starts, random senders, padding and negative senders):
    the plain version against the Pallas kernel in interpret mode."""
    from tests.test_torch_cuda_kernels import _banded_ring_case

    x, s, w, rp, n, window = _banded_ring_case(case, 36, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_banded(jnp.asarray(x, jdt), jnp.asarray(s), jnp.asarray(rp),
                   jnp.asarray(w), n, window=window, interpret=True)
    got = K.banded_sorted_spmm(torch.tensor(x).to(tdt), torch.tensor(s),
                               torch.tensor(rp), torch.tensor(w), n,
                               window=window)
    assert got.dtype == tdt and got.shape == (n, 36)
    _close(got, ref, 1e-5 if dtype == "float32" else 1e-2)


def test_banded_window_base_and_small_x():
    """x with fewer rows than the window (JAX pads it with zeros), empty
    blocks, and a window past the last row."""
    c = _banded_case(20, n=100, e=300, bw=10, F=4)
    num_rows, window = 256, 128
    rp = np.concatenate([[0], np.cumsum(np.bincount(c["r"],
                                                    minlength=num_rows))]
                        ).astype(np.int32)
    ref = j_banded(jnp.asarray(c["x"]), jnp.asarray(c["s"]),
                   jnp.asarray(rp), jnp.asarray(c["w"]), num_rows,
                   window=window, interpret=True)
    got = K.banded_sorted_spmm(torch.tensor(c["x"]), torch.tensor(c["s"]),
                               torch.tensor(rp), torch.tensor(c["w"]),
                               num_rows, window=window)
    _close(got, ref, 1e-5)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        K.banded_sorted_spmm(torch.tensor(c["x"]), torch.tensor(c["s"]),
                             torch.tensor(rp), torch.tensor(c["w"]), 200)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.banded_sorted_spmm(torch.tensor(c["x"]), torch.tensor(c["s"]),
                             torch.tensor(rp), torch.tensor(c["w"]),
                             num_rows, window=100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("break_band,pad", [(False, 0), (True, 37)])
def test_spmm_banded_values_and_gradients_match_jax(break_band, pad, dtype):
    """``spmm_banded``: offsets from the receivers (the −1 padding is not
    counted), the forward through the windows, and the gradients for x
    and w as JAX's scatter computes them (no window)."""
    c = _banded_case(30, break_band=break_band, pad=pad)
    n = c["n"]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(
        lambda x, w: j_spmm_banded(x, jnp.asarray(c["s"]),
                                   jnp.asarray(c["r"]), w, n, window=256,
                                   interpret=True),
        jnp.asarray(c["x"], jdt), jnp.asarray(c["w"]))
    g = c["rng"].normal(size=out.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g, out.dtype))
    tx = torch.tensor(c["x"]).to(tdt).requires_grad_()
    tw = torch.tensor(c["w"]).requires_grad_()
    got = K.spmm_banded(tx, torch.tensor(c["s"]), torch.tensor(c["r"]), tw,
                        n, window=256)
    assert got.dtype == tdt and got.shape == (n, 8)
    _close(got, out, _rel(dtype), "out")
    got.backward(torch.tensor(np.asarray(jnp.asarray(g, out.dtype),
                                         np.float32)).to(tdt))
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    _close(tx.grad, jdx, _rel(dtype), "d_x")
    _close(tw.grad, jdw, _rel(dtype), "d_w")


# ---------------------------------------------------------------------------
# K6: banded_sddmm / sddmm_banded
# ---------------------------------------------------------------------------


def _sddmm_case(seed, na=700, nb=650, e=3000, F=128, span=30):
    """Sorted-ish ids with padding ids (``Na``/``Nb``), a negative id and
    ids far outside their chunk's window on either axis."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(na, F)).astype(np.float32)
    b = rng.normal(size=(nb, F)).astype(np.float32)
    s = np.clip(np.sort(rng.integers(0, na, e))
                + rng.integers(-span, span, e), 0, na - 1).astype(np.int32)
    r = np.clip(np.sort(rng.integers(0, nb, e))
                + rng.integers(-span, span, e), 0, nb - 1).astype(np.int32)
    s[5], r[7] = na, nb          # padding ids
    s[1000], r[2000] = 690, 640  # above their chunk's window
    s[2500] = -3                 # below every window
    s[e - 10:], r[e - 10:] = na, nb  # a padded tail
    return a, b, s, r, rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [128, 256])
def test_banded_sddmm_matches_pallas(window, dtype):
    a, b, s, r, _ = _sddmm_case(40)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_sddmm(jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(s),
                  jnp.asarray(r), window=window, interpret=True)
    before = S.banded_sddmm.launches
    got = S.banded_sddmm(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt),
                         torch.tensor(s), torch.tensor(r), window=window)
    assert S.banded_sddmm.launches == before
    assert got.dtype == torch.float32 and got.shape == (3000,)
    # Σ_f |a||b| per edge bounds the f32 sum-order difference
    scale = (np.abs(_np(torch.tensor(a).to(tdt)))[np.clip(s, 0, 699)]
             * np.abs(_np(torch.tensor(b).to(tdt)))[np.clip(r, 0, 649)]
             ).sum(1)
    assert (np.abs(_np(got) - _np(ref)) <= 1e-5 * scale + 1e-6).all()
    zero = _np(ref) == 0
    assert zero[[5, 7, 1000, 2000, 2500]].all() and zero[-10:].all()
    np.testing.assert_array_equal(_np(got) == 0, zero)


def test_banded_sddmm_small_inputs_and_checks():
    """Fewer rows than the window on both axes, F = 1, E not a multiple of
    the chunk."""
    rng = np.random.default_rng(41)
    a = rng.normal(size=(20, 128)).astype(np.float32)
    b = rng.normal(size=(30, 128)).astype(np.float32)
    s = rng.integers(0, 21, 700).astype(np.int32)
    r = rng.integers(0, 31, 700).astype(np.int32)
    ref = j_sddmm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s),
                  jnp.asarray(r), window=64, interpret=True)
    got = S.banded_sddmm(torch.tensor(a), torch.tensor(b), torch.tensor(s),
                         torch.tensor(r), window=64)
    _close(got, ref, 1e-5)
    one = S.banded_sddmm(torch.tensor(a[:, :1]), torch.tensor(b[:, :1]),
                         torch.tensor(s), torch.tensor(r), window=64)
    ok = (s < 20) & (r < 30)
    np.testing.assert_allclose(
        _np(one), np.where(ok, a[np.minimum(s, 19), 0]
                           * b[np.minimum(r, 29), 0], 0), atol=1e-6)
    with pytest.raises(ValueError, match="one width"):
        S.banded_sddmm(torch.zeros(3, 4), torch.zeros(3, 5),
                       torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        S.banded_sddmm(torch.zeros(3, 4), torch.zeros(3, 4),
                       torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), window=12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_banded_gradients_match_jax(dtype):
    """The backward scatters with the ``valid`` mask (padding and negative
    ids add nothing) and no window."""
    a, b, s, r, rng = _sddmm_case(42)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(
        lambda a_, b_: j_sddmm_banded(a_, b_, jnp.asarray(s), jnp.asarray(r),
                                      window=128, interpret=True),
        jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    g = rng.normal(size=out.shape).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(g))
    ta = torch.tensor(a).to(tdt).requires_grad_()
    tb = torch.tensor(b).to(tdt).requires_grad_()
    got = S.sddmm_banded(ta, tb, torch.tensor(s), torch.tensor(r),
                         window=128)
    _close(got, out, 1e-5, "out")
    got.backward(torch.tensor(g))
    assert ta.grad.dtype == tdt and tb.grad.dtype == tdt
    _close(ta.grad, jda, _rel(dtype), "d_a")
    _close(tb.grad, jdb, _rel(dtype), "d_b")


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [64, 256])
def test_check_band_contract_matches_jax(window):
    c = _banded_case(50, break_band=True)
    m = np.ones(c["s"].shape[0], bool)
    m[::97] = False  # masking the breaking edges restores the contract
    for mask in (np.ones_like(m), m):
        args = (c["s"], c["r"], mask, 640)
        assert K.check_band_contract(*args, window=window) == \
            j_check(*args, window=window)
    assert K.check_band_contract(torch.tensor(c["s"]), torch.tensor(c["r"]),
                                 torch.tensor(m), 640, window=256)


def test_sort_edges_csr_matches_jax():
    rng = np.random.default_rng(60)
    n, e = 50, 400
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    r[::50] = n + 3  # a valid-looking receiver outside the rows: not counted
    w = rng.random(e).astype(np.float32)
    m = rng.random(e) > 0.2
    ref = j_sort(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                 jnp.asarray(m), n)
    got = K.sort_edges_csr(torch.tensor(s), torch.tensor(r), torch.tensor(w),
                           torch.tensor(m), n)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == getattr(torch, str(r_.dtype))
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
