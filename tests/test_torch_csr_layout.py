"""K1's CSR layouts and offsets (``segment_spmm.csr_layouts`` and
``csr_offsets``) at every caller that builds them, held bit for bit to a
numpy oracle: stable argsorts and ``np.searchsorted``; and the SpMM route
(``ops.sparse.spmm_route``) held to its truth table on the CPU."""

import numpy as np
import pytest
import torch

from tgp_tpu_torch.graph import ceil_to, from_graphs
from tgp_tpu_torch.ops.kernels import segment_spmm as K
from tgp_tpu_torch.ops.sparse import spmm_route
from tgp_tpu_torch.parallel.spmm import CsrLayout, partition_edges
from tgp_tpu_torch.select.maxcut import delta_gcn_csr

torch.set_num_threads(1)


def _offsets(keys_sorted, rows):
    return np.searchsorted(keys_sorted, np.arange(rows + 1)).astype(np.int32)


def _layouts(s, r, rows, rows_t):
    """The oracle of ``csr_layouts``: arrays named as its fields."""
    order = np.argsort(r, kind="stable")
    s_s, r_s = s[order], r[order]
    perm = np.argsort(s_s, kind="stable")
    return dict(order=order, senders=s_s, receivers=r_s,
                row_ptr=_offsets(r_s, rows), perm=perm, senders_t=s_s[perm],
                receivers_t=r_s[perm], row_ptr_t=_offsets(s_s[perm], rows_t))


def _graphs(seed, sizes=(9, 14, 5)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 3)).astype(np.float32),
             rng.integers(0, n, (2, 3 * n)),
             (rng.random(3 * n) + 0.1).astype(np.float32)) for n in sizes]


def _collated():
    """The collator's layout: rows padded to 256 on both sides, padding
    edges at the head of row 0; weights carried by the two orders."""
    kw = dict(pad_nodes=40, pad_edges=160, device="cpu")
    plain = from_graphs(_graphs(1), **kw)
    got = from_graphs(_graphs(1), sort_edges=True, **kw)
    s, r = plain.senders.numpy(), plain.receivers.numpy()
    want = _layouts(s, r, 256, 256)
    w = plain.edge_weight.numpy()[want.pop("order")]
    want.update(edge_weight=w, edge_weight_t=w[want.pop("perm")])
    assert ceil_to(plain.num_nodes, 256) == 256
    return {k: getattr(got, k) for k in want}, want


def _partition():
    """A rank's partition: receivers local to ``rows_per`` rows, senders
    into all ``n_pad`` rows."""
    rng = np.random.default_rng(2)
    n, e = 37, 300
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    S, R, _, n_pad, rows_per = partition_edges(
        s, r, rng.random(e).astype(np.float32), n, 3, device="cpu")
    assert n_pad != rows_per
    lay = CsrLayout(S[1], R[1], rows_per, n_pad)
    want = _layouts(S[1].numpy(), R[1].numpy(), rows_per, n_pad)
    want["order_t"] = want["order"][want.pop("perm")]
    return {k: getattr(lay, k) for k in want}, want


def _maxcut_fallback():
    """``delta_gcn_csr`` on a batch without CSR metadata and with masked
    edges: masked edges keyed past the rows on both sides."""
    b = from_graphs(_graphs(3), pad_nodes=32, pad_edges=128, device="cpu")
    mask = b.edge_mask & (torch.arange(b.num_edges) % 5 != 0)
    b = b.replace(edge_mask=mask)
    N = b.num_nodes
    layout = delta_gcn_csr(b)[0]
    s, r, m = b.senders.numpy(), b.receivers.numpy(), mask.numpy()
    order = np.argsort(np.where(m, r, N), kind="stable")
    key = np.where(m, r, N)[order]
    s_s, r_s = s[order], np.where(m[order], r[order], -1)
    key_t = np.where(np.arange(s.size) < m.sum(), s_s, N)
    perm = np.argsort(key_t, kind="stable")
    want = dict(senders=s_s, receivers=r_s, row_ptr=_offsets(key, N),
                receivers_t=r_s[perm], senders_t=s_s[perm],
                row_ptr_t=_offsets(key_t[perm], N))
    return dict(zip(("senders", "receivers", "row_ptr", "receivers_t",
                     "senders_t", "row_ptr_t"), layout[:6])), want


def _banded_padding():
    """``sort_edges_csr``'s −1 padding at the end, keyed to 128 rows as
    ``spmm_banded`` keys it; its own offsets over 100 rows."""
    rng = np.random.default_rng(4)
    e, n = 400, 100
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    m = rng.random(e) > 0.3
    s_s, r_s, _, rp = K.sort_edges_csr(
        torch.tensor(s), torch.tensor(r), torch.rand(e), torch.tensor(m), n)
    assert (r_s[-1] == -1) and (r_s[:int(m.sum())] >= 0).all()
    keyed = torch.where(r_s >= 0, r_s, 128)
    valid = np.sort(r[m], kind="stable")
    return (dict(row_ptr=rp, banded=K.csr_offsets(keyed, 128)),
            dict(row_ptr=_offsets(valid, n), banded=_offsets(valid, 128)))


def _past_rows():
    """Receivers at and past the rows are not counted; senders past
    ``rows_t`` neither."""
    rng = np.random.default_rng(5)
    s, r = rng.integers(0, 60, 200), rng.integers(0, 50, 200)
    got = K.csr_layouts(torch.tensor(s), torch.tensor(r), 30, 45)._asdict()
    got["offsets"] = K.csr_offsets(torch.tensor(np.sort(r)), 30)
    want = _layouts(s, r, 30, 45)
    want["offsets"] = _offsets(np.sort(r), 30)
    assert want["row_ptr"][-1] < 200 and want["row_ptr_t"][-1] < 200
    return got, want


def _no_edges():
    empty = torch.zeros(0, dtype=torch.int32)
    got = K.csr_layouts(empty, empty, 256, 7)._asdict()
    return got, _layouts(np.zeros(0, np.int32), np.zeros(0, np.int32),
                         256, 7)


CASES = dict(collated=_collated, partition=_partition,
             maxcut_fallback=_maxcut_fallback,
             banded_padding=_banded_padding, past_rows=_past_rows,
             no_edges=_no_edges)


@pytest.mark.parametrize("case", list(CASES))
def test_csr_layouts_match_numpy_oracle(case):
    got, want = CASES[case]()
    assert set(got) == set(want), case
    for k, ref in want.items():
        a = got[k]
        if "row_ptr" in k or k in ("offsets", "banded"):
            assert a.dtype == torch.int32, (case, k)
        np.testing.assert_array_equal(a.numpy(), ref, err_msg=f"{case}.{k}")


@pytest.mark.parametrize("use_kernel", [None, True, False])
@pytest.mark.parametrize("has_csr", [True, False])
@pytest.mark.parametrize("edges_sorted", [True, False])
def test_spmm_route_truth_table(use_kernel, has_csr, edges_sorted):
    """``"csr"`` needs sorted edges, CSR metadata and the regime; sorted
    edges in the regime without the metadata are ``"sorted"``; on the CPU
    the regime map (``use_kernel=None``) never holds."""
    b = from_graphs(_graphs(6), sort_edges=True, device="cpu")
    if not has_csr:
        b = b.replace(row_ptr=None, senders_t=None, receivers_t=None,
                      edge_weight_t=None, row_ptr_t=None, in_degree=None)
    b = b.replace(edges_sorted=edges_sorted)
    want = "generic"
    if use_kernel and edges_sorted:
        want = "csr" if has_csr else "sorted"
    assert spmm_route(b, use_kernel) == want
