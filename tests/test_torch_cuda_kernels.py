"""The CUDA kernel of ``tgp_tpu_torch/csrc/segment_spmm.cu`` against its
plain PyTorch version, on the card.  Without one the tests skip; on a GPU
machine (which need not have JAX) run them alone:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_kernels.py

The input maker here also feeds the CPU parity tests of
``tests/test_torch_segment_spmm.py``.
"""

import numpy as np
import pytest
import torch

from tgp_tpu_torch.ops.kernels import segment_spmm as K

N_NODES = 150
N_PAD_EDGES = 37  # padding edges: sender = receiver = 0, weight 0


def _csr_case(seed, F, n=N_NODES, e=900, n_pad=N_PAD_EDGES, hub=0):
    """Receiver-sorted edges with padding at the head of row 0, the CSR
    offsets over 256-padded rows, and the sender-sorted transpose layout
    (what ``from_graphs(sort_edges=True)`` builds)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([np.zeros(n_pad, np.int32),
                        rng.integers(0, n, e).astype(np.int32)])
    r = np.concatenate([np.zeros(n_pad, np.int32),
                        rng.integers(0, n, e).astype(np.int32)])
    r[n_pad:n_pad + hub] = n // 2  # a long row in the middle
    w = np.concatenate([np.zeros(n_pad, np.float32),
                        (rng.random(e) + 0.1).astype(np.float32)])
    o = np.argsort(r, kind="stable")
    s, r, w = s[o], r[o], w[o]
    rows_pad = 256
    rp = np.zeros(rows_pad + 1, np.int32)
    rp[1:] = np.cumsum(np.bincount(r, minlength=rows_pad))
    perm = np.argsort(s, kind="stable")
    rp_t = np.zeros(rows_pad + 1, np.int32)
    rp_t[1:] = np.cumsum(np.bincount(s[perm], minlength=rows_pad))
    x = rng.normal(size=(n, F)).astype(np.float32)
    return dict(x=x, s=s, r=r, w=w, rp=rp, s_t=s[perm], r_t=r[perm],
                w_t=w[perm], rp_t=rp_t, n=n)


def _row_scale(c, F):
    """Σ_e |w_e|·|x[s_e]| per receiver row (the bf16 error scale)."""
    out = np.zeros((c["n"], F))
    np.add.at(out, c["r"], np.abs(c["w"])[:, None] * np.abs(c["x"][c["s"]]))
    return out


def _assert_rel(got, ref, rel, scale):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= rel * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 128, 130])
@pytest.mark.parametrize("n_pad,hub", [(N_PAD_EDGES, 0), (3000, 0),
                                       (3000, 700)])
def test_cuda_kernel_matches_plain(F, dtype, n_pad, hub):
    """The CUDA kernel against its plain version on the card (both modes),
    and its launch count: f32 within 1e-4 and bf16 within 1e-2 of the
    row's Σ|w·x| (the plain version's atomics and the kernel's lanes sum in
    other orders; a row of 3000 f32 terms drifts ~2e-5).  With 3000 padding
    edges row 0, and with a hub a middle row, is split across warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with `pytest -m cuda` on the GPU")
    c = _csr_case(F, F, e=900 + hub, n_pad=n_pad, hub=hub)
    tdt = getattr(torch, dtype)
    x = torch.tensor(c["x"], dtype=tdt, device="cuda")
    w = torch.tensor(c["w"], device="cuda")
    s = torch.tensor(c["s"], device="cuda")
    rp = torch.tensor(c["rp"], device="cuda")
    before = K.spmm_csr.launches
    got = K.spmm_csr(x, w, s, rp, c["n"])
    torch.cuda.synchronize()
    assert K.spmm_csr.launches == before + 1
    ref = K.spmm_csr_plain(x, w, s, rp, c["n"])
    rel = 1e-4 if dtype == "float32" else 1e-2
    _assert_rel(got.float().cpu(), ref.float().cpu(), rel, _row_scale(c, F))
    msgs = x[s.long()].contiguous()
    r = torch.tensor(c["r"], device="cuda")
    got2 = K.segment_sum_sorted(msgs, r, c["n"])
    ref2 = K.segment_sum_sorted_plain(msgs, r, c["n"])
    scale2 = np.zeros((c["n"], F))
    np.add.at(scale2, c["r"], np.abs(msgs.float().cpu().numpy()))
    _assert_rel(got2.float().cpu(), ref2.float().cpu(), rel, scale2)
