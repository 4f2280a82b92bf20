"""The CUDA kernels of ``tgp_tpu_torch/csrc/`` (``segment_spmm.cu``,
``bmm.cu``) against their plain PyTorch versions, on the card.  Without one
the tests skip; on a GPU machine (which need not have JAX) run them alone:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_kernels.py

The input maker here also feeds the CPU parity tests of
``tests/test_torch_segment_spmm.py``.
"""

import numpy as np
import pytest
import torch

from tgp_tpu_torch.ops.kernels import bmm as BMM
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


BMM_VARIANTS = [(False, False), (True, False), (False, True)]
# (batch, n, m, f): the dense regime's two shapes and two ragged ones
BMM_SIZES = [(64, 256, 256, 128), (64, 128, 128, 128), (3, 40, 24, 17),
             (5, 70, 130, 33)]


def _bmm_operands(batch, n, m, f, trans_a, trans_b, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((batch, m, n) if trans_a else (batch, n, m),
                    generator=g, device="cuda")
    b = torch.randn((batch, f, m) if trans_b else (batch, m, f),
                    generator=g, device="cuda")
    return a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype))


def _bmm_check(got, ref, scale, slack=0.0):
    """|kernel − plain| ≤ 1e-5 · Σₖ|a||b|: both sum the same exact bf16
    products in f32, in other orders; ``slack`` · |ref| more for a result
    rounded to bf16 afterwards."""
    got, ref, scale = got.float().cpu(), ref.float().cpu(), scale.cpu()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-5 * scale + slack * ref.abs()
            + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", BMM_SIZES)
@pytest.mark.parametrize("trans_a,trans_b", BMM_VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_cuda_bmm_matches_plain(trans_a, trans_b, size, dtype):
    """K3's kernel against ``bmm_plain`` on the card (TF32 off), one
    counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with `pytest -m cuda` on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bmm_operands(*size, trans_a, trans_b, dtype)
    before = BMM.bmm.launches
    got = BMM.bmm(a, b, trans_a, trans_b)
    torch.cuda.synchronize()
    assert BMM.bmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (size[0], size[1],
                                                        size[3])
    _bmm_check(got, BMM.bmm_plain(a, b, trans_a, trans_b),
               BMM.bmm_plain(a.abs(), b.abs(), trans_a, trans_b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_a,trans_b", BMM_VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_cuda_bmm_backward_matches_plain_autograd(trans_a, trans_b, dtype):
    """The autograd backward on the card (two kernel launches) against the
    same ``autograd.Function`` on CPU copies, where every product is
    ``bmm_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with `pytest -m cuda` on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    size = (5, 70, 130, 33)
    a, b = _bmm_operands(*size, trans_a, trans_b, dtype, seed=1)
    g = torch.randn(size[0], size[1], size[3], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    grads = {}
    for dev in ("cuda", "cpu"):
        x = a.detach().to(dev).requires_grad_()
        y = b.detach().to(dev).requires_grad_()
        before = BMM.bmm.launches
        BMM.bmm(x, y, trans_a, trans_b).backward(g.to(dev))
        launched = BMM.bmm.launches - before
        assert launched == (3 if dev == "cuda" else 0)
        assert x.grad.dtype == x.dtype and y.grad.dtype == y.dtype
        grads[dev] = (x.grad, y.grad)
    # each gradient's Σ|·||·| scale: the same products over |operands|
    ga = g.abs().cpu()
    xa, ya = a.abs().float().cpu(), b.abs().float().cpu()
    if not trans_a and not trans_b:
        sa, sb = (BMM.bmm_plain(ga, ya, False, True),
                  BMM.bmm_plain(xa, ga, True, False))
    elif trans_a:
        sa, sb = (BMM.bmm_plain(ya, ga, False, True),
                  BMM.bmm_plain(xa, ga, False, False))
    else:
        sa, sb = (BMM.bmm_plain(ga, ya, False, False),
                  BMM.bmm_plain(ga, xa, True, False))
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    _bmm_check(grads["cuda"][0], grads["cpu"][0], sa, slack)
    _bmm_check(grads["cuda"][1], grads["cpu"][1], sb, slack)
