"""The CUDA kernels of ``tgp_tpu_torch/csrc/`` (``segment_spmm.cu`` in
its K1, K2 and K4 ``"wide"`` modes and K1's backward, ``segment_reduce.cu``
(K4's ``"long"`` route and the readout's gathered sum), ``banded_spmm.cu``
(K5), ``bmm.cu``, ``sddmm.cu``) against their plain PyTorch versions, on
the card (and the models over them: GTVConv's CSR route against its
generic one, the clustering and autoencoder models' step one; the served
``PoolingClassifier``'s CUDA-graph replay against its eager forward), and
runs on the same inputs against each other (every sum order
but K3's is fixed, so they are equal bit for bit); and ``from_graphs``'
collation on the card (page-locked staging, the padding built there)
against ``collate_oracle``'s packing, bit for bit.  Without one the tests
skip; on a GPU machine (which need not have JAX) run them alone:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_kernels.py

The input maker here also feeds the CPU parity tests of
``tests/test_torch_segment_spmm.py``.
"""

import numpy as np
import pytest
import torch

import collate_oracle as oracle
from tgp_tpu_torch.ops.kernels import bmm as BMM
from tgp_tpu_torch.ops.kernels import sddmm as SD
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


#: edges a warp of segment_spmm.cu sums in its narrow mode (F <= 4,
#: ``kNarrowRange``); the wide mode splits rows longer than
#: ``K.EDGES_PER_ITEM`` into chunks of that many
NARROW_CHUNK = 256


def _chunk_of(F):
    return NARROW_CHUNK if F <= 4 else K.EDGES_PER_ITEM


def _boundary_lengths(case, C):
    """Row lengths (0: an empty row) that put row ends on and across the
    kernel's C-edge chunks."""
    return {
        # a row ends exactly on a chunk boundary, and one spans exactly
        # two chunks, boundary to boundary
        "ends_on_boundary": [C - 5, 5, 2 * C, 7, 0, 9],
        # the long row is the last row
        "long_last": [3, 0, 4, 5] * 10 + [5 * C // 2],
        # a row of >= 3 chunks starting and ending mid-chunk
        "long_middle": [6, 1, 0, 11] * 5 + [3 * C + 17] + [2, 0, 9] * 5,
        # runs of empty rows longer than a warp, between long rows
        "empty_runs": [5, 3] + [0] * 100 + [4, 6, 2] + [0] * 40 + [C + 3],
        "all_empty": [0] * 40,
        # fewer edges than one chunk
        "short": [3, 1, 0, 7, 2, 5],
    }[case]


BOUNDARY_CASES = ["ends_on_boundary", "long_last", "long_middle",
                  "empty_runs", "all_empty", "short"]


def _rows_case(lengths, F, seed=0, n_x=300):
    """Receiver-sorted edges with the given row lengths, signed weights,
    and CSR offsets over the rows padded to 256."""
    rng = np.random.default_rng(seed)
    n = len(lengths)
    rp = np.zeros(-(-n // 256) * 256 + 1, np.int32)
    rp[1:n + 1] = np.cumsum(lengths)
    rp[n + 1:] = rp[n]
    e = int(rp[n])
    w = ((rng.random(e) + 0.1) * rng.choice([-1.0, 1.0], e)).astype(np.float32)
    return dict(x=rng.normal(size=(n_x, F)).astype(np.float32),
                s=rng.integers(0, n_x, e).astype(np.int32),
                r=np.repeat(np.arange(n), lengths).astype(np.int32), w=w,
                rp=rp, n=n)


def _layout(c, make):
    """``spmm_csr``'s arguments after ``h`` and before ``num_rows``
    (``w, w_t, senders, receivers, row_ptr, receivers_t, senders_t,
    row_ptr_t``), each made by ``make`` from the case's numpy array."""
    return tuple(make(c[k]) for k in ("w", "w_t", "s", "r", "rp", "r_t",
                                      "s_t", "rp_t"))


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


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with `pytest -m cuda` on the GPU")


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
    _skip_without_card()
    c = _csr_case(F, F, e=900 + hub, n_pad=n_pad, hub=hub)
    tdt = getattr(torch, dtype)
    x = torch.tensor(c["x"], dtype=tdt, device="cuda")
    layout = _layout(c, lambda a: torch.tensor(a, device="cuda"))
    w, s, rp = layout[0], layout[2], layout[4]
    before = K.spmm_csr.launches
    got = K.spmm_csr(x, *layout, c["n"])
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


def _twice_equal(run):
    """``run()`` twice on the same inputs: equal bit for bit."""
    first = run()
    second = run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    return first


def _close(got, ref, scale, dtype):
    """|kernel − plain| ≤ 1e-5 of Σ|terms| (f32 sums in other orders),
    plus one bf16 rounding of the output in bf16."""
    got, ref, scale = got.float().cpu(), ref.float().cpu(), scale.float().cpu()
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-5 * scale + slack * ref.abs()
            + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 2, 8, 128, 130])
@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_cuda_spmm_boundaries(case, F, dtype):
    """K1 (gather) and K4 (no gather) on layouts whose rows end on, start
    inside and span the kernel's edge chunks, with runs of empty rows,
    no edges at all, or fewer edges than one chunk: each run twice,
    bit-equal, and held to its plain version."""
    _skip_without_card()
    c = _rows_case(_boundary_lengths(case, _chunk_of(F)), F, seed=F)
    tdt = getattr(torch, dtype)
    x = torch.tensor(c["x"], device="cuda").to(tdt)
    w, s, r, rp = (torch.tensor(c[k], device="cuda")
                   for k in ("w", "s", "r", "rp"))
    n = c["n"]
    before = K.spmm_csr.launches
    got = _twice_equal(lambda: K.spmm_csr(x, w, None, s, None, rp, None,
                                          None, None, n))
    assert K.spmm_csr.launches == before + 2
    _close(got, K.spmm_csr_plain(x, w, s, rp, n),
           K.spmm_csr_plain(x.float().abs(), w.abs(), s, rp, n), dtype)
    msgs = x[s.long()].contiguous()
    got = _twice_equal(lambda: K.sorted_segment_sum(msgs, r, rp, n))
    _close(got, K.sorted_segment_sum_plain(msgs, r, rp, n),
           K.sorted_segment_sum_plain(msgs.float().abs(), r, rp, n), dtype)
    if case == "all_empty":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 128, 130])
def test_cuda_runs_are_bit_equal(F, dtype):
    """K1, K1's backward (``d_h``), K2, K4 and K5 each run twice on the same
    inputs, with a 3000-edge padding row and a 700-edge hub: equal bit for
    bit (no float atomics; every sum in an order the layout fixes)."""
    _skip_without_card()
    c = _csr_case(60 + F, F, e=1600, n_pad=3000, hub=700)
    tdt = getattr(torch, dtype)
    x = torch.tensor(c["x"], device="cuda").to(tdt)
    layout = _layout(c, lambda a: torch.tensor(a, device="cuda"))
    w, s, rp = layout[0], layout[2], layout[4]
    n = c["n"]
    _twice_equal(lambda: K.spmm_csr(x, *layout, n))
    g = torch.tensor(np.random.default_rng(F).normal(size=(n, F)),
                     device="cuda").to(tdt)

    def d_h():
        h = x.detach().clone().requires_grad_()
        K.spmm_csr(h, *layout, n).backward(g)
        return h.grad

    _twice_equal(d_h)
    msgs = x[s.long()].contiguous()
    r = torch.tensor(c["r"], device="cuda")
    _twice_equal(lambda: K.segment_sum_sorted(msgs, r, n))
    _twice_equal(lambda: K.sorted_segment_sum(msgs, r, rp, n))
    xb, sb, _, wb, rpb, nb = _band_case(F, F)
    xb = torch.tensor(xb, device="cuda").to(tdt)
    sb, wb, rpb = (torch.tensor(a, device="cuda") for a in (sb, wb, rpb))
    _twice_equal(lambda: K.banded_sorted_spmm(xb, sb, rpb, wb, nb,
                                              window=256))


BMM_VARIANTS = [(False, False), (True, False), (False, True)]
# (batch, n, m, f): the dense regime's two shapes, two ragged ones the
# "tma" route cannot address, and three ragged ones it can (zero fill and
# clipped stores at every edge; f = 200 takes two column tiles; rows of
# 16 bytes, far narrower than a box)
BMM_SIZES = [(64, 256, 256, 128), (64, 128, 128, 128), (3, 40, 24, 17),
             (5, 70, 130, 33), (3, 200, 136, 120), (2, 40, 72, 200),
             (2, 24, 8, 8)]
BMM_TMA_SIZES = {(64, 256, 256, 128), (64, 128, 128, 128),
                 (3, 200, 136, 120), (2, 40, 72, 200), (2, 24, 8, 8)}


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
    counted launch per call, on the route the shape rule names."""
    _skip_without_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bmm_operands(*size, trans_a, trans_b, dtype)
    want = "tma" if size in BMM_TMA_SIZES else "generic"
    assert BMM.route(a, b, trans_a, trans_b) == want
    before = BMM.bmm.launches
    before_route = BMM.bmm.launches_by_route[want]
    got = BMM.bmm(a, b, trans_a, trans_b)
    torch.cuda.synchronize()
    assert BMM.bmm.launches == before + 1
    assert BMM.bmm.launches_by_route[want] == before_route + 1
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
    _skip_without_card()
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


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", BMM_VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_cuda_bmm_f32_rows_of_four_take_tma_route(trans_a, trans_b):
    """f32 operands whose stored rows are 4 wide (16 bytes, the least TMA
    and the converting producer take) on the "tma" route."""
    _skip_without_card()
    a, b = _bmm_operands(3, 20, 4, 4, trans_a, trans_b, "float32", seed=8)
    assert BMM.route(a, b, trans_a, trans_b) == "tma"
    before = BMM.bmm.launches_by_route["tma"]
    got = BMM.bmm(a, b, trans_a, trans_b)
    torch.cuda.synchronize()
    assert BMM.bmm.launches_by_route["tma"] == before + 1
    _bmm_check(got, BMM.bmm_plain(a, b, trans_a, trans_b),
               BMM.bmm_plain(a.abs(), b.abs(), trans_a, trans_b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bmm_misaligned_view_takes_generic_route(dtype):
    """An operand whose base is off 16 bytes goes to the "generic" route
    (never to TMA) and still agrees with ``bmm_plain``."""
    _skip_without_card()
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(2 * 64 * 64 + 1, generator=g, device="cuda").to(tdt)
    a = a[1:].view(2, 64, 64)
    b = torch.randn(2, 64, 128, generator=g, device="cuda").to(tdt)
    assert BMM.route(a, b) == "generic"
    before = BMM.bmm.launches_by_route["generic"]
    got = BMM.bmm(a, b)
    torch.cuda.synchronize()
    assert BMM.bmm.launches_by_route["generic"] == before + 1
    _bmm_check(got, BMM.bmm_plain(a, b), BMM.bmm_plain(a.abs(), b.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_a,trans_b", BMM_VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_cuda_bmm_backward_on_tma_route(trans_a, trans_b, dtype):
    """The autograd backward at an aligned ragged size: all three products
    on the "tma" route, each gradient within 1e-5 of its Σ|·||·| (plus
    one bf16 rounding) of the CPU run."""
    _skip_without_card()
    size = (3, 200, 136, 120)
    a, b = _bmm_operands(*size, trans_a, trans_b, dtype, seed=6)
    g = torch.randn(size[0], size[1], size[3], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    grads = {}
    for dev in ("cuda", "cpu"):
        x = a.detach().to(dev).requires_grad_()
        y = b.detach().to(dev).requires_grad_()
        before = BMM.bmm.launches_by_route["tma"]
        BMM.bmm(x, y, trans_a, trans_b).backward(g.to(dev))
        assert BMM.bmm.launches_by_route["tma"] - before == (
            3 if dev == "cuda" else 0)
        grads[dev] = (x.grad, y.grad)
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
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
    _bmm_check(grads["cuda"][0], grads["cpu"][0], sa, slack)
    _bmm_check(grads["cuda"][1], grads["cpu"][1], sb, slack)


def _scaled(got, ref, scale, rel):
    """|kernel − plain| ≤ rel · Σ|terms| (other f32 sum orders, and for
    bf16 outputs one rounding)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert ((got - ref).abs() <= rel * scale.float().cpu() + 1e-6).all()


def _rel_of(dtype):
    return 1e-4 if dtype == "float32" else 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 33, 130])
@pytest.mark.parametrize("n_pad,hub", [(N_PAD_EDGES, 0), (3000, 700)])
def test_cuda_spmm_csr_backward_matches_cpu(F, dtype, n_pad, hub):
    """K1's autograd backward on the card (the forward and ``d_h`` each
    one counted launch, ``d_w`` a plain gather-and-dot) against the same
    ``autograd.Function`` on CPU copies; with 3000 padding edges row 0 of
    both layouts is long, with a hub a middle row."""
    _skip_without_card()
    c = _csr_case(40 + F, F, e=900 + hub, n_pad=n_pad, hub=hub)
    tdt = getattr(torch, dtype)
    g = np.random.default_rng(F).normal(size=(c["n"], F)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        h = torch.tensor(c["x"], device=dev).to(tdt).requires_grad_()
        layout = list(_layout(c, lambda a: torch.tensor(a, device=dev)))
        layout[0].requires_grad_()
        before = K.spmm_csr.launches
        K.spmm_csr(h, *layout, c["n"]).backward(
            torch.tensor(g, device=dev).to(tdt))
        if dev == "cuda":
            torch.cuda.synchronize()
        assert K.spmm_csr.launches - before == (2 if dev == "cuda" else 0)
        grads[dev] = (h.grad, layout[0].grad)
    # d_h's Σ|terms|: |w_t| · |g| over the transpose layout
    scale = np.zeros((c["n"], F))
    gb = np.abs(torch.tensor(g).to(tdt).float().numpy())
    np.add.at(scale, c["s_t"], np.abs(c["w_t"])[:, None] * gb[c["r_t"]])
    _scaled(grads["cuda"][0], grads["cpu"][0], torch.tensor(scale),
            _rel_of(dtype))
    torch.testing.assert_close(grads["cuda"][1].cpu(), grads["cpu"][1],
                               rtol=1e-5, atol=1e-5)


def _sorted_case(seed, F, num_rows=256, e=3000, hub_rows=(77,), hub=400,
                 empty=(5,), tail=50):
    """Receiver-sorted messages over ``num_rows`` rows: ``hub`` edges in
    each hub row (longer than a warp's 256), empty rows, and ``tail``
    padding edges past ``row_ptr[num_rows]``."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, num_rows, e)]
                       + [np.full(hub, h) for h in hub_rows])
    r = np.sort(r[~np.isin(r, empty)]).astype(np.int32)
    rp = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=num_rows))]
                        ).astype(np.int32)
    msgs = rng.normal(size=(r.shape[0] + tail, F)).astype(np.float32)
    rids = np.concatenate([r, np.full(tail, num_rows, np.int32)])
    return msgs, rids, rp, num_rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 33, 130])
def test_cuda_sorted_segment_sum_matches_plain(F, dtype):
    """K4 against its plain version (empty rows, a 400-edge row, padding
    past ``row_ptr[num_rows]``), and its gather gradient."""
    _skip_without_card()
    msgs, rids, rp, n = _sorted_case(F, F)
    tdt = getattr(torch, dtype)
    m = torch.tensor(msgs, device="cuda").to(tdt).requires_grad_()
    rid_t = torch.tensor(rids, device="cuda")
    rp_t = torch.tensor(rp, device="cuda")
    before = K.sorted_segment_sum.launches
    got = K.sorted_segment_sum(m, rid_t, rp_t, n)
    torch.cuda.synchronize()
    assert K.sorted_segment_sum.launches == before + 1
    ref = K.sorted_segment_sum_plain(m.detach(), rid_t, rp_t, n)
    scale = K.sorted_segment_sum_plain(m.detach().float().abs(), rid_t,
                                       rp_t, n)
    _scaled(got, ref, scale, _rel_of(dtype))
    assert not got[5].any()
    g = torch.randn(n, F, device="cuda").to(tdt)
    got.backward(g)
    assert torch.equal(m.grad, g[rid_t.clamp(0, n - 1).long()])


def _band_case(seed, F, n=1000, e=6000, bw=60, break_every=97,
               num_rows=1024):
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, e))
    r = np.sort(np.concatenate([r[r != 300], np.full(400, 500)])
                ).astype(np.int32)  # row 300 empty, row 500 long
    s = np.clip(r + rng.integers(-bw, bw + 1, r.shape[0]), 0, n - 1
                ).astype(np.int32)
    s[::break_every] = rng.integers(0, n, s[::break_every].shape[0])
    w = rng.normal(size=r.shape[0]).astype(np.float32)
    rp = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=num_rows))]
                        ).astype(np.int32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return x, s, r, w, rp, num_rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 33, 130])
@pytest.mark.parametrize("window", [128, 256])
def test_cuda_banded_sorted_spmm_matches_plain(window, F, dtype):
    """K5's windowed mode against its plain version, on a layout whose
    every 97th sender leaves its block's window (those add 0 in both), an
    empty row and a 400-edge row; then ``spmm_banded``'s gradients on the
    card against the CPU."""
    _skip_without_card()
    x, s, r, w, rp, n = _band_case(F + window, F)
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, device="cuda").to(tdt)
    st, rt, wt = (torch.tensor(a, device="cuda") for a in (s, r, w))
    rpt = torch.tensor(rp, device="cuda")
    before = K.banded_sorted_spmm.launches
    got = K.banded_sorted_spmm(xt, st, rpt, wt, n, window=window)
    torch.cuda.synchronize()
    assert K.banded_sorted_spmm.launches == before + 1
    ref = K.banded_sorted_spmm_plain(xt, st, rpt, wt, n, window=window)
    scale = K.banded_sorted_spmm_plain(xt.float().abs(), st, rpt, wt.abs(),
                                       n, window=window)
    _scaled(got, ref, scale, _rel_of(dtype))
    full = K.spmm_csr_plain(xt.float(), wt, st, rpt, n)
    assert (full - ref.float()).abs().max() > 1e-2  # the windows cut edges
    grads = {}
    for dev in ("cuda", "cpu"):
        xd = xt.detach().to(dev).requires_grad_()
        wd = wt.detach().to(dev).requires_grad_()
        out = K.spmm_banded(xd, st.to(dev), rt.to(dev), wd, 1000,
                            window=window)
        out.float().square().sum().backward()
        grads[dev] = (out.detach(), xd.grad, wd.grad)
    for a, b in zip(*grads.values()):
        torch.testing.assert_close(a.cpu().float(), b.float(),
                                   rtol=2e-2, atol=2e-2 * float(
                                       b.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 33, 128, 130])
def test_cuda_banded_sddmm_matches_plain(F, dtype):
    """K6 against its plain version: padding ids (``Na``/``Nb``), a
    negative id, ids above their chunk's window on either axis, E not a
    multiple of the 512-edge chunk; then ``sddmm_banded``'s gradients."""
    _skip_without_card()
    rng = np.random.default_rng(F)
    na, nb, e = 1500, 1400, 5000
    s = np.clip(np.sort(rng.integers(0, na, e)) + rng.integers(-40, 40, e),
                0, na - 1).astype(np.int32)
    r = np.clip(np.sort(rng.integers(0, nb, e)) + rng.integers(-40, 40, e),
                0, nb - 1).astype(np.int32)
    s[5], r[7], s[900], r[2100], s[2500] = na, nb, na - 1, nb - 1, -3
    tdt = getattr(torch, dtype)
    a = torch.tensor(rng.normal(size=(na, F)).astype(np.float32),
                     device="cuda").to(tdt)
    b = torch.tensor(rng.normal(size=(nb, F)).astype(np.float32),
                     device="cuda").to(tdt)
    st, rt = torch.tensor(s, device="cuda"), torch.tensor(r, device="cuda")
    before = SD.banded_sddmm.launches
    got = SD.banded_sddmm(a, b, st, rt, window=256)
    torch.cuda.synchronize()
    assert SD.banded_sddmm.launches == before + 1
    ref = SD.banded_sddmm_plain(a, b, st, rt, window=256)
    scale = SD.banded_sddmm_plain(a.abs(), b.abs(), st, rt, window=256)
    _scaled(got, ref, scale, 1e-5)
    assert (got[[5, 7, 900, 2100, 2500]] == 0).all()
    assert torch.equal(got == 0, ref == 0)
    grads = {}
    for dev in ("cuda", "cpu"):
        ad = a.detach().to(dev).requires_grad_()
        bd = b.detach().to(dev).requires_grad_()
        SD.sddmm_banded(ad, bd, st.to(dev), rt.to(dev),
                        window=256).square().sum().backward()
        grads[dev] = (ad.grad, bd.grad)
    for x, y in zip(*grads.values()):
        torch.testing.assert_close(x.cpu().float(), y.float(), rtol=2e-2,
                                   atol=2e-2 * float(y.float().abs().max()))


def _sddmm_case(case, F, seed=0):
    """Edges for K6's cases, E not a multiple of the 512-edge chunk:
    ``banded`` (receiver-sorted, |s − r| ≤ 120), ``hub`` (one receiver's
    1,600 edges over four chunks), ``falling`` (every other chunk's
    senders drop to the bottom rows, so window starts fall and rise),
    ``unsorted`` (receivers and senders in random order), ``padding``
    (padding ids ``Na``/``Nb``, a negative id, ids past their window) and
    ``wide`` (a window wider than the block's rings, random ids)."""
    rng = np.random.default_rng(seed)
    na, nb, e, window = 3000, 2600, 7001, 512
    r = np.sort(rng.integers(0, nb, e))
    s = np.clip(r + rng.integers(-120, 121, e), 0, na - 1)
    if case == "hub":
        r[2000:3600] = 1234
        s[2000:3600] = np.clip(1234 + rng.integers(-200, 200, 1600), 0,
                               na - 1)
    elif case == "falling":
        for c in range(1, e // 512 + 1, 2):
            s[c * 512:(c + 1) * 512] = rng.integers(0, 300, min(512, e -
                                                                c * 512))
    elif case == "unsorted":
        r = rng.integers(0, nb, e)
        s = rng.integers(0, na, e)
    elif case == "padding":
        s[rng.integers(0, e, 40)] = na
        r[rng.integers(0, e, 40)] = nb
        s[17], r[4000] = -3, nb - 1  # r[4000] far past its chunk's window
    elif case == "wide":
        na, nb, window = 5000, 5000, 4096
        s, r = rng.integers(0, na, e), rng.integers(0, nb, e)
    a = rng.normal(size=(na, F)).astype(np.float32)
    b = rng.normal(size=(nb, F)).astype(np.float32)
    return (a, b, s.astype(np.int32), r.astype(np.int32), window)


SDDMM_CASES = ["banded", "hub", "falling", "unsorted", "padding", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 36, 128, 200])
@pytest.mark.parametrize("case", SDDMM_CASES)
def test_cuda_banded_sddmm_rings(case, F, dtype):
    """The ring kernel (K6) against its plain version within 1e-5 of
    Σ|terms| (the same f32 products, summed in another order), on inputs
    that leave the banded shape: a hub receiver, falling window starts,
    unsorted ids, padding ids, windows wider than the rings; 16-byte
    copies where rows are aligned (F·size % 16 == 0), element copies
    elsewhere; two runs equal bit for bit, one launch each."""
    _skip_without_card()
    a, b, s, r, window = _sddmm_case(case, F, seed=F)
    tdt = getattr(torch, dtype)
    at, bt = (torch.tensor(v, device="cuda").to(tdt) for v in (a, b))
    st, rt = torch.tensor(s, device="cuda"), torch.tensor(r, device="cuda")
    before = SD.banded_sddmm.launches
    got = _twice_equal(lambda: SD.banded_sddmm(at, bt, st, rt,
                                               window=window))
    assert SD.banded_sddmm.launches == before + 2
    ref = SD.banded_sddmm_plain(at, bt, st, rt, window=window)
    scale = SD.banded_sddmm_plain(at.abs(), bt.abs(), st, rt, window=window)
    _scaled(got, ref, scale, 1e-5)
    assert torch.equal(got == 0, ref == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_banded_sddmm_unaligned_rows(dtype):
    """Views one element off 16-byte alignment take the element-copy
    path."""
    _skip_without_card()
    a, b, s, r, window = _sddmm_case("banded", 128, seed=3)
    tdt = getattr(torch, dtype)

    def skew(v):
        t = torch.tensor(v, device="cuda").to(tdt)
        return torch.empty(t.numel() + 1, dtype=tdt,
                           device="cuda")[1:].view(t.shape).copy_(t)

    at, bt = skew(a), skew(b)
    st, rt = torch.tensor(s, device="cuda"), torch.tensor(r, device="cuda")
    got = _twice_equal(lambda: SD.banded_sddmm(at, bt, st, rt,
                                               window=window))
    ref = SD.banded_sddmm_plain(at, bt, st, rt, window=window)
    scale = SD.banded_sddmm_plain(at.abs(), bt.abs(), st, rt, window=window)
    _scaled(got, ref, scale, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("graphs", [1, 3, 64])
def test_cuda_readout_takes_k4(graphs, ascending):
    """The sparse sum readout on the card: one K4 launch, equal bit for bit
    twice, within 1e-5 of Σ|terms| of the CPU's plain route, with masked
    rows and padding nodes in the last graph; its gradient the gather
    ``g[graph]`` on kept rows."""
    from tgp_tpu_torch.reduce.global_reduce import global_reduce

    _skip_without_card()
    rng = np.random.default_rng(graphs)
    n = 5000
    ng = np.sort(rng.integers(0, graphs, n)).astype(np.int32)
    ng[-100:] = graphs - 1
    if not ascending:
        ng = rng.permutation(ng)
    nm = rng.random(n) > 0.2
    x = rng.normal(size=(n, 128)).astype(np.float32)
    args = dict(node_graph=torch.tensor(ng, device="cuda"),
                num_graphs=graphs, node_mask=torch.tensor(nm, device="cuda"))
    xt = torch.tensor(x, device="cuda", requires_grad=True)
    before = K.sorted_segment_sum.launches
    got = _twice_equal(lambda: global_reduce(xt, **args))
    assert K.sorted_segment_sum.launches == before + 2
    cpu = dict(node_graph=torch.tensor(ng), num_graphs=graphs,
               node_mask=torch.tensor(nm))
    ref = global_reduce(torch.tensor(x), **cpu)
    scale = global_reduce(torch.tensor(np.abs(x)), **cpu)
    _scaled(got, ref, scale, 1e-5)
    g = torch.randn(graphs, 128, device="cuda")
    got.backward(g)
    keep = torch.tensor(nm, device="cuda")[:, None]
    assert torch.equal(xt.grad, torch.where(
        keep, g[torch.tensor(ng, device="cuda").long()], 0.0))


# ---------------------------------------------------------------------------
# K4's "long" route (segment_reduce.cu) and the readout's gathered sum
# ---------------------------------------------------------------------------


def _long_case(lengths, F, seed, tail=37):
    """Messages ``[E + tail, F]`` (``tail`` rows past ``row_ptr[-1]`` that
    no sum may read: NaN) over segments of the given lengths."""
    rng = np.random.default_rng(seed)
    rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    e = int(rp[-1])
    msgs = np.concatenate([rng.normal(size=(e, F)),
                           np.full((tail, F), np.nan)]).astype(np.float32)
    rids = np.concatenate([np.repeat(np.arange(len(lengths)), lengths),
                           np.full(tail, len(lengths))]).astype(np.int32)
    return msgs, rids, rp


def _check_long(msgs, rids, rp, dtype):
    """K4's "long" kernel twice (bit-equal, one counted launch each on its
    route) against its plain version."""
    tdt = getattr(torch, dtype)
    n = rp.shape[0] - 1
    m = torch.tensor(msgs, device="cuda").to(tdt)
    r, p = torch.tensor(rids, device="cuda"), torch.tensor(rp, device="cuda")
    before = dict(K.sorted_segment_sum.launches_by_route)
    # the route's own entry: the rule would send short segments to "wide"
    got = _twice_equal(lambda: K._k4_sum(m, None, None, p, n, "long"))
    assert K.sorted_segment_sum.launches_by_route == dict(
        before, long=before["long"] + 2)
    _close(got, K.sorted_segment_sum_plain(m, r, p, n),
           K.sorted_segment_sum_plain(m.float().abs(), r, p, n), dtype)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 36, 128, 200])
@pytest.mark.parametrize("rows", [0, 1, 255, 65_536, 65_537])
def test_cuda_k4_long_one_segment(rows, F, dtype):
    """One segment of 0 to 65,537 rows (one chunk, many chunks, many
    first-level groups), the rows past ``row_ptr[1]`` NaN and unread."""
    _skip_without_card()
    got = _check_long(*_long_case([rows], F, seed=rows + F), dtype)
    if rows == 0:
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 36, 128, 200])
def test_cuda_k4_long_many_segments(F, dtype):
    """Empty, short and long segments mixed (runs of empty rows inside a
    chunk, rows ending on and across chunk and group boundaries)."""
    _skip_without_card()
    rng = np.random.default_rng(F)
    lengths = rng.choice([0, 0, 1, 3, 64, 300, 5000, 70_000], 120)
    got = _check_long(*_long_case(lengths, F, seed=F), dtype)
    assert not got[torch.tensor(lengths == 0, device="cuda")].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("graphs", [1, 64, 1024])
def test_cuda_readout_gather_equals_unfused(graphs, dtype):
    """The readout's gathered sum (rows read through the sort order, masked
    rows skipped) against the sum it replaced on the same route's kernel
    (``"long"`` for 1 and 64 graphs, ``"wide"`` for 1,024): the rows zeroed,
    sorted and copied, then ``sorted_segment_sum``; equal bit for bit,
    also with NaN and inf in masked rows, and twice."""
    _skip_without_card()
    rng = np.random.default_rng(graphs)
    n = 16_384
    ng = rng.permutation(np.sort(rng.integers(0, graphs, n))).astype(
        np.int32)
    keep = rng.random(n) > 0.5
    x = rng.normal(size=(n, 128)).astype(np.float32)
    x[np.flatnonzero(~keep)[:3]] = np.array([[np.nan], [np.inf], [-np.inf]])
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, device="cuda").to(tdt)
    kt, ids = (torch.tensor(a, device="cuda") for a in (keep, ng))
    rids, perm = torch.sort(ids, stable=True)
    rp = torch.searchsorted(rids, torch.arange(graphs + 1, device="cuda",
                                               dtype=torch.int32),
                            out_int32=True)
    perm = perm.to(torch.int32)
    route = K.segment_route(graphs, n, 128)
    assert route == ("wide" if graphs == 1024 else "long")
    before = dict(K.sorted_segment_sum.launches_by_route)
    fused = _twice_equal(lambda: K.gather_segment_sum(xt, perm, kt, ids, rp,
                                                      graphs))
    assert K.sorted_segment_sum.launches_by_route == dict(
        before, **{route: before[route] + 2})
    rows = torch.where(kt[:, None], xt, 0.0)[perm.long()].contiguous()
    unfused = K.sorted_segment_sum(rows, rids, rp, graphs)
    assert torch.isfinite(fused.float()).all()
    assert torch.equal(fused, unfused)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 4, 36, 128])
@pytest.mark.parametrize("route", ["long", "wide"])
def test_cuda_readout_gather_on_each_route(route, F, dtype):
    """The gathered sum on either kernel (the narrow mode too, F <= 4)
    against its plain version: ids in any order, empty graphs, NaN and inf
    in masked rows, rows past the order's length unread; twice bit-equal,
    one counted launch a call on the route."""
    _skip_without_card()
    rng = np.random.default_rng(F)
    graphs, n = 300, 9000
    ng = rng.integers(0, graphs, n).astype(np.int32)
    ng[ng % 7 == 3] = 5  # graphs 3, 10, ... empty, graph 5 long
    keep = rng.random(n) > 0.3
    x = rng.normal(size=(n + 11, F)).astype(np.float32)
    x[np.flatnonzero(~keep)[:3]] = np.array([[np.nan], [np.inf], [-np.inf]])
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, device="cuda").to(tdt)
    kt = torch.tensor(np.concatenate([keep, np.zeros(11, bool)]),
                      device="cuda")
    rids, perm = torch.sort(torch.tensor(ng, device="cuda"), stable=True)
    perm = perm.to(torch.int32)
    rp = torch.searchsorted(rids, torch.arange(graphs + 1, device="cuda",
                                               dtype=torch.int32),
                            out_int32=True)
    before = dict(K.sorted_segment_sum.launches_by_route)
    got = _twice_equal(lambda: K._k4_sum(xt, perm, kt, rp, graphs, route))
    assert K.sorted_segment_sum.launches_by_route == dict(
        before, **{route: before[route] + 2})
    assert torch.isfinite(got.float()).all()
    _close(got, K.gather_segment_sum_plain(xt, perm, kt, rp, graphs),
           K.gather_segment_sum_plain(xt.float().abs(), perm, kt, rp,
                                      graphs), dtype)
    assert not got[torch.bincount(rids.long(), minlength=graphs) == 0].any()


# ---------------------------------------------------------------------------
# K5: banded_spmm.cu's ring
# ---------------------------------------------------------------------------


def _banded_ring_case(case, F, seed):
    """K6's edge cases (``_sddmm_case``) as a receiver-sorted K5 layout over
    rows padded to 128: senders beside their receivers, a hub receiver,
    falling window starts, random senders, padding and negative senders,
    a window wider than the ring."""
    a, b, s, r, window = _sddmm_case(case, F, seed=seed)
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    num_rows = -(-b.shape[0] // 128) * 128
    rp = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=num_rows))]
                        ).astype(np.int32)
    w = np.random.default_rng(seed).normal(size=s.shape[0]).astype(
        np.float32)
    return a, s.astype(np.int32), w, rp, num_rows, window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 36, 128, 200])
@pytest.mark.parametrize("case", SDDMM_CASES)
def test_cuda_banded_spmm_ring(case, F, dtype):
    """K5's ring kernel against its plain version within 1e-5 of Σ|terms|
    (plus one bf16 rounding), on inputs that leave the banded shape; the
    16-byte route where rows are 16-byte aligned, the element route
    elsewhere; two runs equal bit for bit, one launch each."""
    _skip_without_card()
    x, s, w, rp, n, window = _banded_ring_case(case, F, seed=F)
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, device="cuda").to(tdt)
    st, wt, rpt = (torch.tensor(v, device="cuda") for v in (s, w, rp))
    want = "vector" if (F * xt.element_size()) % 16 == 0 else "element"
    assert K.banded_route(xt) == want
    before = dict(K.banded_sorted_spmm.launches_by_route)
    got = _twice_equal(lambda: K.banded_sorted_spmm(xt, st, rpt, wt, n,
                                                    window=window))
    assert K.banded_sorted_spmm.launches_by_route == dict(
        before, **{want: before[want] + 2})
    _close(got, K.banded_sorted_spmm_plain(xt, st, rpt, wt, n,
                                           window=window),
           K.banded_sorted_spmm_plain(xt.float().abs(), st, rpt, wt.abs(),
                                      n, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_banded_spmm_unaligned_rows(dtype):
    """x one element off 16-byte alignment takes the element route."""
    _skip_without_card()
    x, s, w, rp, n, window = _banded_ring_case("banded", 128, seed=5)
    tdt = getattr(torch, dtype)
    t = torch.tensor(x, device="cuda").to(tdt)
    xt = torch.empty(t.numel() + 1, dtype=tdt,
                     device="cuda")[1:].view(t.shape).copy_(t)
    st, wt, rpt = (torch.tensor(v, device="cuda") for v in (s, w, rp))
    assert K.banded_route(xt) == "element"
    got = _twice_equal(lambda: K.banded_sorted_spmm(xt, st, rpt, wt, n,
                                                    window=window))
    _close(got, K.banded_sorted_spmm_plain(xt, st, rpt, wt, n,
                                           window=window),
           K.banded_sorted_spmm_plain(xt.float().abs(), st, rpt, wt.abs(),
                                      n, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_rows,n_x", [(64, 1000), (256, 1000),
                                            (128, 100)])
def test_cuda_banded_spmm_block_rows_and_small_x(block_rows, n_x, dtype):
    """Receiver blocks of 64 or 256 rows (the ring kernel's steps and
    staged offsets follow them), and x with fewer rows than the window
    (every window starts at 0 and ends at x's last row)."""
    _skip_without_card()
    x, s, r, w, rp, n = _band_case(block_rows + n_x, 36, n=n_x,
                                   e=6 * n_x, bw=30,
                                   num_rows=-(-n_x // block_rows) * block_rows)
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, device="cuda").to(tdt)
    st, wt, rpt = (torch.tensor(a, device="cuda") for a in (s, w, rp))
    got = _twice_equal(lambda: K.banded_sorted_spmm(
        xt, st, rpt, wt, n, window=128, block_rows=block_rows))
    _close(got, K.banded_sorted_spmm_plain(xt, st, rpt, wt, n, window=128,
                                           block_rows=block_rows),
           K.banded_sorted_spmm_plain(xt.float().abs(), st, rpt, wt.abs(),
                                      n, window=128, block_rows=block_rows),
           dtype)


@pytest.mark.cuda
def test_cuda_gcn_sorted_branch_is_bit_equal_twice():
    """``GCNConv``'s sorted branch (no CSR offsets): the degree and the
    messages both through K2's fixed-order sum, so two runs give the same
    bits."""
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.mp.gcn import GCNConv

    _skip_without_card()
    rng = np.random.default_rng(3)
    graphs = []
    for n in (700, 300, 900):
        e = 8 * n
        graphs.append((rng.normal(size=(n, 16)).astype(np.float32),
                       np.stack([rng.integers(0, n, e),
                                 rng.integers(0, n, e)])))
    batch = from_graphs(graphs, sort_edges=True, device="cuda").replace(
        row_ptr=None, in_degree=None)
    conv = GCNConv(16, 32, use_kernel=True, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    before = K.segment_sum_sorted.launches
    with torch.no_grad():
        _twice_equal(lambda: conv(batch))
    assert K.segment_sum_sorted.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["unit", "float"])
def test_cuda_csr_build_is_the_cpu_build_with_no_sync(weights):
    """``from_graphs(sort_edges=True)``'s CSR build on the card at the
    large serving cell's shapes (65,536 nodes, 1,000,000 edges in
    1,048,576 slots): every array equal to the CPU build's bit for bit,
    ``in_degree`` too (each row's f64 sum in edge order on both); a second
    build on the card bit-equal to the first, made under
    ``torch.cuda.set_sync_debug_mode("error")`` and behind ~0.2 s of
    spinning that it returns before, so with no host sync."""
    from tgp_tpu_torch import graph as G

    _skip_without_card()
    rng = np.random.default_rng(21)
    n, e = 65536, 1_000_000
    g = (rng.normal(size=(n, 128)).astype(np.float32),
         np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    if weights == "float":
        g = g + ((rng.random(e) + 0.1).astype(np.float32),)
    kw = dict(pad_nodes=n, pad_edges=1 << 20, sort_edges=True)
    cpu = G.from_graphs([g], device="cpu", **kw)
    card = G.from_graphs([g], device="cuda", **kw)
    layout = ("senders", "receivers", "edge_weight", "edge_mask", "row_ptr",
              "senders_t", "receivers_t", "edge_weight_t", "row_ptr_t",
              "in_degree")
    for f in layout:
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    host = oracle.pack([g], n, 1 << 20, None, 8, 128, np.float32)[0]
    again = {k: torch.from_numpy(a).cuda() for k, a in host.items()}
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    spun = torch.cuda.Event()
    spun.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        G._csr_layout(again, e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not spun.query()  # enqueued while the card still spun
    torch.cuda.synchronize()
    for f in layout:
        assert torch.equal(again[f], getattr(card, f)), f


def _dd_request(rng, F=128):
    """Eight graphs of ``portbench``'s ``dd-requests-of-8`` distribution:
    log-normal node counts (mean 284.3, sigma_log 0.8, clipped to D&D's
    30..5,748), uniform pairs of distinct nodes at mean degree 5.0342 in
    both directions, normal features."""
    sigma = 0.8
    ns = np.clip(np.rint(rng.lognormal(np.log(284.3) - sigma ** 2 / 2,
                                       sigma, 8)), 30, 5748).astype(int)
    out = []
    for n in ns:
        m = int(round(n * 5.0342 / 2))
        a = rng.integers(0, n, m)
        b = (a + rng.integers(1, n, m)) % n
        out.append((rng.normal(size=(n, F)).astype(np.float32),
                    np.stack([np.concatenate([a, b]),
                              np.concatenate([b, a])])))
    return out


def _large_request(rng, n, e, F=128):
    """One graph of ``n`` nodes and ``e`` uniform directed edges."""
    return [(rng.normal(size=(n, F)).astype(np.float32),
             np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))]


def _same_bucket_larger_first(requests, pred):
    """``requests`` grouped by ``pred``'s bucket, each group larger first
    (by real nodes, then edges); asserts that some bucket holds requests
    of different sizes."""
    def size(r):
        return (sum(g[0].shape[0] for g in r), sum(g[1].shape[1] for g in r))

    groups = {}
    for r in requests:
        groups.setdefault(pred._budget(r), []).append(r)
    assert any(len({size(r) for r in g}) > 1 for g in groups.values())
    return [r for g in groups.values() for r in sorted(g, key=size,
                                                       reverse=True)]


def _serve_twice(requests, apply, monkeypatch, **kw):
    """The requests served one call each by a ``Predictor``, then by one
    whose batches come from the oracle's collation: both predictors'
    outputs and the batches each fed ``apply``."""
    from tgp_tpu_torch import Predictor
    from tgp_tpu_torch.models import inference

    runs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(inference, "from_graphs", oracle.from_graphs)
        seen = []
        pred = Predictor(lambda b: (seen.append(b), apply(b))[1],
                         device="cuda", **kw)
        outs = [pred(r) for r in requests]
        torch.cuda.synchronize()
        runs.append((outs, seen))
    return runs


@pytest.mark.cuda
def test_cuda_served_small_batches_match_oracle(monkeypatch):
    """Requests of eight D&D-sized graphs through one ``Predictor``, larger
    first and then smaller within each bucket: every batch equals the
    oracle's (the padded numpy packing copied whole) bit for bit, and the
    served bf16 model's logits equal those of a ``Predictor`` fed the
    oracle's batches, bit for bit."""
    from tgp_tpu_torch import PoolingClassifier, Predictor, get_pooler

    _skip_without_card()
    torch.manual_seed(3)
    model = PoolingClassifier(
        get_pooler("topk", in_channels=128, ratio=0.5, device="cuda"),
        num_classes=2, hidden=128, in_channels=128, readout="mean",
        compute_dtype=torch.bfloat16, device="cuda").eval()
    rng = np.random.default_rng(24)
    requests = _same_bucket_larger_first(
        [_dd_request(rng) for _ in range(40)],
        Predictor(None, batch_size=8, device="cuda"))
    (got, seen), (want, fed) = _serve_twice(
        requests, lambda b: model(b)[0], monkeypatch, batch_size=8)
    assert len(seen) == len(fed) == len(requests)
    for a, b in zip(seen, fed):
        assert oracle.mismatches(a, b) == []
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(65536, 1_000_000), (169_343, 1_166_243)],
                         ids=["large-graph", "arxiv-size"])
def test_cuda_served_large_batches_match_oracle(n, e, monkeypatch):
    """Two different requests at a large serving cell's shape (one graph,
    ``sort_edges=True``) through one ``Predictor(batch_size=1)``: every
    array of each batch, the CSR layout included, equals the oracle's."""
    _skip_without_card()
    rng = np.random.default_rng(n)
    requests = [_large_request(rng, n, e) for _ in range(2)]
    (_, seen), (_, fed) = _serve_twice(
        requests, lambda b: b.x[:b.num_graphs, :2], monkeypatch,
        batch_size=1, sort_edges=True)
    assert len(seen) == len(fed) == 2
    for a, b in zip(seen, fed):
        assert a.num_nodes == (262_144 if n > 65536 else n)
        assert oracle.mismatches(a, b) == []


def _bucket_of(graphs):
    """``from_graphs`` keywords of the serving bucket of ``graphs``."""
    from tgp_tpu_torch import Predictor

    pn, pe, mx = Predictor(None, device="cuda")._budget(graphs)
    return dict(pad_nodes=pn, pad_edges=pe, max_nodes=mx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "large"])
def test_cuda_collation_stage_is_not_reused_before_its_copy(shape):
    """Request A collated behind ~1 s of spinning on the card, then a
    smaller request B padded to A's bucket before any sync: B's real rows
    are written while A's copies still wait, so B must get other
    page-locked memory.  Collating both returns before the spin ends, and
    afterwards A's arrays are still exactly A's (and B's B's)."""
    from tgp_tpu_torch import graph as G

    _skip_without_card()
    rng = np.random.default_rng(7)
    if shape == "small":
        big = _dd_request(rng)
        small = [(x[: x.shape[0] // 2], ei[:, (ei < x.shape[0] // 2).all(0)])
                 for x, ei in big]
    else:
        big, small = (_large_request(rng, 65536, m) for m in (900_000,
                                                              800_000))
    kw = _bucket_of(big)
    # two stages of this size cached: the second asked for while the first
    # waits on its copy
    torch.cuda._sleep(200_000_000)
    G.from_graphs(big, device="cuda", **kw)
    G.from_graphs(small, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    spun = torch.cuda.Event()
    spun.record()
    a = G.from_graphs(big, device="cuda", **kw)
    b = G.from_graphs(small, device="cuda", **kw)
    assert not spun.query()  # both collated while the card still spun
    torch.cuda.synchronize()
    assert oracle.mismatches(a, oracle.from_graphs(big, device="cuda",
                                                   **kw)) == []
    assert oracle.mismatches(b, oracle.from_graphs(small, device="cuda",
                                                   **kw)) == []


@pytest.mark.cuda
@pytest.mark.parametrize("sort_edges", [False, True])
@pytest.mark.parametrize("shape", ["small", "large"])
def test_cuda_collation_enqueues_with_no_sync(shape, sort_edges):
    """``from_graphs`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` and behind ~1 s of
    spinning that it returns before: its checks are numpy's on the host,
    and its copies, fills and CSR build read nothing back.  The batch
    equals the oracle's."""
    from tgp_tpu_torch import graph as G

    _skip_without_card()
    rng = np.random.default_rng(8)
    graphs = (_dd_request(rng) if shape == "small"
              else _large_request(rng, 65536, 1_000_000))
    kw = dict(_bucket_of(graphs), sort_edges=sort_edges)
    G.from_graphs(graphs, device="cuda", **kw)  # the stage cached
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    spun = torch.cuda.Event()
    spun.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = G.from_graphs(graphs, device="cuda", **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not spun.query()  # enqueued while the card still spun
    torch.cuda.synchronize()
    assert oracle.mismatches(got, oracle.from_graphs(graphs, device="cuda",
                                                     **kw)) == []


def _sag_batch(device, seed=4):
    from tgp_tpu_torch.graph import from_graphs

    rng = np.random.default_rng(seed)
    graphs = []
    for n in (700, 300, 900):
        e = 8 * n
        graphs.append((rng.normal(size=(n, 24)).astype(np.float32),
                       np.stack([rng.integers(0, n, e),
                                 rng.integers(0, n, e)]),
                       rng.random(e).astype(np.float32) + 0.1))
    return from_graphs(graphs, sort_edges=True, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("shrink", [False, True])
def test_cuda_graph_conv_csr_branch_matches_plain(aggr, shrink):
    """SAG's GraphConv scorer on its CSR branch: ``A X`` in K1 on the card
    against the same layer on the CPU (K1's plain version), values and
    gradients, within 1e-5 of each tensor's largest |value| (f32 sums in
    other orders); one K1 launch forward (two with ``mean``: the degree),
    one backward."""
    from tgp_tpu_torch.mp.gcn import GraphConv

    _skip_without_card()
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = _sag_batch(dev)
        if shrink:  # a masked pooled graph: node mask below the edges
            nm = batch.node_mask & (torch.arange(batch.num_nodes,
                                                 device=dev) % 3 != 0)
            batch = batch.replace(node_mask=nm, in_degree=None,
                                  node_mask_shrunk=True)
        conv = GraphConv(24, 8, aggr=aggr, use_kernel=True, device=dev,
                         generator=torch.Generator().manual_seed(0))
        x = batch.x.clone().requires_grad_(True)
        before = K.spmm_csr.launches
        out = conv(batch, x)
        launched = K.spmm_csr.launches - before
        out.square().sum().backward()
        outs[dev] = (out.detach().cpu(), x.grad.cpu(),
                     conv.lin_1.weight.grad.cpu(), launched,
                     K.spmm_csr.launches - before)
    (o, gx, gw, fwd, total), (ro, rgx, rgw, _, _) = outs["cuda"], outs["cpu"]
    assert (fwd, total) == ((2, 3) if aggr == "mean" else (1, 2))
    for got, ref in ((o, ro), (gx, rgx), (gw, rgw)):
        _assert_rel(got, ref, 1e-5, float(ref.abs().max()))


@pytest.mark.cuda
def test_cuda_sag_forward_is_bit_equal_twice():
    """The SAG model's forward on the card (GCN on K1, the GraphConv
    scorer on K1, masked pooling, GCN, the readout on K4): every sum has a
    fixed order, so two runs give the same bits."""
    from tgp_tpu_torch.models.classifiers import PoolingClassifier
    from tgp_tpu_torch.poolers import get_pooler

    _skip_without_card()
    batch = _sag_batch("cuda", seed=5)
    g = torch.Generator().manual_seed(1)
    pooler = get_pooler("sag", in_channels=32, ratio=0.5, pool_mode="masked",
                        use_kernel=True, device="cuda", generator=g)
    model = PoolingClassifier(pooler, num_classes=3, hidden=32,
                              in_channels=24, use_kernel=True,
                              compute_dtype=torch.bfloat16, device="cuda",
                              generator=g)
    before = K.spmm_csr.launches
    with torch.no_grad():
        _twice_equal(lambda: model(batch)[0])
    assert K.spmm_csr.launches == before + 8


def _cluster_batch(device, seed=6, sizes=(700, 300, 900), deg=6):
    from tgp_tpu_torch.graph import from_graphs

    rng = np.random.default_rng(seed)
    graphs = []
    for n in sizes:
        e = deg * n
        graphs.append((rng.normal(size=(n, 24)).astype(np.float32),
                       np.stack([rng.integers(0, n, e),
                                 rng.integers(0, n, e)]),
                       rng.random(e).astype(np.float32) + 0.1))
    return from_graphs(graphs, sort_edges=True, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_cuda_matching_matches_cpu_on_the_same_ranks(impl, ties):
    """The greedy matching's rounds on the card (scatter-min rounds, or
    the dense per-graph loop) give the CPU's matching and round count on
    the same edge ranks, exactly."""
    from tgp_tpu_torch.select.edge_contraction import matching, rank_by

    _skip_without_card()
    out = {}
    for dev in ("cuda", "cpu"):
        batch = _cluster_batch(dev, sizes=(70, 30, 90))
        key = (torch.ones(batch.num_edges) if ties else torch.rand(
            batch.num_edges, generator=torch.Generator().manual_seed(2)))
        rank = rank_by(key.to(dev), batch.edge_mask)
        match, rounds = matching(rank, batch, impl)
        out[dev] = (rank.cpu(), match.cpu(), int(rounds))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("order_k", [1, 2])
def test_cuda_mis_matches_cpu_on_the_same_ranks(impl, order_k):
    """k-MIS and its clusters on the card against the CPU on the same
    node ranks, exactly (both engines)."""
    from tgp_tpu_torch.select import kmis as KM
    from tgp_tpu_torch.select.edge_contraction import rank_by

    _skip_without_card()
    out = {}
    for dev in ("cuda", "cpu"):
        batch = _cluster_batch(dev, sizes=(70, 30, 90))
        key = torch.rand(batch.num_nodes,
                         generator=torch.Generator().manual_seed(3))
        rank = rank_by(key.to(dev), batch.node_mask)
        if impl == "dense":
            mis, rounds = KM.maximal_independent_set_dense(rank, batch,
                                                           order_k)
            cl = KM.mis_cluster_dense(mis, rank, batch, order_k)
        else:
            args = (batch.senders, batch.receivers, batch.edge_mask,
                    batch.node_mask, order_k)
            mis, rounds = KM.maximal_independent_set(rank, *args)
            cl = KM.mis_cluster(mis, rank, *args)
        out[dev] = (mis.cpu(), cl.cpu(), int(rounds))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2] >= 1


@pytest.mark.cuda
def test_cuda_served_graclus_request_counts():
    """A Graclus model served by ``Predictor`` in the CSR regime (E ≥
    2¹⁸, sorted): K1 once (the pre-pool GCN); K4 three times (the cluster
    sums, the merge of duplicate edges, the readout); K2 twice (the
    post-pool GCN's degree and aggregation on the receiver-major merged
    edges, the sorted branch); no K3.  The clusters equal the CPU's, the
    logits lie within 2% of the CPU's logit scale, and a repeated request
    gives the same bits."""
    from tgp_tpu_torch.models.classifiers import PoolingClassifier
    from tgp_tpu_torch.models.inference import Predictor
    from tgp_tpu_torch.poolers import get_pooler

    _skip_without_card()
    rng = np.random.default_rng(8)
    n, e = 20_000, 300_000
    graph = (rng.normal(size=(n, 24)).astype(np.float32),
             np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = PoolingClassifier(
            get_pooler("graclus"), num_classes=3, hidden=32, in_channels=24,
            compute_dtype=torch.bfloat16, device=dev,
            generator=torch.Generator().manual_seed(0)).eval()
    pred = Predictor(lambda b: models["cuda"](b)[0], batch_size=1,
                     sort_edges=True, device="cuda")
    pred([graph])
    k1, k4 = K.spmm_csr.launches, K.sorted_segment_sum.launches
    k2, k3 = K.segment_sum_sorted.launches, BMM.bmm.launches
    logits = pred([graph])
    assert K.spmm_csr.launches == k1 + 1
    assert K.sorted_segment_sum.launches == k4 + 3
    assert K.segment_sum_sorted.launches == k2 + 2
    assert BMM.bmm.launches == k3
    assert np.array_equal(pred([graph]), logits)
    for conv in (*models["cpu"].pre_convs, *models["cpu"].post_convs):
        conv.use_kernel = True  # the sorted branches' plain versions
    cpu = Predictor(lambda b: models["cpu"](b)[0], batch_size=1,
                    sort_edges=True, device="cpu")
    ref = cpu([graph])
    np.testing.assert_allclose(logits, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())
    from tgp_tpu_torch.graph import from_graphs

    with torch.no_grad():
        so_gpu = models["cuda"](from_graphs([graph], sort_edges=True,
                                            device="cuda"))[1].so
        so_cpu = models["cpu"](from_graphs([graph], sort_edges=True,
                                           device="cpu"))[1].so
    assert torch.equal(so_gpu.cluster_index.cpu(), so_cpu.cluster_index)


# ---------------------------------------------------------------------------
# fixed-order sums: a repeat gives the same bits
# ---------------------------------------------------------------------------


def _twice(fn):
    """``fn()`` run twice on the card, each result copied to the CPU."""
    out = []
    for _ in range(2):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        out.append(tuple(t.detach().cpu() for t in got))
    return out


def _bit_equal(runs):
    a, b = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_cuda_coalesce_repeats_bit_equal(reduce):
    """The merge of many duplicate edges (200,000 over 300 nodes) sums
    each run by K4 in run order: two calls give the same bits, equal to
    the CPU's merge within f32 rounding, ascending by receiver."""
    from tgp_tpu_torch.ops.sparse import coalesce

    _skip_without_card()
    rng = np.random.default_rng(31)
    n, e = 300, 200_000
    args = [torch.tensor(rng.integers(0, n, e), dtype=torch.int32),
            torch.tensor(rng.integers(0, n, e), dtype=torch.int32),
            torch.tensor(rng.normal(size=e).astype(np.float32)),
            torch.tensor(rng.random(e) < 0.9)]
    kw = dict(reduce=reduce)
    gpu = [a.cuda() for a in args]
    before = K.sorted_segment_sum.launches
    runs = _twice(lambda: coalesce(*gpu, n, **kw))
    assert K.sorted_segment_sum.launches > before
    _bit_equal(runs)
    ref = coalesce(*args, n, **kw)
    for got, want in zip(runs[0], ref):
        if got.dtype == torch.float32:
            assert (got - want).abs().max() <= 1e-4
        else:
            assert torch.equal(got, want)
    assert (runs[0][1].diff() >= 0).all()


def _dup_graphs(seed, count=8, n=200, e=3000, feat=16):
    """Graphs whose edge lists repeat edges (summed by ``to_dense``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        s, r = np.concatenate([s, s[:e // 3]]), np.concatenate([r, r[:e // 3]])
        out.append((rng.normal(size=(n, feat)).astype(np.float32),
                    np.stack([s, r]),
                    rng.normal(size=s.shape[0]).astype(np.float32)))
    return out


@pytest.mark.cuda
def test_cuda_to_dense_repeats_bit_equal():
    """``to_dense`` on a batch with duplicate edges: features and mask by
    indexed writes, the duplicates summed by K4 in a fixed order; two
    calls give the same bits, the features and mask equal the CPU's and
    the adjacency matches within f32 rounding."""
    from tgp_tpu_torch.graph import from_graphs, to_dense

    _skip_without_card()
    graphs = _dup_graphs(32)
    gpu = from_graphs(graphs, device="cuda")
    before = K.sorted_segment_sum.launches
    runs = _twice(lambda: (lambda d: (d.x, d.adj, d.mask))(to_dense(gpu)))
    assert K.sorted_segment_sum.launches == before + 2
    _bit_equal(runs)
    ref = to_dense(from_graphs(graphs, device="cpu"))
    assert torch.equal(runs[0][0], ref.x) and torch.equal(runs[0][2],
                                                          ref.mask)
    assert (runs[0][1] - ref.adj).abs().max() <= 1e-4


@pytest.mark.cuda
def test_cuda_post_pool_gcn_on_merged_edges_is_bit_equal():
    """A Graclus pooled graph at the kernel regime's edge count: its
    merged edges ascend by receiver, so ``GCNConv`` takes the sorted
    branch (K2 twice: the degree and the aggregation), and two forwards
    give the same bits, within bf16 rounding of the CPU's."""
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.mp.gcn import GCNConv
    from tgp_tpu_torch.poolers import get_pooler

    _skip_without_card()
    rng = np.random.default_rng(33)
    n, e = 20_000, 300_000
    graph = (rng.normal(size=(n, 32)).astype(np.float32),
             np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = from_graphs([graph], sort_edges=True, device=dev)
        pooled = get_pooler("graclus", device=dev)(batch).graph
        assert pooled.edges_sorted and (pooled.receivers.diff() >= 0).all()
        conv = GCNConv(32, 32, dtype=torch.bfloat16, use_kernel=True,
                       device=dev, generator=torch.Generator().manual_seed(0))
        before = K.segment_sum_sorted.launches
        with torch.no_grad():
            outs[dev] = _twice(lambda: conv(pooled).float())
        if dev == "cuda":
            assert K.segment_sum_sorted.launches == before + 4
    _bit_equal(outs["cuda"])
    got, ref = outs["cuda"][0][0], outs["cpu"][0][0]
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.cuda
def test_cuda_kmis_and_edge_contraction_sums_are_bit_equal():
    """k-MIS's heuristic (the score-weighted one, whose sums are not
    integers) and edge contraction's per-receiver softmax add in a fixed
    order: two calls give the same bits, within f32 rounding of the
    CPU's."""
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.select.edge_contraction import EdgeContractionSelect
    from tgp_tpu_torch.select.kmis import KMISSelect

    _skip_without_card()
    rng = np.random.default_rng(34)
    n, e = 20_000, 300_000
    graph = (rng.normal(size=(n, 16)).astype(np.float32),
             np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = from_graphs([graph], sort_edges=True, device=dev)
        g = torch.Generator().manual_seed(0)
        kmis = KMISSelect(16, score_heuristic="w", order_k=2, device=dev,
                          generator=g)
        ec = EdgeContractionSelect(16, device=dev, generator=g)
        with torch.no_grad():
            score = kmis._score(batch)
            outs[dev] = _twice(lambda: (kmis._heuristic(score, batch),
                                        ec.edge_score(batch)))
    _bit_equal(outs["cuda"])
    for got, ref in zip(outs["cuda"][0], outs["cpu"][0]):
        assert (got - ref).abs().max() <= 1e-5 * max(ref.abs().max(), 1)


@pytest.mark.cuda
def test_cuda_bmm_splits_batches_above_the_grid_limit():
    """70,000 products (the grid's z dimension holds 65,535): two counted
    launches, each slice on its own route, equal to ``bmm_plain``."""
    _skip_without_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bmm_operands(70_000, 8, 16, 8, False, False, "bfloat16")
    before = BMM.bmm.launches
    got = BMM.bmm(a, b)
    torch.cuda.synchronize()
    assert BMM.bmm.launches == before + 2
    assert BMM.MAX_BATCH == 65_535 and got.shape == (70_000, 8, 8)
    _bmm_check(got, BMM.bmm_plain(a, b), BMM.bmm_plain(a.abs(), b.abs()))


def _grad_twice(fn, leaves):
    """``fn()`` (a scalar) and the gradients of ``leaves``, twice, each
    copied to the CPU."""
    out = []
    for _ in range(2):
        for t in leaves:
            t.grad = None
        loss = fn()
        loss.backward()
        out.append((loss.detach().cpu(),)
                   + tuple(t.grad.detach().cpu() for t in leaves))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gather_rows_gradient_repeats_bit_equal(dtype):
    """``gather_rows``' backward adds each row's cotangents by K4 in a
    fixed order, after a stable sort of the ids: two backward passes give
    the same bits (one K4 launch each), within f32 rounding of the CPU's
    ``index_select`` gradient."""
    from tgp_tpu_torch.ops.segment import gather_rows

    _skip_without_card()
    rng = np.random.default_rng(40)
    n, e = 5_000, 400_000  # ~80 gathers a row
    idx = torch.tensor(rng.integers(0, n, e))
    x0 = torch.tensor(rng.normal(size=(n, 16)).astype(np.float32)).to(
        getattr(torch, dtype))
    g = torch.tensor(rng.normal(size=(e, 16)).astype(np.float32))
    x = x0.cuda().requires_grad_(True)
    before = K.sorted_segment_sum.launches
    runs = _grad_twice(lambda: (gather_rows(x, idx.cuda(), n)
                                .float() * g.cuda()).sum(), [x])
    assert K.sorted_segment_sum.launches == before + 2
    _bit_equal(runs)
    xc = x0.clone().requires_grad_(True)
    (xc.index_select(0, idx).float() * g).sum().backward()
    tol = 1e-5 * float(g.abs().sum() / n) * 80
    if dtype == "bfloat16":
        tol += 2.0 ** -7 * float(xc.grad.float().abs().max())
    assert (runs[0][1].float() - xc.grad.float()).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_segment_sum_unsorted_repeats_bit_equal(dtype):
    """``segment_sum`` of floats on unsorted ids (a sort, then K4): two
    calls give the same bits, one K4 launch each, within f32 rounding of
    the CPU's; integer data keeps ``index_add_`` (no launch)."""
    from tgp_tpu_torch.ops.segment import segment_sum

    _skip_without_card()
    rng = np.random.default_rng(41)
    ids = torch.tensor(rng.integers(0, 3_000, 500_000)).cuda()
    data = torch.tensor(rng.normal(size=(500_000, 8)).astype(np.float32)
                        ).to(getattr(torch, dtype)).cuda()
    mask = torch.tensor(rng.random(500_000) < 0.9).cuda()
    before = K.sorted_segment_sum.launches
    runs = _twice(lambda: segment_sum(data, ids, 3_000, mask=mask))
    assert K.sorted_segment_sum.launches == before + 2
    _bit_equal(runs)
    ref = segment_sum(data.cpu(), ids.cpu(), 3_000, mask=mask.cpu())
    scale = segment_sum(data.abs().float().cpu(), ids.cpu(), 3_000)
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    err = (runs[0][0].float() - ref.float()).abs() - slack * ref.float().abs()
    assert (err <= 1e-5 * scale + 1e-6).all()
    ints = torch.tensor(rng.integers(0, 9, 500_000), dtype=torch.int32)
    segment_sum(ints.cuda(), ids, 3_000)
    assert K.sorted_segment_sum.launches == before + 2


@pytest.mark.cuda
def test_cuda_pan_scale_is_an_indexed_write():
    """PAN's dense MET path (``exact_met_support``): the per-node scale is
    an indexed write, so a forward and backward repeat bit for bit, within
    f32 rounding of the CPU's."""
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.mp.pan import PANConv

    _skip_without_card()
    graphs = _dup_graphs(42, count=6, n=60, e=400)
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = from_graphs(graphs, device=dev)
        conv = PANConv(16, 8, filter_size=2, exact_met_support=True,
                       device=dev, generator=torch.Generator().manual_seed(0))
        params = list(conv.parameters())

        def run():
            out, deg, met_w = conv(batch)
            return (out.square().sum() + deg.square().sum()
                    + met_w.square().sum())

        outs[dev] = (_grad_twice(run, params) if dev == "cuda"
                     else _grad_twice(run, params)[:1])
    _bit_equal(outs["cuda"])
    for got, ref in zip(outs["cuda"][0], outs["cpu"][0]):
        assert (got - ref).abs().max() <= 1e-4 * max(ref.abs().max(), 1)


def _maxcut_graph(seed, n=30_000, e=400_000, feat=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, feat)).astype(np.float32),
            np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))


@pytest.mark.cuda
@pytest.mark.parametrize("csr", [True, False], ids=["csr", "sorted_here"])
def test_cuda_maxcut_delta_gcn_runs_on_k1(csr):
    """MaxCut's sparse engine: each round's product is one K1 launch
    forward and one backward (12 and 12), no other launch of K1; scores
    and gradients repeat bit for bit and agree with the plain version on
    the CPU within f32 rounding."""
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.select.maxcut import MaxCutScoreNet

    _skip_without_card()
    graph = _maxcut_graph(43)
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = from_graphs([graph], sort_edges=csr, device=dev)
        net = MaxCutScoreNet(32, mp_impl="sparse", device=dev,
                             generator=torch.Generator().manual_seed(1))
        params = list(net.parameters())
        probe = torch.randn(batch.num_nodes, generator=torch.Generator()
                            .manual_seed(2)).to(dev)
        before = K.spmm_csr.launches
        runs = _grad_twice(lambda: (net(batch) * probe).sum(), params)
        if dev == "cuda":
            assert K.spmm_csr.launches == before + 2 * 24
            _bit_equal(runs)
        outs[dev] = runs[0]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        assert (got - ref).abs().max() <= 1e-4 * max(ref.abs().max(), 1)


@pytest.mark.cuda
def test_cuda_served_maxcut_forward_is_bit_equal_twice():
    """A served MaxCut model (bf16 GCN, f32 score net on K1) on a request
    at the kernel regime: two forwards give the same logits and clusters
    bit for bit; every valid node is assigned."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler
    from tgp_tpu_torch.graph import from_graphs

    _skip_without_card()
    x, ei = _maxcut_graph(44, feat=64)
    batch = from_graphs([(x, ei)], sort_edges=True, device="cuda")
    g = torch.Generator().manual_seed(3)
    model = PoolingClassifier(get_pooler("maxcut", in_channels=64,
                                         device="cuda", generator=g),
                              num_classes=3, hidden=64, in_channels=64,
                              compute_dtype=torch.bfloat16, device="cuda",
                              generator=g).eval()
    with torch.inference_mode():
        runs = _twice(lambda: (lambda lo, o: (lo.float(), o.so.cluster_index))(
            *model(batch)))
        _, out = model(batch)
    _bit_equal(runs)
    assert bool(out.so.node_sel_mask[batch.node_mask].all())


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "u"])
def test_cuda_bnpool_on_replayed_draws_gives_the_cpus_loss(batched):
    """BNPool's Gamma draws (and ``_u``'s negatives) made on the card and
    replayed on the CPU: the same three losses within 1e-4, and a second
    forward from the same generator state repeats the card's bits."""
    from tgp_tpu_torch import get_pooler, prepare_batch
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.poolers import bnpool
    from tgp_tpu_torch.select import dp

    _skip_without_card()
    graphs = _dup_graphs(45, count=8, n=120, e=600)
    real_gamma, real_neg = dp.draw_gamma, bnpool.negative_edge_sampling
    rec = []

    def gamma(alpha, gen):
        rec.append(real_gamma(alpha, gen))
        return rec[-1]

    def neg(batch, gen, **kw):
        rec.append(real_neg(batch, gen, **kw))
        return rec[-1]

    losses = {}
    try:
        for dev in ("cuda", "cpu"):
            b = from_graphs(graphs, device=dev)
            b = prepare_batch(b, densify=True) if batched else b
            gen = torch.Generator(device=dev).manual_seed(7)
            pool = get_pooler("bnpool", in_channels=16, k=6, batched=batched,
                              device=dev, sample_generator=gen,
                              generator=torch.Generator().manual_seed(0))
            if dev == "cuda":
                dp.draw_gamma, bnpool.negative_edge_sampling = gamma, neg
                state = gen.get_state()
                runs = []
                for _ in range(2):
                    gen.set_state(state)
                    with torch.no_grad():
                        out = pool(b)
                    runs.append(tuple(out.loss[k].cpu() for k in
                                      sorted(out.loss)))
                _bit_equal(runs)
                replay = [tuple(t.cpu() for t in r) if isinstance(r, tuple)
                          else r.cpu() for r in rec[:len(rec) // 2]]
            else:
                dp.draw_gamma = lambda alpha, g: replay.pop(0)
                bnpool.negative_edge_sampling = lambda bb, g, **kw: \
                    replay.pop(0)
                with torch.no_grad():
                    out = pool(b)
                assert not replay
            losses[dev] = {k: float(v) for k, v in out.loss.items()}
    finally:
        dp.draw_gamma, bnpool.negative_edge_sampling = real_gamma, real_neg
    for k, ref in losses["cpu"].items():
        assert abs(losses["cuda"][k] - ref) <= 1e-4 * max(abs(ref), 1), k


#: the aggregations of ``reduce/aggr.py`` held on the card: every learnable
#: one, and the stateless softmax, mul and median
_CARD_AGGRS = ("attentional", "deep_sets", "equilibrium",
               "graph_multiset_transformer", "gru", "lcm", "lstm", "mlp",
               "patch_transformer", "set2set", "set_transformer", "sort",
               "softmax", "mul", "median")


def _aggr_pair(alias, shift):
    """``AggrReduce(alias)`` built on the CPU (its weights shifted by
    ``shift``, so no bias is 0) and a copy on the card; 3,000 rows of 32
    in 40 segments, the last one empty, 10% masked."""
    from tgp_tpu_torch.reduce.aggr import AggrReduce

    kw = {"max_len": 128} if alias in ("mlp", "patch_transformer") else {}
    cpu = AggrReduce(alias, in_channels=32, device="cpu",
                     generator=torch.Generator().manual_seed(0), **kw)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(shift)
    card = AggrReduce(alias, in_channels=32, device="cuda", **kw)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(50)
    x = torch.tensor(rng.normal(size=(3000, 32)).astype(np.float32))
    seg = torch.tensor(rng.integers(0, 39, 3000))
    mask = torch.tensor(rng.random(3000) > 0.1)
    return cpu, card, (x, seg, mask)


def _aggr_run(mod, x, seg, mask, device):
    """A forward and backward against a fixed cotangent: the output, the
    input's gradient and each parameter's (on the CPU)."""
    x = x.to(device).requires_grad_(True)
    mod.zero_grad(set_to_none=True)
    out = mod(x, node_graph=seg.to(device), num_graphs=40,
              node_mask=mask.to(device))
    R = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    (out * R.to(device)).sum().backward()
    return {"out": out.detach().cpu(), "x": x.grad.cpu(),
            **{k: p.grad.cpu() for k, p in mod.named_parameters()}}


@pytest.mark.cuda
@pytest.mark.parametrize("alias", _CARD_AGGRS)
def test_cuda_aggr_matches_cpu_and_repeats_bit_equal(alias):
    """On the card: a forward and backward twice give the same bits
    (output, input and parameter gradients), the output within 1e-4 of
    its largest |value| of the CPU's (1e-3 for the cuDNN recurrent nets),
    each gradient within 5e-2 of its largest |value| (the smoke's
    bounds; a leaf whose gradient is 0 in exact arithmetic, such as an
    attention block's key bias, within 5e-2 of its weight's)."""
    _skip_without_card()
    cpu, card, data = _aggr_pair(alias, 0.05)
    first = _aggr_run(card, *data, "cuda")
    second = _aggr_run(card, *data, "cuda")
    assert all(torch.equal(first[k], second[k]) for k in first)
    ref = _aggr_run(cpu, *data, "cpu")
    tol = 1e-3 if alias in ("lstm", "gru", "set2set") else 1e-4
    assert (first["out"] - ref["out"]).abs().max() <= \
        tol * ref["out"].abs().max()
    for k, got in first.items():
        if k == "out":
            continue
        assert torch.isfinite(got).all()
        zero = k.endswith(".key.bias") or (alias, k) == (
            "attentional", "aggr.dense_0.bias")  # the gate's bias
        scale = ref[k.replace("bias", "weight") if zero else k].abs().max()
        assert (got - ref[k]).abs().max() <= 5e-2 * scale + 1e-30, k


@pytest.mark.cuda
@pytest.mark.parametrize("alias", ["lstm", "gru"])
def test_cuda_recurrent_aggr_reads_step_zero_of_an_empty_segment(alias):
    """Every weight shifted by 0.3: the empty segment's output is the
    net's step 0 on a zero input, as on the CPU (and as JAX reads it),
    not 0."""
    _skip_without_card()
    cpu, card, data = _aggr_pair(alias, 0.3)
    got = _aggr_run(card, *data, "cuda")["out"][39]
    ref = _aggr_run(cpu, *data, "cpu")["out"][39]
    assert ref.abs().max() > 1e-2
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("alias", ["lstm", "gru"])
def test_cuda_recurrent_aggr_runs_a_segment_past_cudnns_limit(alias):
    """One segment of 70,000 rows (cuDNN refuses 65,536 steps of batch 1):
    the readout runs in ``RNN_CHUNK`` chunks, the state carried over, and
    agrees with the CPU's within 1e-3 of its largest |value|."""
    from tgp_tpu_torch.reduce.aggr import RNN_CHUNK, AggrReduce

    _skip_without_card()
    n = 70_000
    assert n > 4 * RNN_CHUNK
    cpu = AggrReduce(alias, in_channels=16, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    card = AggrReduce(alias, in_channels=16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(1))
    args = dict(node_graph=torch.zeros(n, dtype=torch.long), num_graphs=1)
    with torch.no_grad():
        ref = cpu(x, **args)
        got = card(x.cuda(), **{k: v.cuda() if torch.is_tensor(v) else v
                                for k, v in args.items()}).cpu()
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


# ---------------------------------------------------------------------------
# the precoarsening pipeline: K4 at the precoarsened paths' shapes
# ---------------------------------------------------------------------------

_PRE_SCHEDULES = {"graclus": dict(poolers="graclus", levels=2),
                  "mixed": dict(poolers=[("ndp", {}), ("graclus", {})]),
                  "sep": dict(poolers="sep", levels=2),
                  "nmf": dict(poolers=("nmf", {"k": 8}), levels=2),
                  "eigen": dict(poolers=[("eigen", {"k": 12}),
                                         ("eigen", {"k": 4})])}


def _pre_graphs(count=16, seed=0, F=8):
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(30, 60, count):
        up = np.triu(rng.random((n, n)) < 0.12, 1)
        s, r = np.nonzero(up | up.T)
        out.append((rng.normal(size=(n, F)).astype(np.float32),
                    np.stack([s, r]).astype(np.int64)))
    return out, (np.arange(count) % 3).astype(np.int32)


def _pre_step(model, batch, lbs, y):
    model.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(model(batch, lbs), y)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(_PRE_SCHEDULES))
def test_cuda_precoarsened_step_matches_cpu_and_repeats_bit_equal(schedule):
    """``PrecoarsenedNet`` (hidden 32) on a precoarsened batch: step one's
    loss and gradients twice on the card give the same bits, agree with
    the CPU's (loss within 1e-4 relative, each leaf within 1e-3 of its
    largest |value|), and every sum ran on K4 (no other kernel)."""
    from examples.pre_coarsening_torch import PrecoarsenedNet, level_modes
    from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
    from tgp_tpu_torch.precoarsen import PreCoarsening

    _skip_without_card()
    graphs, labels = _pre_graphs()
    tf = PreCoarsening(**_PRE_SCHEDULES[schedule])
    pooled = [tf(g) for g in graphs]
    nets = {}
    for dev in ("cpu", "cuda"):
        nets[dev] = PrecoarsenedNet(8, 3, hidden=32,
                                    level_modes=level_modes(pooled[0]),
                                    device=dev)
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    runs = {}
    for dev in ("cpu", "cuda"):
        b, lbs, y = next(iter(PooledGraphLoader(pooled, labels,
                                                batch_size=16, device=dev)))
        y = torch.as_tensor(y, device=dev).long()
        before = K.sorted_segment_sum.launches
        runs[dev] = _pre_step(nets[dev], b, lbs, y)
        if dev == "cuda":
            assert K.sorted_segment_sum.launches > before
            again = _pre_step(nets[dev], b, lbs, y)
            assert torch.equal(again[0], runs[dev][0])
            assert all(torch.equal(again[1][k], g)
                       for k, g in runs[dev][1].items())
    (l_c, g_c), (l_g, g_g) = runs["cpu"], runs["cuda"]
    assert abs(float(l_g) - float(l_c)) <= 1e-4 * abs(float(l_c))
    for k, g in g_c.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((g_g[k].cpu() - g).abs().max()) <= 1e-3 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("alias,kw", [("ndp", {}), ("nmf", {"k": 8}),
                                      ("sep", {}), ("eigen", {"k": 8})])
def test_cuda_host_pooler_matches_cpu(alias, kw):
    """A host-side pooler on a batch on the card: the selection and the
    pooled graph equal the CPU call's, the pooled features within 1e-5 of
    their largest |value|, a repeat bit-equal."""
    from tgp_tpu_torch import from_graphs, get_pooler

    _skip_without_card()
    graphs, _ = _pre_graphs(count=6, seed=1)
    pooler = get_pooler(alias, **kw)
    out = {dev: pooler(from_graphs(graphs, device=dev)) for dev in
           ("cpu", "cuda")}
    again = pooler(from_graphs(graphs, device="cuda"))
    assert torch.equal(again.graph.x, out["cuda"].graph.x)
    for f in ("senders", "receivers", "edge_weight", "node_mask"):
        assert torch.equal(getattr(out["cuda"].graph, f).cpu(),
                           getattr(out["cpu"].graph, f))
    ref = out["cpu"].graph.x
    assert float((out["cuda"].graph.x.cpu() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_k4_reduces_a_precoarsened_level_bit_equal():
    """The cluster sums of a Graclus level of a 20,000-node graph (128
    f32 wide) on K4 (one launch a call) against the plain version (1e-5
    of Σ|terms|), the same bits twice."""
    from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
    from tgp_tpu_torch.precoarsen import PreCoarsening
    from tgp_tpu_torch.reduce.base import reduce_sparse

    _skip_without_card()
    rng = np.random.default_rng(5)
    n, e = 20_000, 200_000
    g = (rng.normal(size=(n, 128)).astype(np.float32),
         rng.integers(0, n, (2, e)))
    pooled = PreCoarsening("graclus", levels=1)(g)
    b, lbs = next(iter(PooledGraphLoader([pooled], batch_size=1,
                                         device="cpu")))
    ref = reduce_sparse(b.x, lbs[0].so)
    scale = reduce_sparse(b.x.abs(), lbs[0].so)
    card = lbs[0].to("cuda").so
    before = K.sorted_segment_sum.launches
    got = reduce_sparse(b.x.cuda(), card)
    assert K.sorted_segment_sum.launches == before + 1
    assert torch.equal(reduce_sparse(b.x.cuda(), card), got)
    assert ((got.cpu() - ref).abs() <= 1e-5 * scale + 1e-30).all()


def _gtv_batch(device, sort_edges=True):
    """Three random graphs (50–90 nodes, weighted, no self-loops: a loop's
    |h_i − h_i|₁ = 0 makes γ = w/eps, whose terms cancel in the output
    only up to rounding of that size), collated with the CSR layout."""
    from tgp_tpu_torch.graph import from_graphs

    rng = np.random.default_rng(71)
    graphs = []
    for n in (50, 90, 70):
        e = 6 * n
        ei = rng.integers(0, n, (2, e))
        ei[1] = np.where(ei[0] == ei[1], (ei[1] + 1) % n, ei[1])
        graphs.append((rng.normal(size=(n, 8)).astype(np.float32), ei,
                       (rng.random(e) + 0.5).astype(np.float32)))
    return from_graphs(graphs, pad_nodes=256, pad_edges=1536,
                       sort_edges=sort_edges, device=device)


def _gtv_run(conv, batch):
    """Output and gradients (x, weight, bias) of a fixed cotangent."""
    x = batch.x.clone().requires_grad_(True)
    conv.zero_grad(set_to_none=True)
    out = conv(batch, x)
    cot = torch.linspace(-1, 1, out.numel(), device=out.device).view(
        out.shape)
    (out * cot).sum().backward()
    return [t.detach() for t in (out, x.grad, conv.weight.grad,
                                 conv.bias.grad)]


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.311, 1.0])
def test_cuda_gtvconv_csr_route_matches_generic_and_repeats(delta,
                                                             monkeypatch):
    """GTVConv on the card: the CSR route (K1 over the transpose layout,
    forced by the regime map) against the generic route on the same batch
    and weights (output within 1e-5 of its largest |value|, gradients
    within 1e-4), K1 twice forward and once backward, two runs of the
    CSR route equal bit for bit, and the CPU's generic route beside it."""
    from tgp_tpu_torch.mp import gtvconv as G
    from tgp_tpu_torch.ops import sparse as S

    _skip_without_card()
    batch = _gtv_batch("cuda")
    conv = G.GTVConv(8, 16, delta_coeff=delta, device="cuda",
                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        conv.bias.fill_(0.1)
    runs = {}
    for route in (True, False):
        monkeypatch.setattr(S, "use_kernel_spmm", lambda *a: route)
        before = K.spmm_csr.launches
        runs[route] = _gtv_run(conv, batch)
        assert K.spmm_csr.launches - before == (3 if route else 0)
    monkeypatch.setattr(S, "use_kernel_spmm", lambda *a: True)
    again = _gtv_run(conv, batch)
    assert all(torch.equal(a, b) for a, b in zip(runs[True], again))
    cpu = G.GTVConv(8, 16, delta_coeff=delta, device="cpu")
    cpu.load_state_dict(conv.state_dict())
    monkeypatch.setattr(S, "use_kernel_spmm", lambda *a: False)
    ref = _gtv_run(cpu, batch.to("cpu"))
    for i, (csr, gen, c) in enumerate(zip(runs[True], runs[False], ref)):
        tol = 1e-5 if i == 0 else 1e-4
        scale = max(float(c.abs().max()), 1e-30)
        assert float((csr - gen).abs().max()) <= tol * scale, i
        assert float((csr.cpu() - c).abs().max()) <= tol * scale, i


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gcn_mincut", "gtv_acc", "gtv_acc_u",
                                   "node_topk", "node_mincut"])
def test_cuda_cluster_models_step_matches_cpu_and_repeats(which):
    """``ClusteringModel`` and ``PoolLiftNodeClassifier`` on the card:
    step one's loss and gradients twice give the same bits and agree with
    the CPU's (the loss within 1e-4 of the sum of its terms' |values| —
    MinCut's cut and orthogonality terms nearly cancel —, each leaf within
    1e-3 of its largest |value|)."""
    from tgp_tpu_torch.models.autoencoder import PoolLiftNodeClassifier
    from tgp_tpu_torch.models.clustering import ClusteringModel
    from tgp_tpu_torch.poolers import get_pooler

    _skip_without_card()
    kind, alias = which.split("_", 1)
    models, runs = {}, {}
    for dev in ("cpu", "cuda"):
        g = torch.Generator().manual_seed(5)
        pooler = get_pooler(alias, in_channels=16, k=4, ratio=0.5,
                            device=dev, generator=g)
        if kind == "node":
            models[dev] = PoolLiftNodeClassifier(pooler, 3, hidden=16,
                                                 in_channels=8, device=dev,
                                                 generator=g)
        else:
            models[dev] = ClusteringModel(pooler, hidden=16, mp_type=kind,
                                          in_channels=8, device=dev,
                                          generator=g)
    models["cuda"].load_state_dict(models["cpu"].state_dict())

    def step(model, batch):
        model.zero_grad(set_to_none=True)
        head, out = model(batch)
        terms = list(out.loss.values())
        if kind == "node":
            y = torch.arange(head.shape[0], device=head.device) % 3
            terms.append(torch.nn.functional.cross_entropy(head, y))
        loss = sum(terms)
        loss.backward()
        step.scale = sum(abs(float(v.detach())) for v in terms)
        return loss.detach(), {k: v.grad.detach().clone()
                               for k, v in model.named_parameters()}

    for dev in ("cpu", "cuda"):
        batch = _gtv_batch(dev, sort_edges=False)
        runs[dev] = step(models[dev], batch)
        if dev == "cuda":
            again = step(models[dev], batch)
            assert torch.equal(again[0], runs[dev][0])
            assert all(torch.equal(again[1][k], g)
                       for k, g in runs[dev][1].items())
    (l_c, g_c), (l_g, g_g) = runs["cpu"], runs["cuda"]
    assert abs(float(l_g) - float(l_c)) <= 1e-4 * step.scale
    for k, g in g_c.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((g_g[k].cpu() - g).abs().max()) <= 1e-3 * scale, k


def _sharded_case(seed, n=300, e=2500, F=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.normal(size=e).astype(np.float32),
            rng.normal(size=(n, F)).astype(np.float32), n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sharded_spmm_runs_k1_and_matches_its_plain_route(dtype):
    """``parallel.spmm`` on a 1-rank NCCL world: the rank's sum on K1 (one
    launch forward, one for the gradient of ``x``) against the same call on
    CPU tensors (K1's plain version) — within 1e-5 of the output's largest
    |value| in f32, 1e-2 in bf16 — and a repeat equal bit for bit."""
    from tgp_tpu_torch.parallel import spmm as PS
    from tgp_tpu_torch.parallel.launch import single_rank_world
    from tgp_tpu_torch.parallel.train import make_mesh

    _skip_without_card()
    s, r, w, x, n = _sharded_case(5)
    dt = getattr(torch, dtype)
    with single_rank_world("nccl"):
        mesh = make_mesh(1, axis="gp")
        assert mesh.device_type == "cuda"
        runs = {}
        for dev in ("cuda", "cpu"):
            S, R, W, n_pad, rows_per = PS.partition_edges(s, r, w, n, 1,
                                                          device=dev)
            xs = torch.tensor(x, device=dev).to(dt).requires_grad_()
            layout = PS.CsrLayout(S[0], R[0], rows_per, n_pad)
            before = K.spmm_csr.launches
            out = layout.spmm(xs, W[0])
            out.float().sum().backward()
            runs[dev] = (out.detach(), xs.grad)
            if dev == "cuda":
                assert K.spmm_csr.launches - before == 2
                fn = PS.make_sharded_spmm(mesh, rows_per)
                again = fn(xs.detach(), S[0], R[0], W[0])
                assert torch.equal(again, fn(xs.detach(), S[0], R[0], W[0]))
                assert torch.equal(again, out.detach())
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        scale = max(float(ref.float().abs().max()), 1e-30)
        assert float((got.cpu().float() - ref.float()).abs().max()) \
            <= tol * scale


@pytest.mark.cuda
def test_cuda_ring_at_one_rank_is_the_identity():
    """At D = 1 the ring has one step, sends nothing (NCCL does not send
    to its own rank) and equals the gather variant bit for bit."""
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel import spmm as PS
    from tgp_tpu_torch.parallel.launch import single_rank_world
    from tgp_tpu_torch.parallel.train import make_mesh

    _skip_without_card()
    s, r, w, x, n = _sharded_case(6)
    with single_rank_world("nccl"):
        mesh = make_mesh(1, axis="gp")
        S, R, W, n_pad, rows_per = PS.partition_edges_2d(s, r, w, n, 1,
                                                         device="cuda")
        xs = torch.tensor(x, device="cuda")
        C.COMM_LOG.clear()
        ring = PS.make_ring_halo_spmm(mesh, rows_per, 1)(xs, S[0], R[0],
                                                         W[0])
        assert not [e for e in C.COMM_LOG if e[0] == "ppermute"]
        S1, R1, W1, _, _ = PS.partition_edges(s, r, w, n, 1, device="cuda")
        gather = PS.make_sharded_spmm(mesh, rows_per)(xs, S1[0], R1[0],
                                                      W1[0])
        assert torch.equal(ring, gather)
        C.COMM_LOG.clear()
        assert torch.equal(C.ppermute(xs, mesh.get_group("gp")), xs)
        assert not C.COMM_LOG


@pytest.mark.cuda
@pytest.mark.parametrize("F", [16, 17])
@pytest.mark.parametrize("n_pad,hub", [(N_PAD_EDGES, 0), (3000, 700)])
def test_cuda_k1_at_the_dense_family_widths(F, n_pad, hub):
    """K1 in f32 at the dense family's widths (``K = 16`` messages of
    ``SᵀAS``, ``K + 1 = 17`` of HOSC's ``[S | 1]`` chain, rows of 68
    bytes): forward and the gradient for ``h`` over the transpose layout
    against the plain version (1e-5 of each row's Σ|w·x|), each run twice
    and bit-equal."""
    _skip_without_card()
    c = _csr_case(F + 40, F, e=900 + hub, n_pad=n_pad, hub=hub)
    layout = _layout(c, lambda a: torch.tensor(a, device="cuda"))
    w, s, rp = layout[0], layout[2], layout[4]
    x = torch.tensor(c["x"], device="cuda")
    got = _twice_equal(lambda: K.spmm_csr(x, *layout, c["n"]))
    ref = K.spmm_csr_plain(x, w, s, rp, c["n"])
    _assert_rel(got.cpu(), ref.cpu(), 1e-5, _row_scale(c, F))
    g = torch.tensor(np.random.default_rng(F).normal(
        size=(c["n"], F)).astype(np.float32), device="cuda")

    def grad():
        xs = x.clone().requires_grad_()
        (K.spmm_csr(xs, *layout, c["n"]) * g).sum().backward()
        return xs.grad

    d_x = _twice_equal(grad)
    w_t, r_t, rp_t = layout[1], layout[5], layout[7]
    ref_t = K.spmm_csr_plain(g, w_t, r_t, rp_t, c["n"])
    scale_t = np.zeros((c["n"], F))
    np.add.at(scale_t, c["s_t"], np.abs(c["w_t"])[:, None]
              * np.abs(g.cpu().numpy()[c["r_t"]]))
    _assert_rel(d_x.cpu(), ref_t.cpu(), 1e-5, scale_t)


@pytest.mark.cuda
def test_cuda_keyed_draws_match_the_cpus():
    """The per-node draws of ``DPSelect(per_node_keys=True)`` on the card:
    Philox's words bit-equal to the CPU's, the Gamma draws within 1e-6
    relative (float64 ``log``/``sqrt``/``cos`` of two libraries), and the
    selector's ``s`` on the card against the CPU's."""
    from tgp_tpu_torch.select import dp

    _skip_without_card()
    n, width = 4096, 15
    rng = np.random.default_rng(0)
    graph = rng.integers(0, 4, n)
    col = np.tile(np.arange(width), n)
    words = {dev: dp.keyed_words(
        123456789012345, torch.tensor(np.repeat(graph, width), device=dev),
        torch.tensor(np.repeat(np.arange(n), width), device=dev),
        torch.tensor(col, device=dev), 1, 2) for dev in ("cuda", "cpu")}
    for a, b in zip(words["cuda"], words["cpu"]):
        assert torch.equal(a.cpu(), b)
    alpha = rng.uniform(1e-3, 8.0, (n, width)).astype(np.float32)
    draws = {dev: dp.draw_gamma_keyed(
        torch.tensor(alpha, device=dev), 99,
        torch.tensor(graph, device=dev), torch.arange(n, device=dev), 0)
        for dev in ("cuda", "cpu")}
    got, ref = draws["cuda"].cpu(), draws["cpu"]
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-6 * ref.abs() + 1e-30).all()


def _sharded_pool_runs(run):
    """``run(device)`` on a 1-rank NCCL world on the card and on a 1-rank
    gloo world on the CPU (the kernels' plain versions), in turn."""
    from tgp_tpu_torch.parallel.launch import single_rank_world

    out = {}
    for dev, backend in (("cuda", "nccl"), ("cpu", "gloo")):
        with single_rank_world(backend):
            out[dev] = run(dev)
    return out


def _dense_pool_case(alias, dev, **kw):
    from tgp_tpu_torch.parallel import dense_pool as DP
    from tgp_tpu_torch.parallel.train import make_mesh
    from tgp_tpu_torch.poolers import get_pooler

    rng = np.random.default_rng(3)
    n, e = 3000, 40_000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    mesh = make_mesh(1, axis="n")
    pooler = get_pooler(alias, in_channels=32, k=16, batched=False,
                        device=dev, generator=torch.Generator().manual_seed(1),
                        **kw)
    prep = DP.prepare_sharded_dense_graph(x, s, r, w, n, 1, device=dev)
    args = DP.device_put_sharded_dense(mesh, *prep[:5], axis="n")
    step = DP.make_sharded_dense_pool_step(pooler, mesh, prep[6], axis="n")
    if alias == "bnpool":
        NS, NR, NM, _ = DP.prepare_sharded_negatives(2, s, r, n, 1,
                                                     device=dev)
        return pooler, (lambda: step(7, *args, NS[0], NR[0], NM[0]))
    return pooler, (lambda: step(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("alias,kw", [("mincut", {}), ("hosc", {}),
                                      ("bnpool", {"per_node_keys": True})])
def test_cuda_sharded_dense_pool_matches_its_plain_route(alias, kw):
    """``parallel.dense_pool`` at K = 16 on a 1-rank NCCL world: K1 (the
    ``SᵀAS`` messages; HOSC's three ``[S | 1]`` sums at F = 17) and K4
    (the degrees) launch, the pooled values and losses and the gradient
    of the summed losses equal the same step on the CPU (within 1e-4 of
    each output's and leaf's largest |value|), and a repeat is bit-equal."""
    from tgp_tpu_torch.parallel import _collectives as C

    _skip_without_card()

    def run(dev):
        pooler, step = _dense_pool_case(alias, dev, **kw)
        counts = (K.spmm_csr.launches, K.sorted_segment_sum.launches)
        x_pool, adj, losses = step()
        if dev == "cuda":
            assert K.spmm_csr.launches > counts[0]
            assert K.sorted_segment_sum.launches > counts[1]
            again = step()
            assert torch.equal(again[0], x_pool)
            assert torch.equal(again[1], adj)
        C.backward_replicated(sum(losses.values()), 1)
        grads = {k: v.grad.cpu() for k, v in pooler.named_parameters()
                 if v.grad is not None}
        return ([x_pool.detach().cpu(), adj.detach().cpu()]
                + [v.detach().cpu().reshape(1) for v in losses.values()],
                grads)

    out = _sharded_pool_runs(run)
    for got, ref in zip(out["cuda"][0], out["cpu"][0]):
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((got - ref).abs().max()) <= 1e-4 * scale
    assert set(out["cuda"][1]) == set(out["cpu"][1])
    for k, ref in out["cpu"][1].items():
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((out["cuda"][1][k] - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("alias", ["topk", "sag"])
def test_cuda_sharded_topk_model_matches_its_plain_route(alias):
    """``parallel.sparse_pool`` on a 1-rank NCCL world above the kernel
    regime (E ≥ 2¹⁸): K1 (the GCN layer, SAG's scorer, the coarse conv)
    and K4 launch, the logits equal the same forward on the CPU (1e-4 of
    their largest |value|) and a repeat is bit-equal."""
    from tgp_tpu_torch.parallel import dense_pool as DP
    from tgp_tpu_torch.parallel import sparse_pool as SP
    from tgp_tpu_torch.parallel.train import make_mesh
    from tgp_tpu_torch.poolers import get_pooler

    _skip_without_card()
    rng = np.random.default_rng(4)
    n, e = 20_000, 300_000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    w = np.ones(e, np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)

    def run(dev):
        mesh = make_mesh(1, axis="n")
        pooler = get_pooler(alias, in_channels=32, ratio=0.5, device=dev,
                            generator=torch.Generator().manual_seed(1))
        model = SP.TopkPoolModel(pooler, hidden=32, in_channels=16,
                                 device=dev,
                                 generator=torch.Generator().manual_seed(2))
        prep = DP.prepare_sharded_dense_graph(x, s, r, w, n, 1, device=dev)
        args = DP.device_put_sharded_dense(mesh, *prep[:5], axis="n")
        fwd = SP.make_sharded_topk_model_forward(model, mesh,
                                                 rows_per=prep[6],
                                                 max_nodes=n)
        with torch.no_grad():
            counts = (K.spmm_csr.launches, K.sorted_segment_sum.launches)
            logits = fwd(*args)
            if dev == "cuda":
                assert K.spmm_csr.launches - counts[0] == (3 if alias == "sag"
                                                           else 2)
                assert K.sorted_segment_sum.launches > counts[1]
                assert torch.equal(fwd(*args), logits)
        return logits.cpu()

    out = _sharded_pool_runs(run)
    scale = max(float(out["cpu"].abs().max()), 1e-30)
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4 * scale


def _served_topk_model(alias="topk", **pooler):
    """The served configuration's model: GCN (bf16) → top-k → GCN → mean
    readout → head, hidden 128 (``pooler``: more of the pooler's
    arguments)."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    torch.manual_seed(3)
    return PoolingClassifier(
        get_pooler(alias, in_channels=128, ratio=0.5, device="cuda",
                   **pooler),
        num_classes=2, hidden=128, in_channels=128, readout="mean",
        compute_dtype=torch.bfloat16, device="cuda").eval()


def _replay_buckets(route):
    """Four batches of different graphs a bucket, collated on the card:
    one K1 bucket (a graph of 16,384 nodes and 300,000–303,000 edges a
    request, ``sort_edges``: the masked CSR route), or two buckets of
    ``serve-small-graphs`` (eight D&D-sized graphs a request: the compact
    generic route)."""
    from tgp_tpu_torch import from_graphs

    rng = np.random.default_rng(26)
    if route == "csr":
        groups = [[_large_request(rng, 16384, 300_000 + 1000 * i)
                   for i in range(4)]]
    else:
        by = {}
        while sum(len(g) >= 4 for g in by.values()) < 2:
            r = _dd_request(rng)
            by.setdefault(tuple(_bucket_of(r).values()), []).append(r)
        groups = [g[:4] for g in by.values() if len(g) >= 4][:2]
    return [[from_graphs(r, sort_edges=route == "csr", device="cuda",
                         **_bucket_of(r)) for r in g] for g in groups]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


#: K1's and K4's kernels as the device trace names them: the CSR kernels
#: of ``segment_spmm.cu`` (K1, K2 and K4's ``"wide"`` route) and
#: ``segment_reduce.cu``'s (K4's ``"long"`` route)
_K1_K4_KERNELS = ("csr_wide_kernel<", "csr_narrow_kernel<",
                  "segment_reduce_kernel<")


def _traced_kernels(prof, path) -> dict:
    """K1's and K4's kernel records in a finished profile, by name and
    count, read from its exported trace as ``portbench`` reads it."""
    import json

    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel" and any(k in e.get("name", "")
                                            for k in _K1_K4_KERNELS):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


MIN_SCORE = 0.1  # top-k's threshold mode: a score bound in place of k


@pytest.mark.cuda
@pytest.mark.parametrize("min_score", [None, MIN_SCORE])
@pytest.mark.parametrize("route", ["csr", "generic"])
def test_cuda_served_forward_replays_the_eager_bits(route, min_score,
                                                    tmp_path):
    """The served model's forward on the card, each bucket's four requests
    in turn (the buckets interleaved), then each bucket's first again: the
    calls run eager, capture, replay, replay, replay; every call's logits
    and selection equal the eager forward's on its own batch bit for bit
    (two requests of one bucket differ, so a stale answer fails); what a
    call returned is unchanged after the later calls; the device trace of
    every call holds the eager forward's K1 and K4 kernels, by name and
    count (K1 3 on the CSR route), while a replay's span counts no
    wrapper launch; and the calls but the capture run under
    ``set_sync_debug_mode("error")``, the replays returning behind ~0.5 s
    of spinning that they enqueue before.  With top-k's ``min_score``
    too."""
    from tgp_tpu_torch import tracing

    _skip_without_card()
    buckets = _replay_buckets(route)
    model = _served_topk_model(min_score=min_score)
    with torch.inference_mode():
        want = [[model._forward(b) for b in batches] for batches in buckets]
    assert len(model._graphs) == 0
    for w in want:  # two requests of a bucket give their own answers
        assert not torch.equal(w[2][0], w[3][0])
        assert not torch.equal(w[2][1].so.node_sel_mask,
                               w[3][1].so.node_sel_mask)
        assert (w[0][1].so.extras.get("pool_mode") == "masked") == (
            route == "csr")
    order = [(b, j) for j in range(4) for b in range(len(buckets))] + [
        (b, 0) for b in range(len(buckets))]
    calls, seen = [], [0] * len(buckets)
    with torch.inference_mode():
        for b, j in order:
            capture = seen[b] == 1
            seen[b] += 1
            spun = torch.cuda.Event()
            if seen[b] > 2:
                torch.cuda.synchronize()
                torch.cuda._sleep(1_000_000_000)
            spun.record()
            tracing.reset()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                if not capture:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    logits, out = model(buckets[b][j])
                    early = not spun.query()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            # a replay is enqueued while the card still spins
            assert early or seen[b] <= 2
            (fwd,) = [r for r in tracing.spans()
                      if r["name"] == "tgp.model.forward"]
            mask = out.so.node_sel_mask
            calls.append((b, j, fwd["attrs"],
                          _traced_kernels(prof, tmp_path / "trace.json"),
                          logits, mask, logits.clone(), mask.clone()))
    for b in range(len(buckets)):
        mine = [c for c in calls if c[0] == b]
        assert [c[2]["graph"] for c in mine] == [
            "eager", "capture", "replay", "replay", "replay"]
        launches = mine[0][2]["launches"]
        assert launches.get("spmm_csr", 0) == (3 if route == "csr" else 0)
        assert [c[2]["launches"] for c in mine] == [launches] * 2 + [{}] * 3
        # the eager forward's trace holds a kernel a wrapper launch, and
        # every later call's the same kernels
        kernels = mine[0][3]
        assert sum(kernels.values()) == sum(
            n for k, n in launches.items() if isinstance(k, str))
        assert all(c[3] == kernels for c in mine)
    for b, j, _, _, logits, mask, logits_then, mask_then in calls:
        w_logits, w_out = want[b][j]
        assert torch.equal(_bits(logits), _bits(w_logits))
        assert torch.equal(mask, w_out.so.node_sel_mask)
        assert torch.equal(_bits(logits), _bits(logits_then))
        assert torch.equal(mask, mask_then)


@pytest.mark.cuda
def test_cuda_replays_on_two_streams_keep_their_own_scratch():
    """Two caller streams serve one K1 bucket: each captures a graph of
    its own on a capture stream of its own (K1 keeps its counters per
    stream); replays enqueued on both at once, each behind ~10 ms of
    spinning on its stream so that they run together, give each
    request's eager bits."""
    _skip_without_card()
    (batches,) = _replay_buckets("csr")
    model = _served_topk_model()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    with torch.inference_mode():
        want = [model._forward(b) for b in batches]
        for s in streams:  # eager, then captured, on each stream
            with torch.cuda.stream(s):
                model(batches[0])
                model(batches[0])
        torch.cuda.synchronize()
        got = []
        for r in range(4):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    torch.cuda._sleep(20_000_000)
                    j = (r + k) % len(batches)
                    got.append((j, model(batches[j])))
            torch.cuda.synchronize()
    assert len(model._graphs) == 2
    captures = list(model._graphs._streams.values())
    assert len(captures) == 2
    assert captures[0].cuda_stream != captures[1].cuda_stream
    for j, (logits, out) in got:
        assert torch.equal(_bits(logits), _bits(want[j][0]))
        assert torch.equal(out.so.node_sel_mask, want[j][1].so.node_sel_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad", "unmarked"])
def test_cuda_forward_stays_eager_with_grad_or_unmarked(case):
    """With a gradient taken, or with a pooler not marked ``CAPTURABLE``
    (SAG), every call on the card runs eagerly and nothing is captured."""
    from tgp_tpu_torch import tracing

    _skip_without_card()
    (batches,) = _replay_buckets("csr")[:1]
    model = _served_topk_model("sag" if case == "unmarked" else "topk")
    mode = torch.enable_grad if case == "grad" else torch.inference_mode
    hows = []
    with mode():
        for _ in range(3):
            tracing.reset()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                logits, _ = model(batches[0])
            hows += [r["attrs"]["graph"] for r in tracing.spans()
                     if r["name"] == "tgp.model.forward"]
    assert hows == ["eager"] * 3 and len(model._graphs) == 0
    assert logits.requires_grad == (case == "grad")
