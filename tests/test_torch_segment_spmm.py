"""The port's sorted-CSR SpMM / segment-sum (``tgp_tpu_torch.ops.kernels.
segment_spmm``) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs.

Tolerances: f32 atol 1e-5 (f32 sums of a few dozen O(1) terms in another
order).  ``spmm_csr`` in bf16: one bf16 ulp of the JAX output plus 1e-5 of
the row's Σ|w·x| (both round each weight to bf16 before its product and
sum the same exact products in f32, in other orders, then round the sum
to bf16 once); ``segment_sum_sorted`` in bf16: 1e-2 of the row's Σ|w·x|
(the messages are rounded to bf16 after the weight product, in another
order than JAX's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops.pallas.segment_spmm import segment_sum_sorted as jax_sss
from tgp_tpu.ops.pallas.segment_spmm import spmm_csr as jax_spmm_csr
from tgp_tpu_torch.ops.kernels import segment_spmm as K
from tests.test_torch_cuda_kernels import (BOUNDARY_CASES, _assert_rel,
                                           _boundary_lengths, _csr_case,
                                           _layout, _chunk_of, _row_scale,
                                           _rows_case)

torch.set_num_threads(1)

def _assert_close(got, ref, dtype, scale):
    if dtype == "float32":
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5)
    else:
        _assert_rel(got, ref, 1e-2, scale)


def _bf16_ulp(v):
    """The spacing of bf16 numbers at each |v| (0 at 0)."""
    a = np.abs(np.asarray(v, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _assert_within_ulp(got, ref, scale):
    """|got − ref| ≤ one bf16 ulp of ref + 1e-5 of the row's Σ|w·x|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= _bf16_ulp(ref) + 1e-5 * scale).all()


def _jax_spmm_csr(c, x, jdt):
    return jax_spmm_csr(
        jnp.asarray(x, jdt), jnp.asarray(c["w"]), jnp.asarray(c["w_t"]),
        jnp.asarray(c["s"]), jnp.asarray(c["r"]), jnp.asarray(c["rp"]),
        jnp.asarray(c["r_t"]), jnp.asarray(c["s_t"]), jnp.asarray(c["rp_t"]),
        c["n"], True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
def test_spmm_csr_plain_matches_pallas(F, dtype):
    c = _csr_case(F, F)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = _jax_spmm_csr(c, c["x"], jdt)
    before = K.spmm_csr.launches
    got = K.spmm_csr(torch.tensor(c["x"], dtype=tdt),
                     *_layout(c, torch.tensor), c["n"])
    assert got.dtype == tdt and got.shape == (c["n"], F)
    assert K.spmm_csr.launches == before  # CPU tensors: plain version
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "float32":
        _assert_close(got.float(), ref, dtype, _row_scale(c, F))
    else:
        _assert_within_ulp(got.float().numpy(), ref, _row_scale(c, F))


@pytest.mark.parametrize("F", [1, 8])
def test_spmm_csr_bf16_rounds_weights_as_pallas(F):
    """Weights bf16 cannot represent, in pairs that cancel once rounded:
    row r sums (1 + 2⁻⁹)·x − 1·x, which is 2⁻⁹·x unrounded and exactly 0
    with both weights rounded to bf16 first, as the Pallas kernel does.
    The port's bf16 output equals JAX's bit for bit."""
    c = _csr_case(7 + F, F)
    w = np.where(np.arange(c["w"].shape[0]) % 2 == 0, 1.0 + 2.0 ** -9,
                 -1.0).astype(np.float32)
    w[c["w"] == 0] = 0.0  # padding edges keep weight 0
    s = c["s"].copy()
    s[1::2] = s[0::2][: s[1::2].shape[0]]  # each pair reads one row of x
    c = dict(c, w=w, s=s)
    assert (w.astype(jnp.bfloat16).astype(np.float32) != w).any()
    ref = np.asarray(jnp.asarray(_jax_spmm_csr(c, c["x"], jnp.bfloat16),
                                 jnp.float32))
    got = K.spmm_csr(torch.tensor(c["x"], dtype=torch.bfloat16),
                     *_layout(c, torch.tensor), c["n"]).float().numpy()
    np.testing.assert_array_equal(got, ref)
    # the unrounded weights give another answer: the test can tell
    xb = torch.tensor(c["x"], dtype=torch.bfloat16).float()
    raw = torch.zeros(c["n"], F).index_add_(
        0, torch.tensor(c["r"]).long(),
        xb[torch.tensor(s).long()] * torch.tensor(w)[:, None])
    assert (raw.to(torch.bfloat16).float().numpy() != ref).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_spmm_csr_plain_on_chunk_boundaries(case, dtype):
    """The CPU path on the layouts the CUDA tests use for the kernel's edge
    chunks (rows on and across chunk boundaries, runs of empty rows, no
    edges): against float64 sums of the same bf16-rounded weights, within
    one ulp of the output dtype plus 1e-5 of the row's Σ|w·x|."""
    F = 8
    c = _rows_case(_boundary_lengths(case, _chunk_of(F)), F, seed=3)
    tdt = getattr(torch, dtype)
    x = torch.tensor(c["x"]).to(tdt)
    w = torch.tensor(c["w"])
    got = K.spmm_csr(x, w, None, torch.tensor(c["s"]), None,
                     torch.tensor(c["rp"]), None, None, None, c["n"])
    xs = x.double()[torch.tensor(c["s"]).long()]
    wr = w.to(tdt).double()[:, None]
    ref = torch.zeros(c["n"], F, dtype=torch.float64).index_add_(
        0, torch.tensor(c["r"]).long(), xs * wr).numpy()
    scale = torch.zeros(c["n"], F, dtype=torch.float64).index_add_(
        0, torch.tensor(c["r"]).long(), (xs * wr).abs()).numpy()
    if dtype == "float32":
        assert np.all(np.abs(got.double().numpy() - ref) <= 1e-5 * scale)
    else:
        _assert_within_ulp(got.float().numpy(), ref, scale)
    assert got.shape == (c["n"], F)


@pytest.mark.parametrize("with_row_ptr", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
def test_segment_sum_sorted_plain_matches_pallas(F, dtype, with_row_ptr):
    c = _csr_case(100 + F, F)
    msgs = c["x"][c["s"]] * c["w"][:, None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rp = jnp.asarray(c["rp"]) if with_row_ptr else None
    ref = jax_sss(jnp.asarray(msgs, jdt), jnp.asarray(c["r"]), c["n"],
                  interpret=True, row_ptr=rp)
    got = K.segment_sum_sorted(
        torch.tensor(msgs, dtype=tdt), torch.tensor(c["r"]), c["n"],
        row_ptr=torch.tensor(c["rp"]) if with_row_ptr else None)
    assert got.dtype == tdt
    _assert_close(got.float(), jnp.asarray(ref, jnp.float32), dtype,
                  _row_scale(c, F))


def test_build_row_ptr_drops_out_of_range_receivers():
    """K2's offsets (``csr_offsets`` over 4 rows padded to 256) leave out
    a receiver past the padded rows, as the JAX collator does."""
    r = torch.tensor([0, 0, 1, 3, 3, 3, 300], dtype=torch.int32)
    rp = K.csr_offsets(r, 256)
    assert rp.shape == (257,) and rp.dtype == torch.int32
    assert rp[:6].tolist() == [0, 2, 3, 3, 6, 6]
    assert int(rp[-1]) == 6  # id 300 lies past rows_pad = 256
    # same as the JAX collator's offsets (jax drops the id too)
    msgs = np.arange(14, dtype=np.float32).reshape(7, 2)
    ref = jax_sss(jnp.asarray(msgs), jnp.asarray(r.numpy()), 4,
                  interpret=True)
    got = K.segment_sum_sorted(torch.tensor(msgs), r, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_segment_sum_sorted_rejects_short_row_ptr():
    with pytest.raises(ValueError, match="row_ptr"):
        K.segment_sum_sorted(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32),
                             300, row_ptr=torch.zeros(257, dtype=torch.int32))


def test_wrapper_refuses_devices_without_a_path():
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no segment_spmm path"):
        K.spmm_csr(x, torch.zeros(3, device="meta"), None,
                   torch.zeros(3, dtype=torch.int32, device="meta"), None,
                   torch.zeros(257, dtype=torch.int32, device="meta"),
                   None, None, None, 4)
