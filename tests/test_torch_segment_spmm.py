"""The port's sorted-CSR SpMM / segment-sum (``tgp_tpu_torch.ops.kernels.
segment_spmm``) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs.

Tolerances: f32 atol 1e-5 (f32 sums of a few dozen O(1) terms in another
order); bf16 1e-2 relative to the row's Σ|w·x| (both sides round the f32
sum to bf16, and the Pallas kernel also rounds w to bf16 before the
product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops.pallas.segment_spmm import segment_sum_sorted as jax_sss
from tgp_tpu.ops.pallas.segment_spmm import spmm_csr as jax_spmm_csr
from tgp_tpu_torch.ops.kernels import segment_spmm as K
from tests.test_torch_cuda_kernels import _assert_rel, _csr_case, _row_scale

torch.set_num_threads(1)

def _assert_close(got, ref, dtype, scale):
    if dtype == "float32":
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5)
    else:
        _assert_rel(got, ref, 1e-2, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
def test_spmm_csr_plain_matches_pallas(F, dtype):
    c = _csr_case(F, F)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_spmm_csr(
        jnp.asarray(c["x"], jdt), jnp.asarray(c["w"]), jnp.asarray(c["w_t"]),
        jnp.asarray(c["s"]), jnp.asarray(c["r"]), jnp.asarray(c["rp"]),
        jnp.asarray(c["r_t"]), jnp.asarray(c["s_t"]), jnp.asarray(c["rp_t"]),
        c["n"], True)
    before = K.spmm_csr.launches
    got = K.spmm_csr(torch.tensor(c["x"], dtype=tdt), torch.tensor(c["w"]),
                     torch.tensor(c["s"]), torch.tensor(c["rp"]), c["n"])
    assert got.dtype == tdt and got.shape == (c["n"], F)
    assert K.spmm_csr.launches == before  # CPU tensors: plain version
    _assert_close(got.float(), jnp.asarray(ref, jnp.float32), dtype,
                  _row_scale(c, F))


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
    r = torch.tensor([0, 0, 1, 3, 3, 3, 300], dtype=torch.int32)
    rp = K.build_row_ptr(r, 4)
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
        K.spmm_csr(x, torch.zeros(3, device="meta"),
                   torch.zeros(3, dtype=torch.int32, device="meta"),
                   torch.zeros(257, dtype=torch.int32, device="meta"), 4)
