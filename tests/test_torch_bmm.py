"""K3: the port's ``bmm`` (CPU tensors take ``bmm_plain``) against
``tgp_tpu``'s ``bmm_pallas`` in interpret mode, forward and gradients, for
the three transpose variants at tile-multiple and ragged sizes.

Both round their operands to bf16 and sum exact bf16 products in f32, so
only the order of the f32 sum differs: every element is held to 1e-5 of
its Σₖ|a||b|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.ops.pallas.bmm import bmm_pallas
from tgp_tpu_torch.ops.kernels import bmm as K

torch.set_num_threads(1)
REL = 1e-5
VARIANTS = [(False, False), (True, False), (False, True)]
# (batch, n, m, f): out [batch, n, f] contracts over m
SIZES = [(4, 128, 128, 128), (3, 40, 24, 17)]


def _operands(seed, batch, n, m, f, trans_a, trans_b):
    """Random ``a``/``b`` in their stored (pre-transpose) shapes."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, m, n) if trans_a else (batch, n, m))
    b = rng.normal(size=(batch, f, m) if trans_b else (batch, m, f))
    return a.astype(np.float32), b.astype(np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _to_torch(x, dtype, requires_grad=False):
    return torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(
        requires_grad)


def _scale(x, y, tx, ty):
    """Σₖ |op(x)| |op(y)| per output element (bf16-rounded operands)."""
    x = np.abs(_np(torch.tensor(x).to(torch.bfloat16)))
    y = np.abs(_np(torch.tensor(y).to(torch.bfloat16)))
    return np.swapaxes(x, 1, 2) @ y if tx else x @ (
        np.swapaxes(y, 1, 2) if ty else y)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _assert_within(got, ref, scale):
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= REL * scale + 1e-30).all(), \
        float(np.max(np.abs(got - ref) / (scale + 1e-30)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", SIZES, ids=["tiles", "ragged"])
@pytest.mark.parametrize("trans_a,trans_b", VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_bmm_forward_matches_pallas(trans_a, trans_b, size, dtype):
    a, b = _operands(1, *size, trans_a, trans_b)
    ref = _np(bmm_pallas(_to_jax(a, dtype), _to_jax(b, dtype), trans_a,
                         trans_b, 8, True))
    ta, tb = _to_torch(a, dtype), _to_torch(b, dtype)
    got = K.bmm(ta, tb, trans_a, trans_b)
    assert got.dtype == torch.float32
    assert got.shape == (size[0], size[1], size[3])
    scale = _scale(_np(ta), _np(tb), trans_a, trans_b)
    _assert_within(_np(got), ref, scale)
    _assert_within(_np(K.bmm_plain(ta, tb, trans_a, trans_b)), ref, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", SIZES, ids=["tiles", "ragged"])
@pytest.mark.parametrize("trans_a,trans_b", VARIANTS,
                         ids=["nn", "trans_a", "trans_b"])
def test_bmm_grads_match_pallas(trans_a, trans_b, size, dtype):
    """``da``/``db`` against ``jax.grad`` through ``bmm_pallas``'s VJP,
    with an f32 cotangent; each gradient comes back in its operand's
    dtype."""
    a, b = _operands(2, *size, trans_a, trans_b)
    w = np.random.default_rng(3).normal(
        size=(size[0], size[1], size[3])).astype(np.float32)

    def loss(x, y):
        return (bmm_pallas(x, y, trans_a, trans_b, 8, True)
                * jnp.asarray(w)).sum()

    ja, jb = jax.grad(loss, (0, 1))(_to_jax(a, dtype), _to_jax(b, dtype))
    ta, tb = _to_torch(a, dtype, True), _to_torch(b, dtype, True)
    (K.bmm(ta, tb, trans_a, trans_b) * torch.tensor(w)).sum().backward()
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    wa = _np(torch.tensor(w).to(torch.bfloat16))
    # da = (g ⊗ b) and db = (a ⊗ g) contractions, each with its own scale
    if not trans_a and not trans_b:
        sa, sb = _scale(wa, _np(tb), False, True), _scale(_np(ta), wa,
                                                          True, False)
    elif trans_a:
        sa, sb = _scale(_np(tb), wa, False, True), _scale(_np(ta), wa,
                                                          False, False)
    else:
        sa, sb = _scale(wa, _np(tb), False, False), _scale(wa, _np(ta),
                                                           True, False)
    # a bf16 gradient is rounded once more, from f32 sums that may differ
    # in their last bits: the two roundings can land one bf16 ulp apart
    slack = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    for got, ref, scale in ((ta.grad, ja, sa), (tb.grad, jb, sb)):
        got, ref = _np(got), _np(ref)
        assert got.shape == ref.shape
        assert (np.abs(got - ref)
                <= REL * scale + slack * np.abs(ref) + 1e-30).all()


def test_bmm_backward_computes_only_needed_grads(monkeypatch):
    """The dense GCN's adjacency needs no gradient: the backward runs one
    product (``db = aᵀ g``), not two, as XLA's dead-code elimination left
    it in JAX."""
    calls = []
    real = K._product
    monkeypatch.setattr(K, "_product", lambda *a: calls.append(a[2:])
                        or real(*a))
    a, b = _operands(4, 2, 8, 8, 4, False, False)
    ta, tb = torch.tensor(a), torch.tensor(b, requires_grad=True)
    K.bmm(ta, tb).sum().backward()
    assert calls == [(False, False), (True, False)]
    assert ta.grad is None and tb.grad is not None


def test_bmm_rejects_double_transpose_and_bad_inputs():
    a = torch.zeros(2, 4, 4)
    with pytest.raises(NotImplementedError):
        K.bmm(a, a, True, True)
    with pytest.raises(NotImplementedError):
        K.bmm_plain(a, a, True, True)
    # the launcher validates before it needs a card
    bad = [
        (a.to(torch.float16), a, "float32 or bfloat16"),
        (a.transpose(1, 2), a, "contiguous"),
        (a[0], a, "3-D"),
        (a, torch.zeros(2, 5, 4), "do not agree"),
        (a, torch.zeros(3, 4, 4), "do not agree"),
    ]
    # a batch above the grid's limit is split into launches, not refused
    # (tests/test_torch_cuda_kernels.py runs 70,000 products on the card)
    assert K.MAX_BATCH == 65535
    for x, y, msg in bad:
        with pytest.raises(ValueError, match=msg):
            K._launch(x, y, False, False)
    with pytest.raises(ValueError, match="no bmm path"):
        K.bmm(a.to("meta"), a.to("meta"))
    empty = K._launch(torch.zeros(2, 0, 4), torch.zeros(2, 4, 3), False,
                      False)
    assert empty.shape == (2, 0, 3) and empty.dtype == torch.float32


def _stored(batch, n, m, f, trans_a, trans_b, a_dtype, b_dtype):
    a = torch.empty((batch, m, n) if trans_a else (batch, n, m),
                    dtype=getattr(torch, a_dtype))
    b = torch.empty((batch, f, m) if trans_b else (batch, m, f),
                    dtype=getattr(torch, b_dtype))
    return a, b


BF, F32 = "bfloat16", "float32"
ROUTE_CASES = {  # id: ((batch, n, m, f), trans_a, trans_b, a, b dtypes, route)
    # the dense step's four products (batch cut to 2: the rule ignores it)
    "fwd_pre": ((2, 256, 256, 128), False, False, BF, BF, "tma"),
    "fwd_post": ((2, 128, 128, 128), False, False, BF, BF, "tma"),
    "bwd_pre_trans_a": ((2, 256, 256, 128), True, False, BF, F32, "tma"),
    "bwd_post_trans_a": ((2, 128, 128, 128), True, False, BF, F32, "tma"),
    "trans_b": ((2, 256, 128, 256), False, True, F32, BF, "tma"),
    # the default path's (f32 adjacency and features) products
    "f32_fwd_pre": ((2, 256, 256, 128), False, False, F32, F32, "tma"),
    "f32_fwd_post": ((2, 128, 128, 128), False, False, F32, F32, "tma"),
    "f32_bwd_pre_trans_a": ((2, 256, 256, 128), True, False, F32, F32,
                            "tma"),
    "ragged_aligned_bf16": ((3, 200, 136, 120), False, False, BF, BF, "tma"),
    "ragged_aligned_f32": ((3, 200, 136, 120), False, False, F32, F32,
                           "tma"),
    "ragged_aligned_trans_a": ((3, 200, 136, 120), True, False, BF, BF,
                               "tma"),
    "ragged_unaligned_bf16": ((5, 70, 130, 33), False, False, BF, BF,
                              "generic"),
    "ragged_unaligned_f32": ((5, 70, 130, 33), False, False, F32, F32,
                             "generic"),
    # bf16 rows need 8 elements, f32 rows 4
    "bf16_rows_of_12": ((2, 64, 12, 64), False, False, BF, BF, "generic"),
    "f32_rows_of_12": ((2, 64, 12, 64), False, False, F32, BF, "tma"),
    "trans_a_stored_rows_of_20": ((2, 20, 64, 64), True, False, BF, BF,
                                  "generic"),
    "trans_b_stored_rows_of_60": ((2, 64, 60, 64), False, True, BF, BF,
                                  "generic"),
    # rows fine, but the f32 output's rows are not 16 bytes
    "f_of_6": ((2, 64, 64, 6), False, True, BF, BF, "generic"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES), ids=list(ROUTE_CASES))
def test_bmm_route_rule(case):
    """``route`` is a pure function of shapes, dtypes, flags and base
    alignment; the dense step's products all take ``"tma"``."""
    size, ta, tb, adt, bdt, want = ROUTE_CASES[case]
    a, b = _stored(*size, ta, tb, adt, bdt)
    assert K.route(a, b, ta, tb) == want
    assert K.route(a, b, ta, tb) == want  # the same answer again


@pytest.mark.parametrize("dtype,offset,want", [
    ("float32", 1, "generic"), ("float32", 4, "tma"),
    ("bfloat16", 4, "generic"), ("bfloat16", 8, "tma")])
def test_bmm_route_rule_reads_base_alignment(dtype, offset, want):
    """A view whose base sits ``offset`` elements into its storage: 16-byte
    aligned bases keep ``"tma"``, others go to ``"generic"``."""
    tdt = getattr(torch, dtype)
    store = torch.empty(offset + 2 * 64 * 64 + 64, dtype=tdt)
    assert store.data_ptr() % 16 == 0
    a = store[offset:offset + 2 * 64 * 64].view(2, 64, 64)
    b = torch.empty(2, 64, 128, dtype=tdt)
    assert a.is_contiguous()
    assert K.route(a, b) == want
    assert K.route(b.transpose(1, 2).contiguous(), a, False, True) == want
