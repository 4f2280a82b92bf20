"""Batched bf16 matrix product with f32 accumulation: one hand-written
CUDA kernel (``tgp_tpu_torch/csrc/bmm.cu``) behind :func:`bmm`, with its
plain PyTorch version :func:`bmm_plain` beside it.

:func:`bmm` replaces ``tgp_tpu/ops/pallas/bmm.py::bmm_pallas`` (its
``_kernel``, K3): ``out[i] = op_a(a[i]) @ op_b(b[i])`` with ``a [B, N, M]``
and ``b [B, M, F]`` in their pre-transpose shapes; ``trans_a`` computes
``aᵀ @ b`` (``a`` stored ``[B, M, N]``), ``trans_b`` computes ``a @ bᵀ``
(``b`` stored ``[B, F, M]``).  Both operands are rounded to bf16, the
products summed in f32, and the output is f32 ``[B, N, F]``.

The gradient mirrors ``_bmm_bwd``: ``da``/``db`` are the same product with
other transpose flags (no transposed copy is written), cast back to each
operand's dtype, and computed only for the operands that need one.

Bound on an H100: bytes (32–51 flops a byte at the dense regime's shapes,
far below the tensor cores' balance); see the source for what the kernel
does about it.

Dispatch is by where the tensors lie: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise — there is no fallback.  On the
card the source has two routes, and :func:`route` picks one from the
shapes, dtypes, flags and base addresses alone (never by catching a
failure): ``"tma"`` (TMA loads into a swizzled shared-memory ring,
``wgmma``) when both operands' bases are 16-byte aligned, their stored
rows a multiple of 16 bytes (bf16 inner extent % 8, f32 % 4) and the
output width ``f % 4 == 0``; ``"generic"`` (WMMA on register-staged tiles,
any shape) otherwise.  The dense step's products all take ``"tma"``.
Launches (the backward's included) are counted in ``bmm.launches`` and,
by route, in ``bmm.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["bmm", "bmm_plain", "route"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel puts the batch on the grid's z dimension
MAX_BATCH = 65535
#: the C interface's code for each route
_ROUTE_CODE = {"tma": 1, "generic": 0}
ROUTES = tuple(_ROUTE_CODE)


def _check_flags(trans_a: bool, trans_b: bool) -> None:
    if trans_a and trans_b:
        raise NotImplementedError("trans_a and trans_b together")


def _op(t: torch.Tensor, trans: bool) -> torch.Tensor:
    return t.transpose(-1, -2) if trans else t


def bmm_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
              trans_b: bool = False) -> torch.Tensor:
    """Plain PyTorch :func:`bmm` (no gradient rule of its own):
    ``op_a(a)`` and ``op_b(b)`` rounded to bf16, multiplied in f32.  The
    CPU path, and the reference the kernel is held to (with TF32 off)."""
    _check_flags(trans_a, trans_b)
    return torch.matmul(_op(a, trans_a).to(torch.bfloat16).float(),
                        _op(b, trans_b).to(torch.bfloat16).float())


def route(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
          trans_b: bool = False) -> str:
    """The kernel route for contiguous 3-D ``a``, ``b`` (stored shapes, as
    :func:`bmm` takes them): ``"tma"`` when TMA can address both operands
    and the output — bases 16-byte aligned, stored rows a multiple of 16
    bytes, ``f % 4 == 0`` — else ``"generic"``."""
    def rows_ok(t):
        width = 8 if t.dtype == torch.bfloat16 else 4
        return t.shape[-1] % width == 0 and t.data_ptr() % 16 == 0

    f = b.shape[1] if trans_b else b.shape[2]
    return "tma" if rows_ok(a) and rows_ok(b) and f % 4 == 0 else "generic"


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from tgp_tpu_torch.ops.kernels._build import load

    lib = load("bmm")
    lib.tgp_bmm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    lib.tgp_bmm.restype = ctypes.c_int
    lib.tgp_bmm_error_string.argtypes = [ctypes.c_int]
    lib.tgp_bmm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, trans_a: bool,
            trans_b: bool) -> torch.Tensor:
    """Validate, allocate the f32 output and launch on the current stream,
    on :func:`route`'s route."""
    _check_flags(trans_a, trans_b)
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"kernel takes float32 or bfloat16 {name}, got "
                             f"{t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor, got "
                             f"shape {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if max(t.shape) >= 2 ** 31:
            raise ValueError(f"{name} shape {tuple(t.shape)} exceeds int32 "
                             "indexing")
    batch = a.shape[0]
    n, m = (a.shape[2], a.shape[1]) if trans_a else (a.shape[1], a.shape[2])
    mb, f = (b.shape[2], b.shape[1]) if trans_b else (b.shape[1], b.shape[2])
    if b.shape[0] != batch or mb != m:
        raise ValueError(f"bmm shapes do not agree: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, trans_a={trans_a}, "
                         f"trans_b={trans_b}")
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the kernel's {MAX_BATCH}")
    if batch == 0 or n == 0 or f == 0 or m == 0:
        return torch.zeros(batch, n, f, dtype=torch.float32, device=a.device)
    out = torch.empty(batch, n, f, dtype=torch.float32, device=a.device)
    chosen = route(a, b, trans_a, trans_b)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.tgp_bmm(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch,
                          n, m, f, _DTYPE_CODE[a.dtype], _DTYPE_CODE[b.dtype],
                          int(trans_a), int(trans_b), _ROUTE_CODE[chosen],
                          stream)
    if err != 0:
        raise RuntimeError(f"bmm kernel launch failed ({chosen} route): "
                           + lib.tgp_bmm_error_string(err).decode())
    bmm.launches += 1
    bmm.launches_by_route[chosen] += 1
    return out


def _product(a, b, trans_a, trans_b):
    if a.device.type == "cpu" and b.device.type == "cpu":
        return bmm_plain(a, b, trans_a, trans_b)
    if a.device.type == "cuda":
        return _launch(a, b, trans_a, trans_b)
    raise ValueError(f"no bmm path for devices {a.device}, {b.device}")


class _Bmm(torch.autograd.Function):
    """``_bmm_fwd`` / ``_bmm_bwd`` of the Pallas kernel."""

    @staticmethod
    def forward(ctx, a, b, trans_a, trans_b):
        ctx.save_for_backward(a, b)
        ctx.trans = (trans_a, trans_b)
        return _product(a, b, trans_a, trans_b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        trans_a, trans_b = ctx.trans
        want_a, want_b = ctx.needs_input_grad[:2]
        g = g.contiguous()
        da = db = None
        if not trans_a and not trans_b:  # out = a @ b
            if want_a:
                da = _product(g, b, False, True)  # g @ bᵀ
            if want_b:
                db = _product(a, g, True, False)  # aᵀ @ g
        elif trans_a:  # out = aᵀ @ b
            if want_a:
                da = _product(b, g, False, True)  # b @ gᵀ
            if want_b:
                db = _product(a, g, False, False)  # a @ g
        else:  # out = a @ bᵀ
            if want_a:
                da = _product(g, b, False, False)  # g @ b
            if want_b:
                db = _product(g, a, True, False)  # gᵀ @ a
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None, None)


def bmm(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
        trans_b: bool = False) -> torch.Tensor:
    """``out[i] = op_a(a[i]) @ op_b(b[i])``: f32 ``[B, N, F]`` from bf16-
    rounded operands, differentiable in both (see the module docstring)."""
    _check_flags(trans_a, trans_b)
    return _Bmm.apply(a, b, trans_a, trans_b)


bmm.launches = 0
bmm.launches_by_route = dict.fromkeys(ROUTES, 0)
