"""Windowed SDDMM: one hand-written CUDA kernel
(``tgp_tpu_torch/csrc/sddmm.cu``) behind :func:`banded_sddmm`, with its
plain PyTorch version :func:`banded_sddmm_plain` beside it.

:func:`banded_sddmm` replaces ``tgp_tpu/ops/pallas/sddmm.py::
banded_sddmm_pallas`` (its ``_kernel``, K6): ``out[e] = ⟨a[s_e], b[r_e]⟩``
in f32, with the TPU kernel's window contract kept so that results agree
on any input.  Edges come in chunks of ``CHUNK_EDGES``; each chunk has a
window of ``window`` rows on each axis, starting at its smallest valid id
(``< Na`` or ``< Nb``; padding ids are ``Na``/``Nb``) rounded down to 8 and
clipped to ``[0, max(N, window) − window]``.  An id outside its chunk's
window gives 0.  The TPU's ``F % 128`` lane rule is gone; ``F`` must match
between ``a`` and ``b``.

:func:`sddmm_banded` is the differentiable entry (``tgp_tpu``'s
``sddmm_banded``): the kernel forward, and the JAX package's plain
scatters (no window, ids out of range masked) as the backward.

Bound on an H100: bytes (see the source).  The kernel finds the window
starts itself, and a block keeps the rows of its run of chunks in two
shared-memory rings that slide with the windows, so each row is read
about once.  Dispatch is by where the tensors lie: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  Launches are counted in ``banded_sddmm.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["banded_sddmm", "banded_sddmm_plain", "sddmm_banded"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: edges per window chunk (``banded_sddmm_pallas``'s ``block_edges``)
CHUNK_EDGES = 512


def _check(a, b, window):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must be [N, F] of one width, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if window <= 0 or window % 8:
        raise ValueError(f"window {window} must be a positive multiple of 8")


def _window_bases(ids: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """``[ceil(E / CHUNK_EDGES)]`` int32 window starts for one axis, as
    ``banded_sddmm_pallas``'s ``bases``: the chunk's smallest id below
    ``n`` (padding ids count as ``n_pad``), rounded down to 8, clipped."""
    E = ids.shape[0]
    n_chunks = max(-(-E // CHUNK_EDGES), 1)
    n_pad = max(n, window)
    key = torch.full((n_chunks * CHUNK_EDGES,), n_pad, dtype=torch.int64,
                     device=ids.device)
    ids = ids.to(torch.int64)
    key[:E] = torch.where(ids < n, ids, n_pad)
    mn = key.view(n_chunks, CHUNK_EDGES).amin(1)
    base = torch.div(mn, 8, rounding_mode="floor") * 8
    return base.clamp(0, max(n_pad - window, 0)).to(torch.int32)


def banded_sddmm_plain(a: torch.Tensor, b: torch.Tensor,
                       senders: torch.Tensor, receivers: torch.Tensor, *,
                       window: int = 512) -> torch.Tensor:
    """Plain PyTorch :func:`banded_sddmm`, windows included."""
    _check(a, b, window)
    s, r = senders.to(torch.int64), receivers.to(torch.int64)
    chunk = torch.arange(s.shape[0], device=a.device) // CHUNK_EDGES

    def in_window(ids, n, base):
        lo = base.to(torch.int64)[chunk]
        return (ids >= lo) & (ids < torch.clamp(lo + window, max=n))

    ok = (in_window(s, a.shape[0], _window_bases(senders, a.shape[0], window))
          & in_window(r, b.shape[0],
                      _window_bases(receivers, b.shape[0], window)))
    prod = (a[torch.where(ok, s, 0)].to(torch.float32)
            * b[torch.where(ok, r, 0)].to(torch.float32)).sum(-1)
    return torch.where(ok, prod, 0.0)


@functools.cache
def _lib():
    from tgp_tpu_torch.ops.kernels._build import load

    lib = load("sddmm")
    lib.tgp_sddmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.tgp_sddmm.restype = ctypes.c_int
    lib.tgp_sddmm_error_string.argtypes = [ctypes.c_int]
    lib.tgp_sddmm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(a, b, senders, receivers, window):
    """Validate, allocate the f32 output and launch on the current
    stream."""
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or t.dtype not in _DTYPE_CODE or \
                not t.is_contiguous():
            raise ValueError(f"kernel takes contiguous float32 or bfloat16 "
                             f"{name} on {dev}, got {t.dtype} on {t.device}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} shape {tuple(t.shape)} exceeds int32 "
                             "indexing")
    if a.dtype != b.dtype:
        raise ValueError(f"kernel takes a and b of one dtype, got {a.dtype} "
                         f"and {b.dtype}")
    for name, t in (("senders", senders), ("receivers", receivers)):
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous() or t.shape != senders.shape):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"of the edges' length on {dev}")
    E = senders.shape[0]
    if E >= 2 ** 31 - CHUNK_EDGES:
        raise ValueError(f"{E} edges exceed the kernel's int32 positions")
    out = torch.empty(E, dtype=torch.float32, device=dev)
    if E == 0:
        return out
    if a.shape[1] == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tgp_sddmm(a.data_ptr(), b.data_ptr(), senders.data_ptr(),
                            receivers.data_ptr(), out.data_ptr(), E,
                            a.shape[0], b.shape[0], a.shape[1], window,
                            CHUNK_EDGES, _DTYPE_CODE[a.dtype], stream)
    if err != 0:
        raise RuntimeError("sddmm kernel launch failed: "
                           + lib.tgp_sddmm_error_string(err).decode())
    banded_sddmm.launches += 1
    return out


def banded_sddmm(a: torch.Tensor, b: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, *, window: int = 512
                 ) -> torch.Tensor:
    """``out[e] = ⟨a[senders[e]], b[receivers[e]]⟩`` in f32 ``[E]`` for
    ``a [Na, F]``, ``b [Nb, F]`` (f32 or bf16), zero where an id leaves its
    chunk's window (module docstring).  No gradient (see
    :func:`sddmm_banded`)."""
    _check(a, b, window)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return banded_sddmm_plain(a, b, senders, receivers, window=window)
    if a.device.type != "cuda":
        raise ValueError(f"no sddmm path for device {a.device}")
    return _launch(a, b, senders.to(torch.int32).contiguous(),
                   receivers.to(torch.int32).contiguous(), window)


banded_sddmm.launches = 0


class _Sddmm(torch.autograd.Function):
    """``_sddmm_vjp``: the kernel forward; ``_sddmm_bwd``'s scatters."""

    @staticmethod
    def forward(ctx, a, b, senders, receivers, window):
        ctx.save_for_backward(a, b, senders, receivers)
        return banded_sddmm(a, b, senders, receivers, window=window)

    @staticmethod
    def backward(ctx, g):
        a, b, s, r = ctx.saved_tensors
        s, r = s.to(torch.int64), r.to(torch.int64)
        valid = (s >= 0) & (s < a.shape[0]) & (r >= 0) & (r < b.shape[0])
        s_safe = s.clamp(0, a.shape[0] - 1)
        r_safe = r.clamp(0, b.shape[0] - 1)
        gv = (g * valid)[:, None]
        d_a = d_b = None
        if ctx.needs_input_grad[0]:
            d_a = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            d_a.index_add_(0, s_safe, gv * b[r_safe].to(torch.float32))
            d_a = d_a.to(a.dtype)
        if ctx.needs_input_grad[1]:
            d_b = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
            d_b.index_add_(0, r_safe, gv * a[s_safe].to(torch.float32))
            d_b = d_b.to(b.dtype)
        return d_a, d_b, None, None, None


def sddmm_banded(a: torch.Tensor, b: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, *, window: int = 512
                 ) -> torch.Tensor:
    """Differentiable :func:`banded_sddmm` (``tgp_tpu``'s
    ``sddmm_banded``)."""
    return _Sddmm.apply(a, b, senders, receivers, window)
