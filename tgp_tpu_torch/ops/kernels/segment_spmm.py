"""Sorted-CSR SpMM and segment-sum: one hand-written CUDA kernel
(``tgp_tpu_torch/csrc/segment_spmm.cu``) behind two wrappers, each with
its plain PyTorch version beside it.

* :func:`spmm_csr` replaces ``tgp_tpu/ops/pallas/segment_spmm.py::
  _grouped_kernel_w`` (run by ``spmm_csr`` → ``_gather_kernel_pass``):
  ``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1])} w_e · x[idx_e]``.
* :func:`segment_sum_sorted` replaces ``_grouped_kernel`` (run by
  ``segment_sum_sorted``): the unweighted sum of receiver-sorted messages,
  the same kernel with no gather index and no weight.

Both accumulate in f32 and return ``x.dtype`` (f32 or bf16), take any
width F (F = 1 included) and never write rows past ``num_rows``.

Bound on an H100: bytes.  Two flops per gathered element sit far below
the card's flop/byte balance, so the least time is idx + w + row_ptr +
one read of x + one write of out over the memory rate; the E·F gathered
elements come from L2 while x fits in its 50 MB.  The TPU kernel wrote the
gathered ``[E, F]`` rows to device memory and summed them with one-hot
matmuls; the CUDA kernel gathers each row straight into registers (a
warp per row, 16-byte vector loads), so those rows never exist.  Rows
longer than ``EDGES_PER_ITEM`` edges — the padding edges make row 0 one —
are shared with one more warp per further chunk of that many edges.

Dispatch is by where the tensors lie: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches``.
Gradients come with the sparse training slice (K1's backward over the
``*_t`` layout, the ``d_w`` SDDMM): until then the CUDA path raises on
inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["spmm_csr", "spmm_csr_plain", "segment_sum_sorted",
           "segment_sum_sorted_plain", "build_row_ptr"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: most edges one warp sums: longer rows are split across warps
EDGES_PER_ITEM = 256


def build_row_ptr(receivers_sorted: torch.Tensor, num_rows: int
                  ) -> torch.Tensor:
    """``[rows_pad+1]`` int32 CSR offsets of ascending receivers, rows
    padded to a multiple of 256; receivers outside ``[0, rows_pad)`` are
    not counted (as ``tgp_tpu``'s ``segment_sum`` drops them)."""
    rows_pad = ((num_rows + 255) // 256) * 256
    r = receivers_sorted.to(torch.int64)
    ok = (r >= 0) & (r < rows_pad)
    counts = torch.zeros(rows_pad, dtype=torch.int64, device=r.device)
    counts.index_add_(0, torch.where(ok, r, 0), ok.to(torch.int64))
    row_ptr = torch.zeros(rows_pad + 1, dtype=torch.int32, device=r.device)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return row_ptr


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def spmm_csr_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                   idx: Optional[torch.Tensor], row_ptr: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Plain PyTorch :func:`spmm_csr`: ``index_select`` + weight +
    ``index_add_`` over receivers expanded from ``row_ptr``.  ``idx=None``
    reads row ``e`` for edge ``e``, ``w=None`` weighs every edge 1."""
    rows_pad = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rid = torch.repeat_interleave(
        torch.arange(rows_pad, device=x.device), counts)
    n_e = rid.shape[0]
    src = (torch.arange(n_e, device=x.device) if idx is None
           else idx[:n_e].to(torch.int64))
    msgs = x.index_select(0, src).to(torch.float32)
    if w is not None:
        msgs = msgs * w[:n_e, None].to(torch.float32)
    out = torch.zeros(rows_pad, x.shape[1], dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, rid, msgs)
    return out[:num_rows].to(x.dtype)


def segment_sum_sorted_plain(msgs: torch.Tensor,
                             receivers_sorted: torch.Tensor, num_rows: int,
                             row_ptr: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch :func:`segment_sum_sorted`."""
    if row_ptr is None:
        row_ptr = build_row_ptr(receivers_sorted, num_rows)
    return spmm_csr_plain(msgs, None, None, row_ptr, num_rows)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from tgp_tpu_torch.ops.kernels._build import load

    lib = load("segment_spmm")
    lib.tgp_csr_spmm.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tgp_csr_spmm.restype = ctypes.c_int
    lib.tgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_vector(name, t, dtype, device, min_len=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} shape {tuple(t.shape)}")
    if min_len is not None and t.shape[0] < min_len:
        raise ValueError(f"{name} has {t.shape[0]} entries, needs "
                         f">= {min_len}")


def _launch_csr(x, idx, w, row_ptr, num_rows):
    """Validate, allocate and launch; the caller counts the launch."""
    dev = x.device
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [rows, F] tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32 indexing")
    if any(t is not None and t.requires_grad for t in (x, w)):
        raise NotImplementedError(
            "the CUDA SpMM has no backward yet (sparse training slice): "
            "call it under torch.no_grad() / torch.inference_mode()")
    _check_vector("row_ptr", row_ptr, torch.int32, dev, num_rows + 1)
    if idx is not None:
        _check_vector("idx", idx, torch.int32, dev)
    F = x.shape[1]
    n_edges = x.shape[0] if idx is None else idx.shape[0]
    if w is not None:
        _check_vector("w", w, torch.float32, dev, n_edges)
    out = torch.empty(num_rows, F, dtype=x.dtype, device=dev)
    if num_rows == 0 or F == 0:
        return out, False
    S = EDGES_PER_ITEM
    if n_edges + S >= 2 ** 31:
        raise ValueError(f"{n_edges} edges exceed the kernel's int32 "
                         "edge positions")
    # per S-edge chunk: an f32 row that a split row's warps add into, and
    # the row's arrival counter (both zeroed by the C side)
    n_chunks = -(-n_edges // S)
    acc = torch.empty(n_chunks * F, dtype=torch.float32, device=dev)
    counters = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tgp_csr_spmm(
            x.data_ptr(), None if idx is None else idx.data_ptr(),
            None if w is None else w.data_ptr(), row_ptr.data_ptr(),
            acc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            num_rows, F, S, n_chunks, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError("segment_spmm kernel launch failed: "
                           + lib.tgp_cuda_error_string(err).decode())
    return out, True


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no segment_spmm path for device {x.device}")


def spmm_csr(h: torch.Tensor, w: torch.Tensor, senders: torch.Tensor,
             row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """SpMM ``out[r] = Σ_{e: recv=r} w_e · h[send_e]`` over a
    receiver-sorted static-CSR edge list (``row_ptr`` from the collator,
    ``[rows_pad+1]`` int32).  Forward of ``tgp_tpu``'s ``spmm_csr``;
    ``[num_rows, F]`` in ``h.dtype``."""
    if _route(h) == "plain":
        return spmm_csr_plain(h, w, senders, row_ptr, num_rows)
    out, launched = _launch_csr(h, senders, w, row_ptr, num_rows)
    spmm_csr.launches += launched
    return out


spmm_csr.launches = 0


def segment_sum_sorted(msgs: torch.Tensor, receivers_sorted: torch.Tensor,
                       num_rows: int,
                       row_ptr: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Receiver-sorted ``msgs [E, F]`` → per-row sums ``[num_rows, F]`` in
    ``msgs.dtype``.  ``row_ptr`` (``[rows_pad+1]``, rows_pad a multiple of
    256 ≥ num_rows) skips building the offsets from ``receivers_sorted``."""
    if row_ptr is None:
        row_ptr = build_row_ptr(receivers_sorted, num_rows)
    elif (row_ptr.shape[0] - 1) % 256 or row_ptr.shape[0] - 1 < num_rows:
        raise ValueError(f"row_ptr of length {row_ptr.shape[0]} does not "
                         f"cover {num_rows} rows padded to 256")
    if _route(msgs) == "plain":
        return segment_sum_sorted_plain(msgs, receivers_sorted, num_rows,
                                        row_ptr)
    out, launched = _launch_csr(msgs, None, None, row_ptr, num_rows)
    segment_sum_sorted.launches += launched
    return out


segment_sum_sorted.launches = 0
