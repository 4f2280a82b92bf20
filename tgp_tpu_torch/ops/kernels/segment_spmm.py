"""Sorted-CSR SpMM and segment-sums: three hand-written CUDA kernels
(``tgp_tpu_torch/csrc/segment_spmm.cu``, ``segment_reduce.cu`` and
``banded_spmm.cu``) behind five wrappers, each with its plain PyTorch
version beside it.  Each replaces kernels of
``tgp_tpu/ops/pallas/segment_spmm.py``:

* :func:`spmm_csr` — ``_grouped_kernel_w`` (K1, run by ``spmm_csr`` →
  ``_gather_kernel_pass``): ``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1])}
  w_e · x[idx_e]``.  Its gradient mirrors the JAX custom VJP: ``d_h =
  Aᵀg`` is the same kernel over the sender-sorted transpose layout, and
  ``d_w = ⟨h[s], g[r]⟩`` a plain gather-and-dot, computed only when asked.
* :func:`segment_sum_sorted` — ``_grouped_kernel`` (K2): the unweighted sum
  of receiver-sorted messages, the same kernel with no gather index and no
  weight; its gradient is the gather ``g[clip(receivers)]``.
* :func:`sorted_segment_sum` — ``_kernel`` / ``sorted_segment_sum_pallas``
  (K4), K2's function read from ``row_ptr`` alone (edges past
  ``row_ptr[num_rows]`` are never read), the same gather gradient; behind
  :func:`spmm_sorted` (gather, weight, K4).  It has two routes, picked by
  :func:`segment_route` from the shapes alone: ``"long"``
  (``segment_reduce.cu``: the edge range cut into chunks that fill the
  card, 8 row loads a thread in flight, a two-level finish of split rows)
  where the segments are long, as in the sparse readout, and ``"wide"``
  (``segment_spmm.cu``'s warp-per-row mode) elsewhere.
  :func:`gather_segment_sum` is the readout's entry to K4, on the route
  the same rule picks: either kernel reads the rows through the readout's
  sort order and skips masked ones, so no sorted, masked copy is written.  The TPU kernel's
  tiling arguments (``block_rows``, ``block_edges``, ``precision``,
  ``interpret``) and its padding of F to 128 lanes have no counterpart:
  the kernels take any row count and width.
* :func:`banded_sorted_spmm` — ``_banded_kernel`` /
  ``banded_sorted_spmm_pallas`` (K5, ``banded_spmm.cu``): each
  ``block_rows``-row receiver block gathers only senders inside its
  window of x, weights rounded to x's dtype; a block of threads slides a
  shared-memory ring of x's rows over its run of windows.  Its route
  (:func:`banded_route`: 16-byte or element copies) follows x's row width
  and alignment.  Behind :func:`spmm_banded`, whose gradient is the JAX
  package's plain scatter.

All accumulate in f32 and return ``x.dtype`` (f32 or bf16), take any width
F (F = 1 included), round each weight to ``x.dtype`` before its product
(as the Pallas kernels' one-hot · w in the messages' dtype does) and never
write rows past ``num_rows``.

Bound on an H100: bytes.  Two flops per gathered element sit far below
the card's flop/byte balance, so the least time is idx + w + row_ptr +
one read of x + one write of out over the memory rate; the E·F gathered
elements come from L2 while x fits in its 50 MB.  The TPU kernels wrote
the gathered ``[E, F]`` rows to device memory (or gathered from a VMEM
window with one-hot matmuls) and summed them with one-hot matmuls;
``segment_spmm.cu`` gathers each row straight into registers, so those
rows never exist, and ``banded_spmm.cu`` reads them from its ring of x's
rows in shared memory.  In ``segment_spmm.cu`` a warp sums a row of at
most ``EDGES_PER_ITEM`` edges;
a longer row (the collator's padding makes row 0 one) is split into
chunks of that many, summed by warps that come first in the grid.  Rows
of F ≤ 4 take a narrow mode: each warp owns 256 consecutive edges, each
lane 8, and a segmented scan joins rows across lanes.  A split row is
finished from its chunks' partial sums in chunk order, without float
atomics: two runs on the same inputs give the same bits (every kernel
here).  The scratch of ``segment_spmm.cu`` and ``segment_reduce.cu``
(partial sums and self-resetting counters) is kept per stream, so a call
allocates only its output.

Dispatch is by where the tensors lie: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches, the backward's included, in
``<wrapper>.launches``; ``sorted_segment_sum.launches_by_route`` and
``banded_sorted_spmm.launches_by_route`` count them by route
(:func:`gather_segment_sum`'s on ``sorted_segment_sum``'s).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["spmm_csr", "spmm_csr_plain", "segment_sum_sorted",
           "segment_sum_sorted_plain", "sorted_segment_sum",
           "sorted_segment_sum_plain", "segment_route", "gather_segment_sum",
           "gather_segment_sum_plain", "spmm_sorted", "banded_sorted_spmm",
           "banded_sorted_spmm_plain", "banded_route", "spmm_banded",
           "check_band_contract", "sort_edges_csr", "csr_offsets",
           "csr_layouts"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: most edges of one row that one warp sums in ``segment_spmm.cu``'s wide
#: mode (F > 4): longer rows are split into chunks of this many
EDGES_PER_ITEM = 256
#: widest row of ``segment_spmm.cu``'s narrow mode (edge-balanced already)
NARROW_MAX_F = 4
#: K4's routes (:func:`segment_route`)
SEGMENT_ROUTES = ("long", "wide")
#: ``"long"``'s shapes: segments of at least this many positions on
#: average, and at most this many segments (``segment_reduce.cu`` walks a
#: chunk's rows one after another); both where the routes cross on an
#: H100 (``scripts/ab_k4_k5.py routes``)
LONG_MIN_POSITIONS, LONG_MAX_SEGMENTS = 32, 1024
#: K5's routes (:func:`banded_route`)
BANDED_ROUTES = ("vector", "element")
#: most rows of a receiver block that ``banded_spmm.cu`` stages
MAX_BLOCK_ROWS = 1024


def segment_route(num_rows: int, n_edges: int, F: int) -> str:
    """K4's route for ``num_rows`` segments over ``n_edges`` positions of
    width ``F``: ``"long"`` (``segment_reduce.cu``) for at most
    ``LONG_MAX_SEGMENTS`` segments of at least ``LONG_MIN_POSITIONS``
    positions on average, rows wider than the narrow mode's; else
    ``"wide"`` (``segment_spmm.cu``, a warp a row).  The sparse readout of
    one graph of 65,536 rows, of 64 graphs of 256 or of 512 graphs of 32
    takes ``"long"``; a readout of 1,024 graphs of 18 rows or of 4,096 of
    64, and a banded ``spmm_sorted`` (65,536 rows of 16 edges), take
    ``"wide"``."""
    return ("long" if F > NARROW_MAX_F and num_rows <= LONG_MAX_SEGMENTS
            and n_edges >= LONG_MIN_POSITIONS * max(num_rows, 1)
            else "wide")


def banded_route(x: torch.Tensor) -> str:
    """K5's route for ``x [N, F]``: ``"vector"`` (16-byte copies and loads)
    when its rows are a multiple of 16 bytes and its base 16-byte aligned,
    else ``"element"``."""
    aligned = (x.shape[1] * x.element_size()) % 16 == 0 and \
        x.data_ptr() % 16 == 0
    return "vector" if aligned else "element"


def _rows_pad(rows: int, multiple: int = 256) -> int:
    """The rows of K2's (256) and K5's (128) offsets."""
    return -(-rows // multiple) * multiple


def csr_offsets(keys_sorted: torch.Tensor, rows: int,
                ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[rows + 1]`` int32 CSR offsets of the ascending ``keys_sorted``,
    the one source of the kernels' offsets: entry ``r`` counts the keys
    below ``r``, so keys at or past ``rows`` are not counted (a caller
    keys masked or out-of-range ids to ``rows`` first).  By
    ``torch.searchsorted``, with no host sync; ``ids``: a ready ``arange``
    of at least ``rows + 1`` in the keys' dtype."""
    ids = (torch.arange(rows + 1, dtype=keys_sorted.dtype,
                        device=keys_sorted.device) if ids is None
           else ids[:rows + 1])
    return torch.searchsorted(keys_sorted, ids, out_int32=True)


CsrLayouts = collections.namedtuple("CsrLayouts", (
    "order", "senders", "receivers", "row_ptr",
    "perm", "senders_t", "receivers_t", "row_ptr_t"))


def csr_layouts(senders: torch.Tensor, receivers: torch.Tensor, rows: int,
                rows_t: int) -> CsrLayouts:
    """K1's input for the edges ``senders → receivers`` (int ids of one
    dtype): ``order``, a stable sort by receiver, the edges in that order
    and the ``[rows + 1]`` offsets ``row_ptr``; then the transpose layout:
    ``perm``, a stable sort of those edges by sender (so each sender's
    edges ascend by receiver), the edges in that order and the ``[rows_t
    + 1]`` offsets ``row_ptr_t``.  Ids at or past a side's rows are not
    counted.  Tensor ops on the ids' device that read nothing back to the
    host, with one answer on any device."""
    receivers_s, order = torch.sort(receivers, stable=True)
    senders_s = senders.index_select(0, order)
    senders_t, perm = torch.sort(senders_s, stable=True)
    ids = torch.arange(max(rows, rows_t) + 1, dtype=receivers.dtype,
                       device=receivers.device)
    return CsrLayouts(order, senders_s, receivers_s,
                      csr_offsets(receivers_s, rows, ids), perm, senders_t,
                      receivers_s.index_select(0, perm),
                      csr_offsets(senders_t, rows_t, ids))


def _band_window_base(senders_sorted: torch.Tensor, row_ptr: torch.Tensor,
                      num_rows: int, n_pad: int, window: int,
                      block_rows: int) -> torch.Tensor:
    """``[num_rows // block_rows]`` int32 window starts, as
    ``banded_sorted_spmm_pallas`` computes them: a block's smallest sender
    among the edges ``row_ptr`` gives it, rounded down to 8 and clipped to
    ``[0, n_pad − window]``; an empty block takes the top of that range."""
    E = senders_sorted.shape[0]
    nblk = num_rows // block_rows
    dev = senders_sorted.device
    starts = row_ptr[: num_rows + 1: block_rows].to(torch.int64)
    is_start = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    is_start.index_add_(0, starts.clamp(0, E), torch.ones_like(starts))
    blk = (torch.cumsum(is_start[:E], 0) - 1).clamp(0, nblk - 1)
    key = torch.where(torch.arange(E, device=dev) < row_ptr[num_rows],
                      senders_sorted.to(torch.int64), n_pad)
    min_send = torch.full((nblk,), n_pad, dtype=torch.int64, device=dev)
    min_send.scatter_reduce_(0, blk, key, "amin")
    base = torch.div(min_send, 8, rounding_mode="floor") * 8
    return base.clamp(0, max(n_pad - window, 0)).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def _csr_sum_plain(x, w, idx, row_ptr, num_rows, win=None):
    """``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1])} w_e · x[idx_e]`` for
    ``r < num_rows`` by ``index_select`` + ``index_add_``; ``idx=None``
    reads row ``e`` for edge ``e``, ``w=None`` weighs every edge 1.  ``win
    = (window, block_rows)``: the windowed mode (see
    :func:`banded_sorted_spmm`)."""
    rp = row_ptr[: num_rows + 1].to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=x.device), rp[1:] - rp[:-1])
    edges = int(rp[0]) + torch.arange(rows.shape[0], device=x.device)
    src = edges if idx is None else idx[edges].to(torch.int64)
    if win is None:  # JAX's gather clamps its indices
        src = src.clamp(0, x.shape[0] - 1)
    # each weight rounded to x's dtype before its product, as the Pallas
    # kernels' one-hot · w in msgs' dtype does
    wt = (torch.ones(rows.shape[0], device=x.device) if w is None
          else w[edges].to(x.dtype).to(torch.float32))
    if win is not None:
        window, block_rows = win
        base = _band_window_base(idx, row_ptr, num_rows,
                                 max(x.shape[0], window), window, block_rows)
        lo = base.to(torch.int64)[rows // block_rows]
        keep = (src >= lo) & (src < torch.clamp(lo + window,
                                                max=x.shape[0]))
        wt = torch.where(keep, wt, 0.0)
        src = torch.where(keep, src, 0)
    msgs = x.index_select(0, src).to(torch.float32) * wt[:, None]
    out = torch.zeros(num_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, rows, msgs)
    return out.to(x.dtype)


def spmm_csr_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                   idx: Optional[torch.Tensor], row_ptr: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Plain PyTorch forward of :func:`spmm_csr` (``idx=None`` reads row
    ``e`` for edge ``e``, ``w=None`` weighs every edge 1)."""
    return _csr_sum_plain(x, w, idx, row_ptr, num_rows)


def segment_sum_sorted_plain(msgs: torch.Tensor,
                             receivers_sorted: torch.Tensor, num_rows: int,
                             row_ptr: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch :func:`segment_sum_sorted`."""
    if row_ptr is None:
        row_ptr = csr_offsets(receivers_sorted, _rows_pad(num_rows))
    return _csr_sum_plain(msgs, None, None, row_ptr, num_rows)


def sorted_segment_sum_plain(msgs: torch.Tensor,
                             rids: Optional[torch.Tensor],
                             row_ptr: torch.Tensor, num_rows: int
                             ) -> torch.Tensor:
    """Plain PyTorch :func:`sorted_segment_sum` (``rids`` unused)."""
    return _csr_sum_plain(msgs, None, None, row_ptr, num_rows)


def gather_segment_sum_plain(x: torch.Tensor, perm: torch.Tensor,
                             keep: torch.Tensor, row_ptr: torch.Tensor,
                             num_rows: int) -> torch.Tensor:
    """Plain PyTorch :func:`gather_segment_sum`: the rows of ``x`` whose
    ``keep`` is False replaced by zeros (a select, so a NaN there is not
    added), put in the order ``perm``, summed by ``row_ptr``."""
    rows = torch.where(keep[:, None], x, 0.0).index_select(0, perm.long())
    return _csr_sum_plain(rows, None, None, row_ptr, num_rows)


def banded_sorted_spmm_plain(x: torch.Tensor, senders_sorted: torch.Tensor,
                             row_ptr: torch.Tensor, w_sorted: torch.Tensor,
                             num_rows: int, *, window: int = 512,
                             block_rows: int = 128) -> torch.Tensor:
    """Plain PyTorch :func:`banded_sorted_spmm`, windows included."""
    _check_band_args(x, row_ptr, num_rows, window, block_rows)
    return _csr_sum_plain(x, w_sorted, senders_sorted, row_ptr, num_rows,
                          (window, block_rows))


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------


@functools.cache
def _lib(name):
    """The built library of ``csrc/<name>.cu`` with its C functions typed."""
    from tgp_tpu_torch.ops.kernels._build import load

    lib = load(name)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "segment_spmm":
        lib.tgp_csr_spmm.argtypes = ([vp] * 5 + [i32] * 2 + [vp] * 3
                                     + [i32] * 5 + [vp])
        lib.tgp_csr_ranges.argtypes = [i32] * 3
        lib.tgp_csr_ranges.restype = i32
        lib.tgp_cuda_error_string.argtypes = [i32]
        lib.tgp_cuda_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.tgp_cuda_error_string
    elif name == "segment_reduce":
        lib.tgp_segment_reduce.argtypes = [vp] * 7 + [i32] * 6 + [vp]
        lib.tgp_segment_reduce_chunks.argtypes = [vp] * 2 + [i32] * 3
        lib.tgp_segment_reduce_chunks.restype = i32
        lib.tgp_segment_reduce_error_string.argtypes = [i32]
        lib.tgp_segment_reduce_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.tgp_segment_reduce_error_string
    else:
        lib.tgp_banded_spmm.argtypes = [vp] * 5 + [i32] * 8 + [vp]
        lib.tgp_banded_spmm_error_string.argtypes = [i32]
        lib.tgp_banded_spmm_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.tgp_banded_spmm_error_string
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


def _check_rows(x):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [rows, F] tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32 indexing")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.error_string(err).decode())


#: (kernel, device index, stream) -> (counters, slots): a kernel's scratch,
#: kept per stream so that no memset runs per call (the kernels leave
#: their counters at zero)
_WORKSPACE = {}


def _workspace(kind, dev, stream, n_counters, n_slots):
    """Zeroed int32 counters and f32 slots for one launch of ``kind``,
    grown on demand."""
    key = (kind, dev.index, stream)
    counters, part = _WORKSPACE.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
    if part is None or part.numel() < n_slots:
        part = torch.empty(n_slots, dtype=torch.float32, device=dev)
    _WORKSPACE[key] = counters, part
    return counters, part


def _launch_csr(x, idx, w, row_ptr, num_rows, keep=None):
    """``segment_spmm.cu``: validate, allocate and launch (``keep``: bool
    ``[N]``, rows flagged False skipped); True if the kernel was launched
    (the caller counts it)."""
    dev = x.device
    _check_rows(x)
    _check_vector("row_ptr", row_ptr, torch.int32, dev, num_rows + 1)
    if idx is not None:
        _check_vector("idx", idx, torch.int32, dev)
    F = x.shape[1]
    n_edges = x.shape[0] if idx is None else idx.shape[0]
    if w is not None:
        _check_vector("w", w, torch.float32, dev, n_edges)
    if keep is not None:
        _check_vector("keep", keep, torch.bool, dev, x.shape[0])
    out = torch.empty(num_rows, F, dtype=x.dtype, device=dev)
    if num_rows == 0 or F == 0 or x.shape[0] == 0:
        return out.zero_(), False
    S = EDGES_PER_ITEM
    if n_edges + max(S, 256) >= 2 ** 31:
        raise ValueError(f"{n_edges} edges exceed the kernel's int32 "
                         "edge positions")
    lib = _lib("segment_spmm")
    n_ranges = lib.tgp_csr_ranges(n_edges, F, S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters, part = _workspace("csr", dev, stream, n_ranges,
                                    2 * n_ranges * F)
        err = lib.tgp_csr_spmm(
            x.data_ptr(), None if idx is None else idx.data_ptr(),
            None if w is None else w.data_ptr(),
            None if keep is None else keep.data_ptr(), row_ptr.data_ptr(),
            x.shape[0], n_edges, part.data_ptr(), counters.data_ptr(),
            out.data_ptr(), num_rows, F, S, n_ranges, _DTYPE_CODE[x.dtype],
            stream)
    _raise_on(lib, err, "segment_spmm")
    return out, True


def _launch_reduce(x, perm, keep, row_ptr, num_rows):
    """``segment_reduce.cu`` (K4's ``"long"`` route): validate, allocate and
    launch; True if the kernel was launched (the caller counts it)."""
    dev = x.device
    _check_rows(x)
    _check_vector("row_ptr", row_ptr, torch.int32, dev, num_rows + 1)
    n_edges = x.shape[0]
    if perm is not None:
        _check_vector("perm", perm, torch.int32, dev)
        n_edges = perm.shape[0]
    if keep is not None:
        _check_vector("keep", keep, torch.bool, dev, x.shape[0])
    F = x.shape[1]
    out = torch.empty(num_rows, F, dtype=x.dtype, device=dev)
    if num_rows == 0 or F == 0 or x.shape[0] == 0:
        return out.zero_(), False
    if n_edges >= 2 ** 30:
        raise ValueError(f"{n_edges} positions exceed the kernel's int32 "
                         "positions")
    lib = _lib("segment_reduce")
    code = _DTYPE_CODE[x.dtype]
    n_chunks = lib.tgp_segment_reduce_chunks(x.data_ptr(), out.data_ptr(),
                                             n_edges, F, code)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters, part = _workspace("reduce", dev, stream, 3 * n_chunks,
                                    2 * n_chunks * F)
        err = lib.tgp_segment_reduce(
            x.data_ptr(), None if perm is None else perm.data_ptr(),
            None if keep is None else keep.data_ptr(), row_ptr.data_ptr(),
            part.data_ptr(), counters.data_ptr(), out.data_ptr(),
            x.shape[0], n_edges, num_rows, F, n_chunks, code, stream)
    _raise_on(lib, err, "segment_reduce")
    return out, True


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"no {name} path for device {x.device}")


def _csr_sum(x, w, idx, row_ptr, num_rows, counter):
    """``segment_spmm.cu`` on a CUDA tensor (one launch counted on
    ``counter``), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return _csr_sum_plain(x, w, idx, row_ptr, num_rows)
    _on_card(x, "segment_spmm")
    out, launched = _launch_csr(x, idx, w, row_ptr, num_rows)
    counter.launches += launched
    return out


# ---------------------------------------------------------------------------
# K1: spmm_csr
# ---------------------------------------------------------------------------


class _SpmmCsr(torch.autograd.Function):
    """``tgp_tpu``'s ``spmm_csr`` custom VJP (``_spmm_csr_fwd`` /
    ``_spmm_csr_bwd``)."""

    @staticmethod
    def forward(ctx, h, w, w_t, senders, receivers, row_ptr, receivers_t,
                row_ptr_t, num_rows):
        ctx.num_rows, ctx.h_shape = num_rows, h.shape
        # h is read back only by w's gradient
        ctx.save_for_backward(h if ctx.needs_input_grad[1] else None, w,
                              w_t, senders, receivers, receivers_t,
                              row_ptr_t)
        return _csr_sum(h, w, senders, row_ptr, num_rows, spmm_csr)

    @staticmethod
    def backward(ctx, g):
        h, w, w_t, senders, receivers, receivers_t, row_ptr_t = \
            ctx.saved_tensors
        n = ctx.num_rows
        g = g.contiguous()
        d_h = d_w = None
        if ctx.needs_input_grad[0]:
            # d_h = Aᵀ g over the sender-sorted layout; the kernel rounds
            # w_t to g's dtype and clamps receivers_t to g's rows, as the
            # JAX backward's w_t.astype and clip do
            d_h = _csr_sum(g, w_t, receivers_t, row_ptr_t,
                           ctx.h_shape[0], spmm_csr)
        if ctx.needs_input_grad[1]:
            # d_w = SDDMM ⟨h[s], g[r]⟩ in f32
            d_w = (h[senders.long()].to(torch.float32)
                   * g[receivers.clamp(0, n - 1).long()].to(torch.float32)
                   ).sum(-1).to(w.dtype)
        return d_h, d_w, None, None, None, None, None, None, None


def spmm_csr(h: torch.Tensor, w: torch.Tensor, w_t: Optional[torch.Tensor],
             senders: torch.Tensor, receivers: Optional[torch.Tensor],
             row_ptr: torch.Tensor, receivers_t: Optional[torch.Tensor],
             senders_t: Optional[torch.Tensor],
             row_ptr_t: Optional[torch.Tensor], num_rows: int
             ) -> torch.Tensor:
    """SpMM ``out[r] = Σ_{e: recv=r} w_e · h[send_e]`` over a
    receiver-sorted static-CSR edge list (``row_ptr`` from the collator,
    ``[rows_pad+1]`` int32); ``[num_rows, F]`` in ``h.dtype``.  The
    arguments are ``tgp_tpu``'s ``spmm_csr``'s: ``w_t`` must equal ``w``
    in the sender-sorted order of ``senders_t``/``receivers_t``/
    ``row_ptr_t`` (the collator's transpose layout), which the gradient
    for ``h`` runs over; ``receivers`` serves ``w``'s gradient.  ``w_t``
    gets no gradient, and ``senders_t`` is not read (as in JAX).  The
    transpose layout may be None where no gradient is taken."""
    del senders_t
    if torch.is_grad_enabled() and (
            (h.requires_grad and (w_t is None or receivers_t is None
                                  or row_ptr_t is None))
            or (w.requires_grad and receivers is None)):
        raise ValueError("spmm_csr's gradient needs the transpose layout "
                         "(w_t, receivers_t, row_ptr_t) for h and the "
                         "receivers for w")
    return _SpmmCsr.apply(h, w, w_t, senders, receivers, row_ptr,
                          receivers_t, row_ptr_t, num_rows)


spmm_csr.launches = 0


# ---------------------------------------------------------------------------
# K2 and K4: segment sums of receiver-sorted messages
# ---------------------------------------------------------------------------


def _k4_sum(x, perm, keep, row_ptr, num_rows, route):
    """K4 on ``route``: ``segment_reduce.cu`` (``"long"``) or
    ``segment_spmm.cu`` (``"wide"``) on a CUDA tensor, reading row
    ``perm[e]`` for position ``e`` (``e`` itself without ``perm``) and
    skipping rows whose ``keep`` is False; one launch counted on
    :func:`sorted_segment_sum`, by route.  The plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        if perm is None:
            return _csr_sum_plain(x, None, None, row_ptr, num_rows)
        return gather_segment_sum_plain(x, perm, keep, row_ptr, num_rows)
    _on_card(x, "sorted_segment_sum")
    if route == "long":
        out, launched = _launch_reduce(x, perm, keep, row_ptr, num_rows)
    else:
        out, launched = _launch_csr(x, perm, None, row_ptr, num_rows, keep)
    sorted_segment_sum.launches += launched
    sorted_segment_sum.launches_by_route[route] += launched
    return out


class _SortedSum(torch.autograd.Function):
    """Sum of receiver-sorted messages by ``row_ptr``; the gradient is the
    gather ``g[clip(receivers, 0, num_rows − 1)]`` (``_sss_bwd``).
    ``route``: K4's (None for K2's kernel)."""

    @staticmethod
    def forward(ctx, msgs, receivers_sorted, row_ptr, num_rows, route):
        ctx.num_rows = num_rows
        ctx.save_for_backward(receivers_sorted)
        if route is None:
            return _csr_sum(msgs, None, None, row_ptr, num_rows,
                            segment_sum_sorted)
        return _k4_sum(msgs, None, None, row_ptr, num_rows, route)

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return (g[r.clamp(0, ctx.num_rows - 1).long()], None, None, None,
                None)


def segment_sum_sorted(msgs: torch.Tensor, receivers_sorted: torch.Tensor,
                       num_rows: int,
                       row_ptr: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Receiver-sorted ``msgs [E, F]`` → per-row sums ``[num_rows, F]`` in
    ``msgs.dtype``, differentiable in ``msgs``.  ``row_ptr``
    (``[rows_pad+1]``, rows_pad a multiple of 256 ≥ num_rows) skips
    building the offsets from ``receivers_sorted``."""
    if row_ptr is None:
        row_ptr = csr_offsets(receivers_sorted, _rows_pad(num_rows))
    elif (row_ptr.shape[0] - 1) % 256 or row_ptr.shape[0] - 1 < num_rows:
        raise ValueError(f"row_ptr of length {row_ptr.shape[0]} does not "
                         f"cover {num_rows} rows padded to 256")
    return _SortedSum.apply(msgs, receivers_sorted, row_ptr, num_rows, None)


segment_sum_sorted.launches = 0


def sorted_segment_sum(msgs: torch.Tensor, rids: Optional[torch.Tensor],
                       row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1])} msgs[e]`` for receiver-
    sorted ``msgs [E, F]`` → ``[num_rows, F]`` in ``msgs.dtype`` (K4's
    contract: the kernels read only ``row_ptr``, so padding edges must sort
    past ``row_ptr[num_rows]``; ``rids`` is the receiver of each edge, read
    only by the gradient, ``g[clip(rids)]``).  On the card the kernel is
    :func:`segment_route`'s pick from the shapes."""
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be [E, F], got shape "
                         f"{tuple(msgs.shape)}")
    if row_ptr.dim() != 1 or row_ptr.shape[0] < num_rows + 1:
        raise ValueError(f"row_ptr of shape {tuple(row_ptr.shape)} needs "
                         f"num_rows + 1 = {num_rows + 1} entries")
    if rids is None:
        if torch.is_grad_enabled() and msgs.requires_grad:
            raise ValueError("sorted_segment_sum's gradient needs rids")
        rids = torch.zeros(msgs.shape[0], dtype=torch.int32,
                           device=msgs.device)
    return _SortedSum.apply(msgs, rids, row_ptr, num_rows,
                            segment_route(num_rows, *msgs.shape))


sorted_segment_sum.launches = 0
sorted_segment_sum.launches_by_route = dict.fromkeys(SEGMENT_ROUTES, 0)


class _GatherSum(torch.autograd.Function):
    """:func:`gather_segment_sum`; the gradient is the gather
    ``where(keep, g[ids], 0)``: no float scatter."""

    @staticmethod
    def forward(ctx, x, perm, keep, ids, row_ptr, num_rows):
        ctx.save_for_backward(keep, ids)
        return _k4_sum(x, perm, keep, row_ptr, num_rows,
                       segment_route(num_rows, perm.shape[0], x.shape[1]))

    @staticmethod
    def backward(ctx, g):
        keep, ids = ctx.saved_tensors
        d_x = torch.where(keep[:, None], g[ids.long()], 0.0)
        return d_x, None, None, None, None, None


def gather_segment_sum(x: torch.Tensor, perm: torch.Tensor,
                       keep: torch.Tensor, ids: torch.Tensor,
                       row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1]), keep[perm[e]]}
    x[perm[e]]`` → ``[num_rows, F]`` in ``x.dtype``: K4, on the route
    :func:`segment_route` picks from ``(num_rows, len(perm), F)``, reading
    the rows of ``x [N, F]`` through the int32 order ``perm`` (a stable
    sort of ``ids``, the rows' segments in ``[0, num_rows)``) and skipping
    rows whose bool ``keep`` is False, so a NaN there never reaches a
    sum.  The gradient is ``where(keep, g[ids], 0)``.  The sparse
    readout's sum (``reduce/global_reduce.py``)."""
    if x.dim() != 2 or perm.shape[0] > x.shape[0]:
        raise ValueError(f"x must be [N, F] with N >= perm's length, got "
                         f"{tuple(x.shape)} and {tuple(perm.shape)}")
    if row_ptr.dim() != 1 or row_ptr.shape[0] < num_rows + 1:
        raise ValueError(f"row_ptr of shape {tuple(row_ptr.shape)} needs "
                         f"num_rows + 1 = {num_rows + 1} entries")
    return _GatherSum.apply(x, perm, keep, ids, row_ptr, num_rows)


def spmm_sorted(senders_sorted: torch.Tensor, rids_sorted: torch.Tensor,
                row_ptr: torch.Tensor, edge_weight_sorted: torch.Tensor,
                x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """SpMM over a receiver-sorted edge list: gather, weight, then
    :func:`sorted_segment_sum` (``tgp_tpu``'s ``spmm_sorted``)."""
    msgs = x[senders_sorted.long()] * edge_weight_sorted[:, None]
    return sorted_segment_sum(msgs.contiguous(), rids_sorted, row_ptr,
                              num_rows)


# ---------------------------------------------------------------------------
# K5: the banded (windowed) SpMM
# ---------------------------------------------------------------------------


def _check_band_args(x, row_ptr, num_rows, window, block_rows):
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F], got shape {tuple(x.shape)}")
    if block_rows <= 0 or num_rows % block_rows:
        raise ValueError(f"num_rows {num_rows} must be a multiple of "
                         f"block_rows {block_rows}")
    if window <= 0 or window % 8:
        raise ValueError(f"window {window} must be a positive multiple of 8")
    if row_ptr.dim() != 1 or row_ptr.shape[0] < num_rows + 1:
        raise ValueError(f"row_ptr of shape {tuple(row_ptr.shape)} needs "
                         f"num_rows + 1 = {num_rows + 1} entries")


def _launch_banded(x, senders, row_ptr, w, num_rows, window, block_rows):
    """``banded_spmm.cu``: validate, allocate and launch on
    :func:`banded_route`'s route; the route, or None when nothing was
    launched."""
    dev = x.device
    _check_rows(x)
    _check_vector("senders_sorted", senders, torch.int32, dev)
    _check_vector("w_sorted", w, torch.float32, dev, senders.shape[0])
    _check_vector("row_ptr", row_ptr, torch.int32, dev, num_rows + 1)
    if block_rows > MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows {block_rows} exceeds the kernel's "
                         f"{MAX_BLOCK_ROWS}")
    if senders.shape[0] >= 2 ** 31 - 4096:
        raise ValueError(f"{senders.shape[0]} edges exceed the kernel's "
                         "int32 positions")
    F = x.shape[1]
    out = torch.empty(num_rows, F, dtype=x.dtype, device=dev)
    if num_rows == 0 or F == 0 or x.shape[0] == 0:
        return out.zero_(), None
    chosen = banded_route(x)
    lib = _lib("banded_spmm")
    with torch.cuda.device(dev):
        err = lib.tgp_banded_spmm(
            x.data_ptr(), senders.data_ptr(), w.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), x.shape[0], senders.shape[0],
            num_rows, F, window, block_rows, _DTYPE_CODE[x.dtype],
            int(chosen == "vector"), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, f"banded_spmm ({chosen} route)")
    return out, chosen


def banded_sorted_spmm(x: torch.Tensor, senders_sorted: torch.Tensor,
                       row_ptr: torch.Tensor, w_sorted: torch.Tensor,
                       num_rows: int, *, window: int = 512,
                       block_rows: int = 128) -> torch.Tensor:
    """``out[r] = Σ_{e∈[row_ptr[r], row_ptr[r+1])} w_e · x[send_e]`` over
    receiver-sorted edges, with ``banded_sorted_spmm_pallas``'s window
    contract: receiver block ``b`` (rows ``[b·block_rows, (b+1)·
    block_rows)``) gathers only senders in ``[base_b, base_b + window)``,
    ``base_b`` its smallest sender rounded down to 8 and clipped to
    ``[0, max(N, window) − window]``; other senders add 0 (check the layout
    with :func:`check_band_contract`).  Weights are rounded to ``x.dtype``
    before the product; the sum is f32, the output ``[num_rows, F]`` in
    ``x.dtype``.  No gradient (see :func:`spmm_banded`)."""
    _check_band_args(x, row_ptr, num_rows, window, block_rows)
    if x.device.type == "cpu":
        return banded_sorted_spmm_plain(x, senders_sorted, row_ptr, w_sorted,
                                        num_rows, window=window,
                                        block_rows=block_rows)
    _on_card(x, "banded_spmm")
    out, chosen = _launch_banded(
        x, senders_sorted.to(torch.int32).contiguous(), row_ptr,
        w_sorted.to(torch.float32).contiguous(), num_rows, window,
        block_rows)
    if chosen is not None:
        banded_sorted_spmm.launches += 1
        banded_sorted_spmm.launches_by_route[chosen] += 1
    return out


banded_sorted_spmm.launches = 0
banded_sorted_spmm.launches_by_route = dict.fromkeys(BANDED_ROUTES, 0)


class _BandedSpmm(torch.autograd.Function):
    """``_banded_spmm_vjp``: the banded kernel forward; the backward is the
    JAX package's scatter (``_banded_bwd``), with no window."""

    @staticmethod
    def forward(ctx, x, senders_sorted, receivers_sorted, w_sorted, num_rows,
                window):
        ctx.num_rows = num_rows
        ctx.save_for_backward(x, senders_sorted, receivers_sorted, w_sorted)
        # receiver −1 (sort_edges_csr's padding, at the end): not counted
        rows_pad = _rows_pad(num_rows, 128)
        row_ptr = csr_offsets(torch.where(receivers_sorted >= 0,
                                          receivers_sorted, rows_pad),
                              rows_pad)
        out = banded_sorted_spmm(x, senders_sorted, row_ptr, w_sorted,
                                 row_ptr.shape[0] - 1, window=window)
        return out[:num_rows]

    @staticmethod
    def backward(ctx, g):
        x, s, r, w = ctx.saved_tensors
        safe_s = s.clamp(0, x.shape[0] - 1).long()
        g_r = g[r.clamp(0, ctx.num_rows - 1).long()].to(torch.float32)
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            d_x.index_add_(0, safe_s, g_r * w.to(torch.float32)[:, None])
            d_x = d_x.to(x.dtype)
        if ctx.needs_input_grad[3]:
            d_w = (x[safe_s].to(torch.float32) * g_r).sum(-1).to(w.dtype)
        return d_x, None, None, d_w, None, None


def spmm_banded(x: torch.Tensor, senders_sorted: torch.Tensor,
                receivers_sorted: torch.Tensor, w_sorted: torch.Tensor,
                num_rows: int, window: int = 512) -> torch.Tensor:
    """Differentiable banded SpMM ``[num_rows, F]`` (``tgp_tpu``'s
    ``spmm_banded``): offsets of the ascending ``receivers_sorted``, rows
    padded to 128 (ids past them, and negative ids at the end such as
    ``sort_edges_csr``'s −1 padding, are not counted), then
    :func:`banded_sorted_spmm`.
    Gradients for ``x`` and ``w_sorted`` are plain scatters that ignore the
    window, as in JAX."""
    return _BandedSpmm.apply(x, senders_sorted, receivers_sorted, w_sorted,
                             num_rows, window)


def check_band_contract(senders, receivers, edge_mask, num_rows: int,
                        block_rows: int = 128, window: int = 512) -> bool:
    """Host-side check of the band contract: True iff every receiver
    block's masked senders span fewer than ``window − 8`` rows.  Takes
    numpy arrays or tensors."""
    s, r, m = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
               for a in (senders, receivers, edge_mask))
    s, r = s[m.astype(bool)], r[m.astype(bool)]
    for rb in range(0, num_rows, block_rows):
        sel = (r >= rb) & (r < rb + block_rows)
        if sel.any() and s[sel].max() - s[sel].min() >= window - 8:
            return False
    return True


def sort_edges_csr(senders: torch.Tensor, receivers: torch.Tensor,
                   edge_weight: torch.Tensor, edge_mask: torch.Tensor,
                   num_rows: int):
    """Sort edges by receiver, masked edges last (receiver −1, weight 0),
    and build the ``[num_rows+1]`` int32 offsets of the valid ones
    (:func:`csr_offsets`; valid receivers must not be negative):
    ``(senders, receivers, weights, row_ptr)``, as ``tgp_tpu``'s
    ``sort_edges_csr``."""
    key, order = torch.sort(
        torch.where(edge_mask, receivers.to(torch.int64), num_rows),
        stable=True)
    m = edge_mask[order]
    s_s = senders[order]
    r_s = torch.where(m, receivers[order], -1)
    w_s = torch.where(m, edge_weight[order], 0.0)
    # masked edges and receivers past the rows are not counted
    return s_s, r_s, w_s, csr_offsets(key, num_rows)
