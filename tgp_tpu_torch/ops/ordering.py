"""Locality-preserving node orderings and the locality SpMM path (port of
``tgp_tpu/ops/ordering.py``).

A bandwidth-reducing node order (reverse Cuthill–McKee, host-side scipy)
packs each 128-row receiver block's senders into a narrow window, the
contract of the banded SpMM (:func:`~tgp_tpu_torch.ops.kernels.
segment_spmm.spmm_banded`, K5).  :func:`plan_locality_spmm` orders the
graph once and picks the engine; :func:`locality_spmm` runs it: K5 for
``"banded"``, gather + weight + the sorted segment-sum (K2) for
``"sorted"``.  ``engine="auto"`` resolves to ``"sorted"``, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.kernels.segment_spmm import csr_offsets

__all__ = ["rcm_order", "apply_node_order", "band_after_order",
           "choose_banded_window", "plan_locality_spmm", "locality_spmm"]


def rcm_order(edge_index, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee permutation ``perm[new] = old`` of the
    symmetrized pattern (scipy's ``reverse_cuthill_mckee``)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ei = np.asarray(edge_index)
    data = np.ones(ei.shape[1], np.int8)
    A = sp.coo_matrix((data, (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes)).tocsr()
    A = A.maximum(A.T)
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      dtype=np.int64)


def apply_node_order(perm: np.ndarray, x, edge_index,
                     edge_weight=None) -> Tuple:
    """Relabel a graph by ``perm``: ``(x[perm], inv[edge_index][,
    edge_weight], inv)``; ``out_new[inv]`` maps results back."""
    perm = np.asarray(perm, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    ei = inv[np.asarray(edge_index)]
    x2 = np.asarray(x)[perm]
    if edge_weight is None:
        return x2, ei, inv
    return x2, ei, np.asarray(edge_weight), inv


def band_after_order(edge_index, num_nodes: int,
                     perm: Optional[np.ndarray] = None) -> int:
    """Max |sender − receiver| under ``perm`` (None: the current order)."""
    ei = np.asarray(edge_index)
    if perm is not None:
        inv = np.empty(num_nodes, np.int64)
        inv[np.asarray(perm)] = np.arange(num_nodes)
        ei = inv[ei]
    if ei.shape[1] == 0:
        return 0
    return int(np.abs(ei[0] - ei[1]).max())


def choose_banded_window(bandwidth: int, block_rows: int = 128,
                         max_window: int = 4096) -> Optional[int]:
    """Smallest 128-multiple window covering a receiver block's sender
    span (``2·bandwidth + block_rows + 8``), or None above
    ``max_window``."""
    need = 2 * bandwidth + block_rows + 8
    w = ((need + 127) // 128) * 128
    return w if w <= max_window else None


def plan_locality_spmm(edge_index, num_nodes: int, edge_weight=None, *,
                       block_rows: int = 128, max_window: int = 4096,
                       engine: str = "auto", device: DeviceLike = "cuda"):
    """RCM-order the graph and pick the engine (``"auto"`` → ``"sorted"``,
    ``"banded"`` raises when the band needs a window above
    ``max_window``).  Returns a dict: ``engine``, ``window``,
    ``bandwidth``, numpy ``perm``/``inv``, and the receiver-sorted layout
    in plan order as tensors on ``device`` (int32 ``senders``,
    ``receivers``, ``row_ptr [N+1]``; f32 ``edge_weight``)."""
    device = resolve_device(device)
    perm = rcm_order(edge_index, num_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    ei = inv[np.asarray(edge_index)]
    w = (np.ones(ei.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    bw = band_after_order(ei, num_nodes)
    # the banded path always runs 128-row blocks: size the window for them
    window = choose_banded_window(bw, max(block_rows, 128), max_window)

    order = np.argsort(ei[1], kind="stable")
    s_s, r_s, w_s = ei[0][order], ei[1][order], w[order]
    if engine in ("auto", "sorted"):
        chosen = "sorted"
    elif engine == "banded":
        if window is None:
            raise ValueError(f"bandwidth {bw} exceeds max_window="
                             f"{max_window}; banded engine not applicable")
        chosen = "banded"
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    receivers = dev(r_s.astype(np.int32))
    return {
        "engine": chosen,
        "window": window,
        "bandwidth": bw,
        "perm": perm,
        "inv": inv,
        "senders": dev(s_s.astype(np.int32)),
        "receivers": receivers,
        "edge_weight": dev(w_s),
        "row_ptr": csr_offsets(receivers, num_nodes),
    }


def locality_spmm(plan: dict, x_new_order: torch.Tensor) -> torch.Tensor:
    """``A·X`` in plan order for features already in plan order
    (``x[plan["perm"]]``); map back with ``out[plan["inv"]]``."""
    from tgp_tpu_torch.ops.kernels.segment_spmm import (segment_sum_sorted,
                                                        spmm_banded)

    num_rows = plan["row_ptr"].shape[0] - 1
    if plan["engine"] == "banded":
        return spmm_banded(x_new_order.contiguous(), plan["senders"],
                           plan["receivers"], plan["edge_weight"], num_rows,
                           window=plan["window"])
    # bf16 features times f32 weights promote to f32, as in JAX
    msgs = x_new_order[plan["senders"].long()] * plan["edge_weight"][:, None]
    return segment_sum_sorted(msgs.contiguous(), plan["receivers"], num_rows)
