#!/usr/bin/env python3
"""Time K1 (``spmm_csr``'s CUDA kernel) in its wide mode at several values
of ``segment_spmm.EDGES_PER_ITEM`` (the most edges of one row a warp sums;
longer rows are split into chunks of that many), on the serving request's
arrays (``chip_smoke.py``: one random graph of 65,536 nodes and 1,000,000
edges, collated as ``Predictor`` buckets it, F = 128), each mode held to its
plain version first.  Run on a CUDA card from the checkout root:

    python3 scripts/sweep_k1_range.py [--ranges 128 256 512]

Prints the card and one JSON line per (value, mode) with the median device
time (L2 flushed, host enqueue hidden; ``chip_smoke.median_ms``).  Besides
the three K1 modes of the serving path, the bf16 forward runs with the
collator's padding edges gathered from spread rows of x (the same work
without one hot row) and on the real edges alone, which separates what
the padding row costs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as S  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranges", type=int, nargs="+", default=[128, 256, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_k1_range: no CUDA device", file=sys.stderr)
        return 2
    from tgp_tpu_torch import from_graphs
    from tgp_tpu_torch.models.inference import geometric_budget
    from tgp_tpu_torch.ops.kernels import _build
    from tgp_tpu_torch.ops.kernels import segment_spmm as K

    card = S.card_line()
    print(card, flush=True)
    _build.build_all(("segment_spmm",))
    pn = geometric_budget(S.N_NODES, 64)
    b = from_graphs([S.request_graph(7)], pad_nodes=pn,
                    pad_edges=geometric_budget(S.N_EDGES, 256), max_nodes=pn,
                    sort_edges=True, device="cuda")
    N = b.num_nodes
    w = torch.where(b.edge_mask, b.edge_weight, 0.0).float()
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    x16 = torch.randn(N, S.FEATURES, generator=gen, device="cuda").bfloat16()
    x32 = torch.randn(N, S.FEATURES, generator=gen, device="cuda")
    w_t = b.edge_weight_t.float()
    # the padding edges (zero weight, all at row 0 and sender 0) gathered
    # from rows spread over x instead: the same work without one hot row
    pad = ~b.edge_mask
    spread = torch.where(pad, torch.randint(0, N, pad.shape, generator=gen,
                                            device="cuda", dtype=torch.int32),
                         b.senders)
    real = b.edge_mask
    rp_real = K.csr_offsets(b.receivers[real], b.row_ptr.shape[0] - 1)
    modes = {
        "K1 F=128 bfloat16": (x16, w, b.senders, b.row_ptr),
        "K1 F=128 bfloat16, padding senders spread": (x16, w, spread,
                                                      b.row_ptr),
        "K1 F=128 bfloat16, real edges only": (x16, w[real].contiguous(),
                                               b.senders[real].contiguous(),
                                               rp_real),
        "K1 F=128 float32": (x32, w, b.senders, b.row_ptr),
        "K1 bwd d_h F=128 bfloat16": (x16, w_t, b.receivers_t, b.row_ptr_t),
    }
    default = K.EDGES_PER_ITEM
    try:
        for rng in args.ranges:
            K.EDGES_PER_ITEM = rng
            for name, (x, wt, idx, rp) in modes.items():
                def run():
                    return K.spmm_csr(x, wt, None, idx, None, rp, None, None,
                                      None, N)
                S._worst(name, run(), K.spmm_csr_plain(x, wt, idx, rp, N),
                         K.spmm_csr_plain(x.float().abs(), wt.abs(), idx, rp,
                                          N), S.REL_TOL,
                         S.BF16_ULP if x.dtype == torch.bfloat16 else 0.0)
                ms = S.median_ms(run, flush)
                print(json.dumps({"card": card, "edges_per_warp": rng,
                                  "mode": name, "ms": ms}), flush=True)
    finally:
        K.EDGES_PER_ITEM = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
