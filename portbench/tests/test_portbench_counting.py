"""Operations and bytes of each counted operation against a hand count,
and the shares they give."""

import math

import pytest

from portbench.harness import counting, spec


def test_spmm_hand_count():
    # 4 rows, 6 entries, width 2, bf16: 2·6·2 flops; rows read and written
    # (2·4·2·2 = 32 B), 6 indices and weights (48 B), 5 offsets (20 B)
    op = counting.spmm("spmm_csr", 4, 6, 2, 2)
    assert (op["flops"], op["bytes"]) == (24, 100)


def test_bmm_hand_count():
    # 3 products [2, 4] @ [4, 5], bf16 in, f32 out
    op = counting.bmm("dense_bmm", 3, 2, 4, 5, 2, 2, 4)
    assert op["flops"] == 3 * 2 * 2 * 4 * 5
    assert op["bytes"] == 3 * (2 * 4 * 2 + 4 * 5 * 2 + 2 * 5 * 4)


def test_matmul_passes():
    assert counting.matmul_flops(2, 3, 4, False, True) == 48
    assert counting.matmul_flops(2, 3, 4, True, False) == 96
    assert counting.matmul_flops(2, 3, 4, True, True) == 144


def test_least_time_takes_the_binding_bound():
    peaks = spec.peaks()
    t = counting.least_seconds(989e12, 1.0, 989e12, peaks)
    assert t == pytest.approx(1.0)
    t = counting.least_seconds(1.0, 3.35e12, 989e12, peaks)
    assert t == pytest.approx(1.0)


def test_sparse_model_work():
    ref = spec.load_module(spec.HERE / "reference" / "sparse_topk_gcn.py",
                           "t_sparse")
    cfg = dict(in_channels=4, hidden=8, num_classes=3, ratio=0.5,
               compute_dtype="bfloat16")
    shape = dict(nodes=10, edges=30, kept_nodes=5, kept_edges=7, graphs=1)
    serve = ref.work(cfg, shape, False, counting)
    train = ref.work(cfg, shape, True, counting)
    assert [o["name"] for o in serve["ops"]] == ["spmm_csr"] * 3
    assert len(train["ops"]) == 5
    first = serve["ops"][0]
    assert first["flops"] == 2 * 30 * 8
    assert first["bytes"] == 2 * 10 * 8 * 2 + 8 * 30 + 4 * 11
    # whole request: the graph read once (features f32; senders,
    # receivers, weights), the weights, the logits
    params = 8 * 4 + 3 * 8 * 8 + 3 * 8 + 4 * 8 + 3
    assert serve["bytes"] == 10 * 4 * 4 + 30 * 12 + params * 4 + 3 * 4
    assert train["flops"] > 2 * serve["flops"]


def test_dense_model_work():
    ref = spec.load_module(spec.HERE / "reference" / "dense_topk_gcn.py",
                           "t_dense")
    cfg = dict(in_channels=4, hidden=8, num_classes=3, ratio=0.5,
               compute_dtype="bfloat16")
    w = ref.work(cfg, dict(graphs=2, nodes=6), True, counting)
    assert [o["name"] for o in w["ops"]] == ["dense_bmm"] * 4
    assert w["ops"][0]["flops"] == 2 * 2 * 6 * 6 * 8
    assert w["ops"][1]["flops"] == 2 * 2 * 3 * 3 * 8
    assert math.isfinite(w["bytes"]) and w["bytes"] > 0
