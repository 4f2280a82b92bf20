"""``HierarchicalClassifier`` as SAGPool_h (three GCN → SAG pool → max‖mean
readout blocks, the readouts summed, a 16-8-3 head) against the
benchmark's plain reference of it (``portbench/reference/
sagpool_h_gcn.py``: float32 torch that imports nothing of the port), on
seeded random weights and 8–16 random graphs of 20–120 nodes, hidden 16:
logits, the cross-entropy loss, every parameter's gradient and each
level's kept nodes, with pooling forced compact and masked; a request
served through ``Predictor``; two Adam steps."""

import statistics

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness import weights
from portbench.programs import hierarchical_classifier as prog
from portbench.reference import sagpool_h_gcn as ref
from portbench.reference.plain import adam_steps
from tgp_tpu_torch import (HierarchicalClassifier, Predictor, from_graphs,
                           get_pooler)

torch.set_num_threads(1)
F_IN, HIDDEN, CLASSES = 8, 16, 3
CFG = dict(in_channels=F_IN, hidden=HIDDEN, ratio=0.5, num_blocks=3,
           readout="max_mean", head=[16, 8], num_classes=CLASSES)
# bf16 rounds each GCN layer's operands and outputs (2^-8 relative), and
# the error passes three levels of gating and max readouts and ReLU units
# that a rounding can switch (a 16-wide model has few of each).  Over 30
# seeds of these sizes, in both pool modes, the widest readings were:
# logits 1.13% of the largest logit, the loss 0.3%, the whole gradient
# 12.2% of its norm, a misorder of 0.0019 in a level's tanh scores (each
# score moves by about the rounding of its terms).  The limits leave room
# above them; float32 agrees to rounding and misorders nothing.
BF16_TOL = dict(logits=0.02, loss=0.01, grad=0.2, gap=0.005)


def _graphs(seed):
    """8–16 loop-free undirected graphs of 20–120 nodes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(8, 17))):
        n = int(rng.integers(20, 121))
        m = int(rng.integers(n, 3 * n))
        a = rng.integers(0, n, m)
        b = (a + rng.integers(1, n, m)) % n
        out.append((rng.standard_normal((n, F_IN)).astype(np.float32),
                    np.stack([np.concatenate([a, b]),
                              np.concatenate([b, a])])))
    return out


def _model(params, mode, dtype=torch.float32):
    pools = [get_pooler("sag", in_channels=HIDDEN, ratio=0.5, gnn_kind="gcn",
                        nonlinearity="tanh", multiplier=1.0, pool_mode=mode,
                        device="cpu") for _ in range(3)]
    model = HierarchicalClassifier(pools, CLASSES, hidden=HIDDEN,
                                   in_channels=F_IN, head=(16, 8),
                                   compute_dtype=dtype, device="cpu")
    named = dict(model.named_parameters())
    assert set(named) == set(prog.PARAMS)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(params[prog.PARAMS[name]])
    return model


def _setup(seed):
    graphs = _graphs(seed)
    params = weights.draw(ref.param_shapes(CFG), seed, "cpu")
    y = torch.as_tensor(np.random.default_rng(seed).integers(
        0, CLASSES, len(graphs)))
    return graphs, params, y


def _reference(params, graphs, y, keep=None):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logits, info = ref.forward(p, ref.pack(graphs, "cpu"), CFG, keep=keep)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    grads = {k: v.grad for k, v in p.items()}
    return logits.detach(), loss.detach(), grads, info


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["compact", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_loss_gradients_and_selection(seed, mode, dtype):
    graphs, params, y = _setup(seed)
    model = _model(params, mode, dtype)
    batch = from_graphs(graphs, sort_edges=mode == "masked", device="cpu")
    logits, outs = model(batch)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    keep = prog.kept(outs, batch.num_nodes)
    assert keep.shape == (3, batch.num_nodes) and keep.dtype == torch.bool
    assert [o.so.extras.get("pool_mode", "compact")
            for o in outs] == [mode] * 3
    # the reference pools by the port's selection and judges it by its own
    # scores; a wrong count at any level reads inf
    want, want_loss, want_grad, info = _reference(params, graphs, y, keep)
    grads = {prog.PARAMS[n]: p.grad for n, p in model.named_parameters()}
    scale = float(want.abs().max())
    err = dict(
        logits=float((logits.detach() - want).abs().max()) / scale,
        loss=abs(float(loss.detach()) - float(want_loss)) / float(want_loss),
        grad=float(torch.cat([(grads[k] - want_grad[k]).flatten()
                              for k in want_grad]).norm()
                   / torch.cat([g.flatten()
                                for g in want_grad.values()]).norm()),
        gap=info["gap"])
    if dtype == torch.bfloat16:
        assert all(err[k] <= BF16_TOL[k] for k in err), err
        return
    assert err["gap"] == 0.0
    assert err["logits"] < 1e-5 and err["loss"] < 1e-5
    med = statistics.median(float(g.norm()) for g in want_grad.values())
    for k, g in want_grad.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-4,
                                   atol=1e-5 * max(med, 1e-12))
    # the reference's own selection: the same sets where no two scores of
    # a graph tie; the compact levels break ties by slot (the rank of the
    # level before), the reference by input index, so only the masked
    # levels are held to its sets
    _, own = ref.forward(params, ref.pack(graphs, "cpu"), CFG)
    n = own["keep"].shape[1]
    assert (keep[:, :n].sum(1) == own["keep"].sum(1)).all()
    assert not keep[:, n:].any()
    if mode == "masked":
        assert torch.equal(keep[:, :n], own["keep"])
    assert (keep[1:] <= keep[:-1]).all()  # a level keeps what was kept


@pytest.mark.parametrize("sort_edges, mode", [(False, "compact"),
                                              (True, "compact"),
                                              (True, "masked")])
def test_served_request_has_the_reference_logits(sort_edges, mode):
    graphs, params, _ = _setup(2)
    model = _model(params, mode).eval()
    serve = Predictor(lambda b: model(b)[0], batch_size=4,
                      sort_edges=sort_edges, device="cpu")
    got = serve(graphs)
    with torch.no_grad():
        want, _ = ref.forward(params, ref.pack(graphs, "cpu"), CFG)
    assert got.shape == (len(graphs), CLASSES)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    assert serve.num_compiled >= 1


@pytest.mark.parametrize("mode", ["compact", "masked"])
def test_two_adam_steps_follow_the_reference(mode):
    graphs, params, y = _setup(3)
    model = _model(params, mode)
    batch = from_graphs(graphs, sort_edges=mode == "masked", device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    keeps, losses = [], []
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        logits, outs = model(batch)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        keeps.append(prog.kept(outs, batch.num_nodes))
        losses.append(float(loss.detach()))
    packed = ref.pack(graphs, "cpu")

    def loss_fn(p, t):
        logits, info = ref.forward(p, packed, CFG, keep=keeps[t])
        return F.cross_entropy(logits, y), info["gap"]

    res = adam_steps(params, loss_fn, 2, 5e-3)
    assert res["kept"] == [0.0, 0.0]
    np.testing.assert_allclose(losses, res["losses"], rtol=1e-5)
    for name, p in model.named_parameters():
        want = res["params"][prog.PARAMS[name]]
        torch.testing.assert_close(p.detach(), want, rtol=1e-4, atol=1e-6)
