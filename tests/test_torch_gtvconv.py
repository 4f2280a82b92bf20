"""``GTVConv`` of the port against ``tgp_tpu``'s on the same numpy graphs
and weights: the dense branch, the generic sparse route and the CSR route
(reached on the CPU by forcing the regime map, where K1 runs its plain
version), for two ``delta_coeff``; the eps clamp on identical features;
padding invariance; and the CSR route against the generic one.

Tolerances: outputs within 1e-5 of their largest |value| and gradients
(``x``, ``weight``, ``bias``) within 1e-4 of theirs (f32 sums in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils_graphs import erdos_renyi_graph
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.graph import to_dense as j_dense
from tgp_tpu.mp.gtvconv import GTVConv as JGTV
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.graph import to_dense as t_dense
from tgp_tpu_torch.mp import gtvconv as gtv_mod
from tgp_tpu_torch.mp.gtvconv import GTVConv
from tgp_tpu_torch.ops.kernels import segment_spmm as K

torch.set_num_threads(1)
F_IN, F_OUT = 6, 5
DELTAS = [0.311, 1.0]


def _close(got, ref, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0,
                               err_msg=what)


def _graphs(sizes=(9, 6, 12), seed=3):
    out = []
    for i, n in enumerate(sizes):
        x, ei = erdos_renyi_graph(n, p=0.4, num_features=F_IN, seed=seed + i)
        w = np.random.default_rng(seed + 100 + i).uniform(
            0.5, 2.0, ei.shape[1]).astype(np.float32)
        out.append((x, ei, w))
    return out


def _jax_params(batch, delta, seed=0):
    jm = JGTV(F_OUT, delta_coeff=delta)
    p = jm.init(jax.random.key(seed), batch)
    rng = np.random.default_rng(seed)
    # a nonzero bias, so its gradient and the padding mask are exercised
    p = {"params": {"weight": p["params"]["weight"],
                    "bias": jnp.asarray(rng.normal(size=F_OUT)
                                        .astype(np.float32))}}
    return jm, p


def _port(jp, delta):
    m = GTVConv(F_IN, F_OUT, delta_coeff=delta, device="cpu")
    m.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in jp["params"].items()})
    return m


def _both(jm, jp, m, jb, tb, x, cot):
    """Output and gradients (x, weight, bias) of ⟨out, cot⟩ in both."""
    def f(p, xx):
        return jnp.sum(jm.apply(p, jb, xx) * cot)

    j_out = jm.apply(jp, jb, jnp.asarray(x))
    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    t_out = m(tb, xt)
    (t_out * torch.tensor(cot)).sum().backward()
    return (j_out, t_out,
            dict(x=(xt.grad, jg_x), weight=(m.weight.grad,
                                            jg_p["params"]["weight"]),
                 bias=(m.bias.grad, jg_p["params"]["bias"])))


def _check(j_out, t_out, grads, what):
    _close(t_out, j_out, 1e-5, f"{what} out")
    for name, (g, ref) in grads.items():
        _close(g, ref, 1e-4, f"{what} d{name}")


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("route", ["generic", "csr"])
def test_sparse_routes_match_jax(route, delta, monkeypatch):
    graphs = _graphs()
    kw = dict(pad_nodes=32, pad_edges=160)
    jb = j_from(graphs, **kw)
    tb = t_from(graphs, sort_edges=(route == "csr"), device="cpu", **kw)
    jm, jp = _jax_params(jb, delta)
    m = _port(jp, delta)
    took = []
    real_csr, real_k1 = GTVConv._csr, K.spmm_csr

    def csr(self, batch, h):
        took.append("csr")
        return real_csr(self, batch, h)

    def k1(*a):
        took.append("k1")
        return real_k1(*a)

    monkeypatch.setattr(GTVConv, "_csr", csr)
    monkeypatch.setattr(K, "spmm_csr", k1)
    if route == "csr":
        monkeypatch.setattr(gtv_mod, "use_kernel_spmm", lambda *a: True)
    rng = np.random.default_rng(7)
    x = np.asarray(jb.x)
    cot = rng.normal(size=(x.shape[0], F_OUT)).astype(np.float32)
    j_out, t_out, grads = _both(jm, jp, m, jb, tb, x, cot)
    _check(j_out, t_out, grads, f"{route} δ={delta}")
    # the CSR route: K1 once for the degree and once for Γh
    assert took == (["csr", "k1", "k1"] if route == "csr" else [])


@pytest.mark.parametrize("delta", DELTAS)
def test_dense_branch_matches_jax(delta):
    graphs = _graphs()
    jb = j_from(graphs, pad_nodes=32, pad_edges=160)
    tb = t_from(graphs, pad_nodes=32, pad_edges=160, device="cpu")
    jd, td = j_dense(jb), t_dense(tb)
    np.testing.assert_array_equal(td.adj.numpy(), np.asarray(jd.adj))
    jm, jp = _jax_params(jd, delta)
    m = _port(jp, delta)
    x = np.asarray(jd.x)
    cot = np.random.default_rng(8).normal(
        size=x.shape[:2] + (F_OUT,)).astype(np.float32)
    j_out, t_out, grads = _both(jm, jp, m, jd, td, x, cot)
    _check(j_out, t_out, grads, f"dense δ={delta}")


@pytest.mark.parametrize("route", ["dense", "generic", "csr"])
def test_eps_clamp_on_identical_features(route, monkeypatch):
    """Every node with the same features: |h_i − h_j|₁ = 0 clamps to eps
    (without the clamp γ = w/0), and the total-variation term cancels
    (out = h + b on every route).  The weights are scaled by eps so that
    γ = w/eps stays of order one: the dense formula sums terms of order γ
    that cancel, and at γ ~ 10³ their rounding alone would exceed the
    tolerance."""
    graphs = [(np.ones((n, F_IN), np.float32), ei, w * np.float32(1e-3))
              for n, (_, ei, w) in zip((9, 6, 12), _graphs())]
    jb = j_from(graphs, pad_nodes=32, pad_edges=160)
    tb = t_from(graphs, pad_nodes=32, pad_edges=160, device="cpu",
                sort_edges=(route == "csr"))
    if route == "csr":
        monkeypatch.setattr(gtv_mod, "use_kernel_spmm", lambda *a: True)
    if route == "dense":
        jb, tb = j_dense(jb), t_dense(tb)
    jm, jp = _jax_params(jb, 1.0)
    m = _port(jp, 1.0)
    cot = np.random.default_rng(9).normal(
        size=tuple(jb.x.shape[:-1]) + (F_OUT,)).astype(np.float32)
    j_out, t_out, grads = _both(jm, jp, m, jb, tb, np.asarray(jb.x), cot)
    _check(j_out, t_out, grads, f"{route} eps")
    ref = torch.relu(torch.tensor(np.asarray(jb.x)) @ m.weight + m.bias)
    mask = tb.node_mask if route != "dense" else tb.mask
    torch.testing.assert_close(t_out[mask], ref[mask], rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["generic", "csr"])
def test_padding_invariance(route, monkeypatch):
    """More padding nodes and edges change no real row's output or
    gradient."""
    graphs = _graphs()
    if route == "csr":
        monkeypatch.setattr(gtv_mod, "use_kernel_spmm", lambda *a: True)
    outs = []
    for pad in ((32, 160), (64, 512)):
        tb = t_from(graphs, pad_nodes=pad[0], pad_edges=pad[1],
                    sort_edges=(route == "csr"), device="cpu")
        torch.manual_seed(0)
        m = GTVConv(F_IN, F_OUT, delta_coeff=0.311, device="cpu",
                    generator=torch.Generator().manual_seed(1))
        x = tb.x.clone().requires_grad_(True)
        out = m(tb, x)
        n = int(tb.node_mask.sum())
        assert not out[n:].any()
        out[:n].sum().backward()
        outs.append((out[:n].detach(), x.grad[:n], m.weight.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("delta", DELTAS)
def test_csr_route_matches_generic_route(delta, monkeypatch):
    """Both sparse routes on one sorted batch: the same output and
    gradients (the transpose layout's sums against the sorted senders')."""
    tb = t_from(_graphs(), pad_nodes=32, pad_edges=160, sort_edges=True,
                device="cpu")
    got = []
    for route in (False, True):
        monkeypatch.setattr(gtv_mod, "use_kernel_spmm", lambda *a: route)
        m = GTVConv(F_IN, F_OUT, delta_coeff=delta, device="cpu",
                    generator=torch.Generator().manual_seed(2))
        x = tb.x.clone().requires_grad_(True)
        out = m(tb, x)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)
         ).sum().backward()
        got.append((out.detach(), x.grad, m.weight.grad, m.bias.grad))
    for a, b in zip(*got):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-5 * float(a.abs().max()))


def test_gtvconv_fields_and_names():
    m = GTVConv(F_IN, F_OUT, device="cpu")
    assert (m.out_channels, m.delta_coeff, m.eps, m.act, m.use_bias) == \
        (F_OUT, 1.0, 1e-3, "relu", True)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        "weight": (F_IN, F_OUT), "bias": (F_OUT,)}
    assert GTVConv(F_IN, F_OUT, use_bias=False, device="cpu").bias is None
