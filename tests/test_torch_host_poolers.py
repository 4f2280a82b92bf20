"""The host-side poolers (``get_pooler`` ``"ndp"``, ``"nmf"``, ``"sep"``,
``"eigen"``) and EigenPool's reduce and lift against ``tgp_tpu``'s on the
same batch: the pooled features within 1e-5 of JAX's (their largest
|value|; the dense products add in another order), the pooled graph and
the selection equal, the lift of the pooled features within 1e-5, and
the gradients of the reduce and the lift within 1e-5 of ``jax.grad``'s.
EigenPool's reduce is a per-graph batched product here, where JAX forms
an ``[N, H·K, F]`` outer product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.lift.eigenpool import eigenpool_lift as j_lift
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.reduce.eigenpool import eigenpool_reduce as j_reduce
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.lift.eigenpool import eigenpool_lift
from tgp_tpu_torch.poolers import (EigenPooling, HostPooling, NDPPooling,
                                   NMFPooling, SEPPooling, get_pooler)
from tgp_tpu_torch.reduce.eigenpool import eigenpool_reduce

TOL = 1e-5
ALIASES = {"ndp": {}, "nmf": {"k": 4}, "sep": {}, "eigen": {"k": 4},
           "sep_h3": {"max_height": 3}, "eigen_modes": {"k": 5,
                                                         "num_modes": 2}}


def _graphs(seed=0, count=4, weighted=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(14, 36, count):
        up = np.triu(rng.random((n, n)) < 0.2, 1)
        s, r = np.nonzero(up | up.T)
        g = (rng.normal(size=(n, 6)).astype(np.float32),
             np.stack([s, r]).astype(np.int64))
        if weighted:
            g = g + ((rng.random(s.size) + 0.5).astype(np.float32),)
        out.append(g)
    return out


def _batches(graphs):
    return (j_from(graphs, pad_nodes=160, pad_edges=1024),
            from_graphs(graphs, pad_nodes=160, pad_edges=1024, device="cpu"))


def _alias(name):
    return name.split("_")[0]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    assert got.shape == want.shape
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


def test_get_pooler_builds_the_host_poolers():
    assert isinstance(get_pooler("ndp"), NDPPooling)
    assert isinstance(get_pooler("sep", max_height=3), SEPPooling)
    nmf = get_pooler("nmf", k=5, in_channels=8, ratio=0.5)  # others dropped
    assert isinstance(nmf, NMFPooling) and nmf.k == 5
    eig = get_pooler("eigen", k=6, num_modes=2)
    assert isinstance(eig, EigenPooling) and eig.num_modes == 2
    assert all(isinstance(p, HostPooling) for p in (nmf, eig))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(ALIASES))
def test_host_pooler_matches_jax(name, weighted):
    jb, tb = _batches(_graphs(1, weighted=weighted))
    kw = ALIASES[name]
    jo = j_get(_alias(name), **kw)(jb)
    to = get_pooler(_alias(name), **kw)(tb)
    _close(to.graph.x.numpy(), jo.graph.x)
    for f in ("senders", "receivers", "edge_weight", "edge_mask",
              "node_graph", "node_pos", "node_mask"):
        np.testing.assert_array_equal(getattr(to.graph, f).numpy(),
                                      np.asarray(getattr(jo.graph, f)), f)
    if jo.so.cluster_index is not None:
        for f in ("cluster_index", "weight", "node_sel_mask"):
            np.testing.assert_array_equal(getattr(to.so, f).numpy(),
                                          np.asarray(getattr(jo.so, f)), f)
    else:
        np.testing.assert_array_equal(to.so.assignment.numpy(),
                                      np.asarray(jo.so.s))
        assert to.so.num_modes == jo.so.num_modes


@pytest.mark.parametrize("name", sorted(ALIASES))
def test_host_pooler_lifting_matches_jax(name):
    jb, tb = _batches(_graphs(2))
    kw = ALIASES[name]
    jp, tp = j_get(_alias(name), **kw), get_pooler(_alias(name), **kw)
    jo, to = jp(jb), tp(tb)
    x_pool = np.asarray(jo.graph.x)
    if _alias(name) in ("nmf", "eigen"):
        B, K = jb.num_graphs, jo.so.num_clusters
        x_pool = x_pool[: B * K].reshape(B, K, -1)
    want = jp(jb, so=jo.so, lifting=True, x=jnp.asarray(x_pool))
    got = tp(tb, so=to.so, lifting=True, x=torch.tensor(x_pool))
    _close(got.numpy(), want)
    if _alias(name) == "ndp":
        # a kept node gets its own row back; the others 0
        keep = to.so.node_sel_mask.numpy()
        x = tb.x.numpy()
        np.testing.assert_array_equal(got.numpy()[keep], x[keep])
        assert not got.numpy()[~keep].any()


def _eigen_case(seed=3, modes=3, k=4):
    jb, tb = _batches(_graphs(seed))
    pooler = get_pooler("eigen", k=k, num_modes=modes)
    so = pooler(tb).so
    jso = j_get("eigen", k=k, num_modes=modes)(jb).so
    return jb, tb, so, jso


@pytest.mark.parametrize("modes", [1, 3])
def test_eigenpool_reduce_values_and_gradients_match_jax(modes):
    jb, tb, so, jso = _eigen_case(modes=modes)
    x = np.asarray(jb.x)
    cot = np.random.default_rng(0).normal(
        size=(jb.num_graphs, jso.num_clusters, modes * x.shape[1]))
    cot = cot.astype(np.float32)
    out, vjp = jax.vjp(lambda v: j_reduce(v, jso), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = eigenpool_reduce(xt, so)
    (got * torch.tensor(cot)).sum().backward()
    _close(got.detach().numpy(), out)
    _close(xt.grad.numpy(), vjp(jnp.asarray(cot))[0])
    # and through Θ (the operator's own gradient)
    th = so.assignment.clone().requires_grad_(True)
    (eigenpool_reduce(xt.detach(), so.replace(assignment=th))
     * torch.tensor(cot)).sum().backward()
    _, vjp_s = jax.vjp(lambda s: j_reduce(jnp.asarray(x), jso.replace(s=s)),
                       jso.s)
    _close(th.grad.numpy(), vjp_s(jnp.asarray(cot))[0])


@pytest.mark.parametrize("modes", [1, 3])
def test_eigenpool_lift_values_and_gradients_match_jax(modes):
    jb, tb, so, jso = _eigen_case(seed=4, modes=modes)
    F = 5
    rng = np.random.default_rng(1)
    xp = rng.normal(size=(jb.num_graphs, jso.num_clusters, modes * F))
    xp = xp.astype(np.float32)
    cot = rng.normal(size=(jb.num_nodes, F)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: j_lift(v, jso), jnp.asarray(xp))
    xt = torch.tensor(xp, requires_grad=True)
    got = eigenpool_lift(xt, so)
    (got * torch.tensor(cot)).sum().backward()
    _close(got.detach().numpy(), out)
    _close(xt.grad.numpy(), vjp(jnp.asarray(cot))[0])


def test_eigenpool_reduce_makes_no_node_by_mode_intermediate(monkeypatch):
    """The reduce's largest tensor is the ``[B, max_nodes, ·]`` layout,
    never JAX's ``[N, H·K, F]`` outer product."""
    jb, tb, so, jso = _eigen_case()
    sizes = []
    real = torch.matmul

    def spy(a, b, **kw):
        sizes.extend([a.numel(), b.numel()])
        return real(a, b, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    eigenpool_reduce(tb.x, so)
    N, HK, F = tb.num_nodes, so.assignment.shape[1], tb.num_features
    assert sizes and max(sizes) < N * HK * F
