"""``tgp_tpu_torch.parallel.sparse_pool`` against ``tgp_tpu``'s, case for
case with ``tests/parallel/test_sparse_pool_unified.py``: the port's gloo
world of D = 4 CPU ranks (one world for the file) against JAX's sharded
forward on 4 of its 8 virtual devices and JAX's single-device
``TopkPoolModel``, on the same numpy graphs and the same weights (a flax
``TopkPoolModel`` tree carried by ``params_from_flax``).

Tolerances are JAX's: logits rtol 1e-4 / atol 1e-5, gradients rtol 3e-4
/ atol 1e-6.  Every rank returns the same logits and a repeat gives the
same bits.  The port's connect builds no ``[K, K]`` matrix: no collective
moves one, and the coarse conv's partial sums cross the ranks as
``[K, H]``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.graph import from_graphs
from tgp_tpu.parallel.dense_pool import (device_put_sharded_dense,
                                         prepare_sharded_dense_graph)
from tgp_tpu.parallel.sparse_pool import (TopkPoolModel as JModel,
                                          make_sharded_topk_model_forward)
from tgp_tpu.parallel.train import make_mesh
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.parallel import sparse_pool as T
from tgp_tpu_torch.parallel.launch import spawn_world
from tgp_tpu_torch.poolers import get_pooler as t_get
from tests.torch_parallel_ranks import sparse_pool_cases

D = 4
LOGITS = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=3e-4, atol=1e-6)
HIDDEN = 16


def _random_graph(n, e, seed=0, feat=6):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int64)
    r = rng.integers(0, n, e).astype(np.int64)
    keep = s != r
    s, r = (np.concatenate([s[keep], r[keep]]),
            np.concatenate([r[keep], s[keep]]))
    w = rng.uniform(0.5, 1.5, len(s)).astype(np.float32)
    x = rng.normal(size=(n, feat)).astype(np.float32)
    return x, s, r, w


def _case(alias, seed=11, init=7, n=48, e=160, loops=False, **pool_kw):
    """JAX's model and weights on a random graph (with ``loops``, five
    self-loop edges of weight 2 added), and the port's arguments for the
    same model."""
    x, s, r, w = _random_graph(n, e, seed)
    if loops:
        ids = np.arange(0, n, n // 5)[:5]
        s, r = np.concatenate([s, ids]), np.concatenate([r, ids])
        w = np.concatenate([w, np.full(5, 2.0, np.float32)])
    pool_kw.setdefault("ratio", 0.5)
    model = JModel(pooler=j_get(alias, in_channels=HIDDEN, **pool_kw),
                   hidden=HIDDEN, num_classes=3)
    n_pad = -(-n // D) * D
    flat = from_graphs([(x, np.stack([s, r]), w)], pad_nodes=n_pad,
                       pad_edges=len(s))
    params = model.init(jax.random.key(init), flat)
    state = {k: v.numpy() for k, v in params_from_flax(params).items()}
    return dict(model=model, params=params, flat=flat, graph=(x, s, r, w, n),
                port=(alias, pool_kw, state, (x, s, r, w, n)))


@pytest.fixture(scope="module")
def cases():
    return dict(forward={"topk": _case("topk"), "sag": _case("sag"),
                         "multiplier": _case("topk", seed=3, multiplier=1.7,
                                             ratio=10),
                         "loops": _case("sag", seed=8, loops=True)},
                grads=_case("topk", seed=5, init=2))


@pytest.fixture(scope="module")
def world(cases):
    payload = dict(forward={k: c["port"]
                            for k, c in cases["forward"].items()},
                   grads=cases["grads"]["port"])
    return spawn_world(sparse_pool_cases, D, "gloo", 120, args=(payload,))


def _jax_sharded(case, loss=None):
    """JAX's sharded forward on 4 devices (or the gradient of ``loss`` of
    its logits)."""
    x, s, r, w, n = case["graph"]
    x_pad, mask, S, R, W, n_pad, rows_per = prepare_sharded_dense_graph(
        x, s, r, w, n, D)
    mesh = make_mesh(D, axis="n")
    fwd = make_sharded_topk_model_forward(
        case["model"], mesh, rows_per=rows_per,
        max_nodes=case["flat"].max_nodes, axis="n")
    with mesh:
        args = device_put_sharded_dense(mesh, x_pad, mask, S, R, W,
                                        axis="n")
        if loss is None:
            return np.asarray(fwd(case["params"], *args))
        return jax.grad(lambda p: loss(fwd(p, *args)[None]))(case["params"])


@pytest.mark.parametrize("name", ["topk", "sag", "multiplier"])
def test_sharded_model_logits_match_single_device(cases, world, name):
    """Top-k, SAG, and top-k with a multiplier and an integer ratio: the
    sharded logits at D = 4 equal JAX's single-device and sharded logits
    and the port's single-device model; a repeat is bit-equal."""
    case = cases["forward"][name]
    ref = np.asarray(case["model"].apply(case["params"], case["flat"]))[0]
    jsh = _jax_sharded(case)
    for rk in world:
        got = rk[name]
        np.testing.assert_allclose(got["logits"], ref, **LOGITS)
        np.testing.assert_allclose(got["logits"], jsh, **LOGITS)
        np.testing.assert_allclose(got["ref"], ref, **LOGITS)
        assert got["repeat_equal"]
        np.testing.assert_array_equal(got["logits"],
                                      world[0][name]["logits"])


def test_sharded_gcn_keeps_existing_self_loops(cases, world):
    """On a graph with self-loop edges the sharded GCN follows
    ``gcn_norm``'s ``add_remaining_self_loops`` (a node with a loop edge
    keeps it and gets no unit loop), so the logits equal JAX's and the
    port's single-device models (JAX's sharded body adds a unit loop to
    every node and departs from them here)."""
    case = cases["forward"]["loops"]
    ref = np.asarray(case["model"].apply(case["params"], case["flat"]))[0]
    for rk in world:
        np.testing.assert_allclose(rk["loops"]["logits"], ref, **LOGITS)
        np.testing.assert_allclose(rk["loops"]["ref"], ref, **LOGITS)
        assert rk["loops"]["repeat_equal"]
    assert not np.allclose(_jax_sharded(case), ref, **LOGITS)


def test_connect_moves_no_kk_matrix(cases, world):
    """The pooled adjacency is never built: the coarse conv's partials
    cross the ranks as a ``[D, K, H]`` psum, and no collective moves a
    ``[K, K]`` block (JAX psums the dense ``[K, K]`` matrix)."""
    for name, case in cases["forward"].items():
        kmax = T.topk_budget(case["model"].pooler.ratio,
                             case["flat"].max_nodes)
        comm = world[0][name]["comm"]
        # the reduce's x_pool and the coarse conv's neighbour sums
        assert comm.count(("psum", (D, kmax, HIDDEN))) == 2, (name, comm)
        assert not [c for c in comm if tuple(c[1][-2:]) == (kmax, kmax)]


def test_sharded_model_gradients_match(cases, world):
    """CE on label 1: the gradients of the one set of weights at D = 4
    (seeded 1/D, summed over the ranks) equal JAX's single-device and
    sharded ones and the port's single-device model's; the selector's
    projection takes a gradient; a repeat gives the same bits."""
    case = cases["grads"]
    y = jnp.asarray([1])

    def loss(logits):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    g_ref = jax.grad(lambda p: loss(case["model"].apply(p, case["flat"])))(
        case["params"])
    want = {k: v.numpy() for k, v in params_from_flax(g_ref).items()}
    want_sh = {k: v.numpy() for k, v in params_from_flax(
        _jax_sharded(case, loss)).items()}
    assert np.abs(want["pooler.selector.weight"]).sum() > 0
    for rk in world:
        got = rk["grads"]
        assert set(got["grads"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["grads"][k], v, **GRADS,
                                       err_msg=k)
            np.testing.assert_allclose(got["grads"][k], want_sh[k], **GRADS,
                                       err_msg=f"{k} vs JAX sharded")
            np.testing.assert_allclose(got["ref_grads"][k], v, **GRADS,
                                       err_msg=f"{k} single-device")
        assert got["repeat_equal"]
        for k, v in got["grads"].items():
            np.testing.assert_array_equal(v, world[0]["grads"]["grads"][k])


def test_unsupported_pooler_rejected():
    model = T.TopkPoolModel(t_get("mincut", in_channels=16, k=4,
                                  device="cpu"), hidden=16, in_channels=6,
                            device="cpu")
    with pytest.raises(NotImplementedError):
        T.make_sharded_topk_model_forward(model, None, rows_per=8,
                                          max_nodes=8)
    sag = T.TopkPoolModel(t_get("sag", in_channels=16, gnn_kind="gcn",
                                device="cpu"), hidden=16, in_channels=6,
                          device="cpu")
    with pytest.raises(AssertionError, match="graph_conv"):
        T.make_sharded_topk_model_forward(sag, None, rows_per=8,
                                          max_nodes=8)


@pytest.mark.parametrize("name", ["topk", "sag", "multiplier"])
def test_carried_weights_give_jax_single_device_logits(cases, name):
    """``params_from_flax`` carries a flax ``TopkPoolModel`` tree onto the
    port's model exactly (every key, no extra), which then gives JAX's
    single-device logits."""
    case = cases["forward"][name]
    alias, pool_kw, state, (x, s, r, w, n) = case["port"]
    model = T.TopkPoolModel(t_get(alias, in_channels=HIDDEN, device="cpu",
                                  **pool_kw), hidden=HIDDEN,
                            in_channels=x.shape[1], device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    flat = t_from([(x, np.stack([s, r]), w)],
                  pad_nodes=case["flat"].num_nodes, pad_edges=len(s),
                  device="cpu")
    with torch.no_grad():
        got = model(flat).numpy()
    ref = np.asarray(case["model"].apply(case["params"], case["flat"]))
    np.testing.assert_allclose(got, ref, **LOGITS)
