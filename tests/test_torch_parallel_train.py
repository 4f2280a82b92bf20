"""``tgp_tpu_torch.parallel.train`` against ``tgp_tpu.parallel.train``, case
for case with the data-parallel cases of ``tests/parallel/test_sharded.py``
and ``test_pooled_model.py::test_dp_train_step_supports_adamw``: the
port's gloo world of D = 4 CPU ranks (one world for the file) against
JAX's step on 4 of its 8 virtual devices, the same weights (carried by
``params_from_flax``) and batches.  Loss and post-step weights within
rtol = atol = 1e-4; a step repeated from the same state gives the same
bits."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.parallel.train import make_dp_train_step as j_dp_step
from tgp_tpu.parallel.train import stack_batches as j_stack
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.parallel.launch import spawn_world
from tgp_tpu_torch.parallel.train import make_mesh, stack_batches
from tests.torch_parallel_ranks import train_cases
from tests.utils_graphs import erdos_renyi_graph

D = 4
TOL = dict(rtol=1e-4, atol=1e-4)
PAD = dict(pad_nodes=64, pad_edges=256, max_nodes=16)


def _graphs(sizes, seed):
    return [erdos_renyi_graph(n, p=0.4, num_features=4, seed=seed + i)
            for i, n in enumerate(sizes)]


def _jax_model():
    return JPC(pooler=j_get("topk", in_channels=8, ratio=0.5),
               num_classes=2, hidden=8)


@pytest.fixture(scope="module")
def setup():
    same = _graphs([6, 9], 0)
    params = _jax_model().init(jax.random.key(0), j_from(same))
    distinct = [_graphs([5 + r, 9 - r], 10 * r) for r in range(D)]
    ys = [np.array([r % 2, 1 - r % 2]) for r in range(D)]
    cases = {
        "state": {k: v.numpy() for k, v in params_from_flax(params).items()},
        "same": ([same] * D, [np.array([0, 1])] * D, {}),
        # the distinct batches share one padding so that they stack
        "distinct": (distinct, ys, PAD),
        "adamw": (np.ones((D, 3, 4), np.float32),
                  np.zeros((D, 3, 2), np.float32)),
    }
    ranks = spawn_world(train_cases, D, "gloo", 120, args=(cases,))
    return params, cases, ranks


def _jax_dp(params, graphs_per_rank, ys, pad):
    mesh = Mesh(np.array(jax.devices()[:D]), ("gp",))
    model = _jax_model()

    def loss_fn(p, b, yy):
        logits, out = model.apply(p, b)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yy).mean() + out.loss_sum()

    tx = optax.sgd(0.1)
    step = j_dp_step(loss_fn, tx, mesh, axis="gp")
    sb = j_stack([j_from(g, **pad) for g in graphs_per_rank])
    new, _, loss = step(params, tx.init(params), sb, jnp.asarray(np.stack(ys)))
    return float(loss), {k: v.numpy() for k, v
                         in params_from_flax(jax.tree.map(np.asarray,
                                                          new)).items()}


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], err_msg=k, **TOL)


def test_dp_train_step_matches_single_device(setup):
    """Identical batches on every rank: the step equals one single-device
    step (a factor-D slip in the gradient average would not)."""
    params, cases, ranks = setup
    graphs = cases["same"][0][0]
    model = _jax_model()
    y = jnp.asarray(np.array([0, 1]))

    def loss_fn(p):
        logits, out = model.apply(p, j_from(graphs))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean() + out.loss_sum()

    loss1, g = jax.value_and_grad(loss_fn)(params)
    tx = optax.sgd(0.1)
    single = optax.apply_updates(params, tx.update(g, tx.init(params))[0])
    want = (float(loss1), {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, single)).items()})
    for rk in ranks:
        _check(rk["same"], want)
        assert rk["same_repeat_equal"]
    _check(ranks[0]["same"], _jax_dp(params, *cases["same"]))


def test_dp_train_step_distinct_batches_match_jax(setup):
    params, cases, ranks = setup
    want = _jax_dp(params, *cases["distinct"])
    for rk in ranks:
        _check(rk["distinct"], want)
        assert rk["distinct_repeat_equal"]


def test_dp_train_step_supports_adamw(setup):
    _, cases, ranks = setup
    mesh = Mesh(np.array(jax.devices()[:D]), ("dp",))
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    params = {"w": jnp.ones((4, 2))}
    step = j_dp_step(lambda p, b, y: jnp.mean((b @ p["w"] - y) ** 2), tx,
                     mesh)
    p2, _, loss = step(params, tx.init(params), *map(jnp.asarray,
                                                      cases["adamw"]))
    for rk in ranks:
        got_loss, got_w = rk["adamw"]
        assert np.isfinite(got_loss)
        assert not np.allclose(got_w, 1.0)
        np.testing.assert_allclose(got_loss, float(loss), **TOL)
        np.testing.assert_allclose(got_w, np.asarray(p2["w"]), **TOL)


def test_make_mesh_raises_on_too_few_devices(setup):
    """A mesh larger than the world must fail loudly, never truncate: in
    the world of 4 and in a process with no world at all."""
    _, _, ranks = setup
    assert all("only 4 rank(s) visible" in rk["too_many_raises"]
               for rk in ranks)
    with pytest.raises(ValueError, match="only .* visible"):
        make_mesh(2)


def test_stack_batches_matches_jax():
    graphs = [_graphs([5 + r, 9 - r], 10 * r) for r in range(2)]
    got = stack_batches([from_graphs(g, device="cpu", **PAD)
                         for g in graphs])
    ref = j_stack([j_from(g, **PAD) for g in graphs])
    for name in ("x", "senders", "receivers", "edge_weight", "node_mask",
                 "edge_mask", "node_graph"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert got.x.shape[0] == 2
    with pytest.raises(ValueError, match="static metadata"):
        stack_batches([{"n": 1}, {"n": 2}])
    assert torch.equal(stack_batches([torch.ones(2)] * 3), torch.ones(3, 2))
