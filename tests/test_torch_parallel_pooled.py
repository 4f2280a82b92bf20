"""``tgp_tpu_torch.parallel.pooled_model`` and ``scaling`` against
``tgp_tpu``'s, case for case with ``tests/parallel/test_pooled_model.py``:
the port's gloo world of D = 4 CPU ranks (one world for the file) against
JAX's sharded forward on 4 of its 8 virtual devices, the same weights
(``init_pooled_params``' dict, carried by ``pooled_params_from_numpy``)
and graph.  ``level_ks`` and the partitions are equal; logits and the
last level's rows within rtol = atol = 1e-4; gradients within 1e-4 of
each leaf's largest |value|, against JAX's and the port's single-device
twin; a repeat gives the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tgp_tpu.parallel import pooled_model as J
from tgp_tpu_torch.parallel import pooled_model as T
from tgp_tpu_torch.parallel.launch import spawn_world
from tests.torch_parallel_ranks import pooled_cases
from tests.utils_graphs import erdos_renyi_graph

D = 4
TOL = dict(rtol=1e-4, atol=1e-4)
FORWARD = {"n256_l1": (256, 1), "n320_l1": (320, 1), "n256_l2": (256, 2)}


def _np_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _case(n_nodes, levels, seed, key, p=0.05, features=12, weighted=False):
    x, ei = erdos_renyi_graph(n_nodes, p=p, num_features=features,
                              seed=seed)
    params = J.init_pooled_params(jax.random.key(key), features, 16, 3,
                                  num_levels=levels)
    case = dict(x=x, ei=ei, n=n_nodes, levels=levels,
                params=_np_params(params))
    if weighted:
        case["ew"] = np.ones(ei.shape[1], np.float32)
    return case


@pytest.fixture(scope="module")
def world():
    cases = {"forward": {k: _case(n, lv, 7, 0)
                         for k, (n, lv) in FORWARD.items()},
             "grads": _case(256, 1, 9, 1),
             # ratio 0.9 of 6 nodes → k = 6, rounded to 8 > num_valid
             "overbudget": _case(6, 1, 0, 0, p=0.6, features=4,
                                 weighted=True)}
    ranks = spawn_world(pooled_cases, D, "gloo", 120, args=(cases,))
    return cases, ranks


def _jax_sharded(case, ratio=0.5, loss=False):
    """JAX's sharded forward (or the gradient of Σ logits²) on 4 devices."""
    mesh = Mesh(np.array(jax.devices()[:D]), ("gp",))
    n, x = case["n"], case["x"]
    S, R, W, n_pad, rows_per = J.prepare_sharded_graph(
        case["ei"][0], case["ei"][1], case.get("ew"), n, D)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n] = x
    fwd, ks = J.make_sharded_pooled_forward(
        mesh, rows_per=rows_per, n_pad=n_pad, num_valid=n, ratio=ratio,
        num_levels=case["levels"])
    shard = NamedSharding(mesh, P("gp"))
    args = tuple(jax.device_put(v, shard)
                 for v in (jnp.asarray(x_pad), S, R, W))
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    if loss:
        return jax.grad(lambda p: jnp.sum(fwd(p, *args)[0] ** 2))(params), ks
    return fwd(params, *args), ks


def _close_leaves(got, want, what):
    for k in want:
        scale = float(np.abs(np.asarray(want[k])).max()) or 1.0
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"{what} {k}")


def test_prepare_and_level_ks_equal_jax():
    x, ei = erdos_renyi_graph(320, p=0.05, num_features=12, seed=7)
    got = T.prepare_sharded_graph(ei[0], ei[1], None, 320, D, device="cpu")
    ref = J.prepare_sharded_graph(ei[0], ei[1], None, 320, D)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[3:] == ref[3:]
    for args in ((320, 0.5, 2, D), (100, 0.5, 2, 8), (6, 0.9, 1, D)):
        assert T.level_ks(*args) == J.level_ks(*args)


@pytest.mark.parametrize("key", list(FORWARD))
def test_sharded_pooled_forward_matches_reference(world, key):
    cases, ranks = world
    case = cases["forward"][key]
    (jlogits, jh), ks = _jax_sharded(case)
    h = np.concatenate([rk[key]["h"] for rk in ranks])
    for rk in ranks:
        assert tuple(rk[key]["ks"]) == ks
        np.testing.assert_allclose(rk[key]["logits"], np.asarray(jlogits),
                                   **TOL)
        # the port's single-device twin agrees with its sharded forward
        np.testing.assert_allclose(rk[key]["ref_logits"],
                                   np.asarray(jlogits), **TOL)
        np.testing.assert_allclose(rk[key]["ref_h"], np.asarray(jh), **TOL)
    np.testing.assert_allclose(h, np.asarray(jh), **TOL)


def test_scaling_harness_runs(world):
    """Every D up to the world's 4 runs (rank 0 takes part in each); the
    times of CPU ranks are not device numbers."""
    _, ranks = world
    res = ranks[0]["scaling"]
    assert set(res) == {1, 2, 4}
    for rec in res.values():
        assert rec["edges_per_s"] > 0
        assert np.isfinite(rec["seconds_per_step"])
    assert set(ranks[3]["scaling"]) == {4}


def test_sharded_pooled_gradients_match_single_device(world):
    """∂Σlogits²/∂params on 4 ranks (seeded 1/D, summed over the ranks)
    equals JAX's on 4 devices and the port's single-device twin: the
    convention is off by D if any collective's backward slipped."""
    cases, ranks = world
    jgrads, _ = _jax_sharded(cases["grads"], loss=True)
    for rk in ranks:
        _close_leaves(rk["grads"]["grads"], jgrads, "vs JAX")
        _close_leaves(rk["grads"]["grads"], rk["grads"]["ref_grads"],
                      "vs the twin")
        assert rk["grads"]["repeat_equal"]
    for rk in ranks[1:]:
        for k, v in rk["grads"]["grads"].items():
            np.testing.assert_array_equal(v, ranks[0]["grads"]["grads"][k])


def test_overbudget_k_gate_grads_finite(world):
    cases, ranks = world
    case = cases["overbudget"]
    assert tuple(ranks[0]["overbudget"]["ks"]) == J.level_ks(6, 0.9, 1, D)
    assert ranks[0]["overbudget"]["ks"][0] > case["n"]
    jgrads, _ = _jax_sharded(case, ratio=0.9, loss=True)
    for rk in ranks:
        for name, g in rk["overbudget"]["grads"].items():
            assert np.isfinite(g).all(), name
        _close_leaves(rk["overbudget"]["grads"], jgrads, "over budget")


def test_level_ks_validation_and_agreement(world):
    _, ranks = world
    assert "num_levels" in ranks[0]["level_ks_error"]
    with pytest.raises(ValueError, match="num_levels"):
        T.level_ks(64, 0.5, 0, 8)
    assert T.level_ks(100, 0.5, 2, 8) == (56, 32)


def test_init_pooled_params_keys_and_shapes():
    import torch

    got = T.init_pooled_params(torch.Generator().manual_seed(0), 12, 16, 3,
                               num_levels=2, device="cpu")
    ref = J.init_pooled_params(jax.random.key(0), 12, 16, 3, num_levels=2)
    assert list(got) == list(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape and got[k].requires_grad
    assert float(got["W1"].detach().abs().max()) <= np.sqrt(6 / 28)
