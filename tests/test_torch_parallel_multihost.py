"""``tgp_tpu_torch.parallel.multihost`` against ``tgp_tpu``'s, case for case
with ``tests/parallel/test_multihost.py``: the hybrid train step on the
port's 2 × 2 gloo mesh (groups × ranks a group, one world for the file)
against JAX's on a 2 × 2 mesh of its virtual devices and against JAX's
single-device reference of the same math, from the same weights and
graphs.  Loss and post-step weights within rtol = atol = 1e-4; a step
repeated from the same state gives the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.parallel import multihost as J
from tgp_tpu.parallel.pooled_model import (init_pooled_params,
                                           prepare_sharded_graph,
                                           reference_pooled_forward)
from tgp_tpu_torch.parallel import multihost as T
from tgp_tpu_torch.parallel.launch import spawn_world
from tests.torch_parallel_ranks import (failing_rank, multihost_cases,
                                        sleeping_rank)

GROUPS, PER_GROUP = 2, 2
N = 32 * PER_GROUP
TOL = dict(rtol=1e-4, atol=1e-4)


def _graph(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, 4 * n).astype(np.int64)
    r = rng.integers(0, n, 4 * n).astype(np.int64)
    keep = s != r
    s, r = np.concatenate([s[keep], r[keep]]), np.concatenate(
        [r[keep], s[keep]])
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return s, r, x


@pytest.fixture(scope="module")
def setup():
    groups = [_graph(N, seed) for seed in (0, 1)]
    y = np.array([0, 2], np.int32)
    params = init_pooled_params(jax.random.key(1), 8, 16, 3, num_levels=2)
    cases = dict(shape=(GROUPS, PER_GROUP), n=N, groups=groups, y=y,
                 params={k: np.asarray(v) for k, v in params.items()})
    ranks = spawn_world(multihost_cases, GROUPS * PER_GROUP, "gloo", 120,
                        args=(cases,))
    return groups, y, params, ranks


def _jax_hybrid(groups, y, params, tx, steps):
    mesh = J.make_hybrid_mesh(GROUPS, PER_GROUP)
    prepped = [prepare_sharded_graph(s, r, None, N, PER_GROUP)
               for s, r, _ in groups]
    S, R, W, n_pad, rows_per = J.stack_group_graphs(prepped)
    X = jnp.stack([jnp.concatenate([jnp.asarray(x),
                                    jnp.zeros((n_pad - N, x.shape[1]))])
                   for _, _, x in groups])
    step, ks = J.make_hybrid_pooled_train_step(
        mesh, tx, rows_per=rows_per, n_pad=n_pad, num_valid=N, ratio=0.5,
        num_levels=2)
    args = J.device_put_hybrid(mesh, X, S, R, W, jnp.asarray(y))
    opt, losses = tx.init(params), []
    for _ in range(steps):
        params, opt, loss = step(params, opt, *args)
        losses.append(float(loss))
    return losses, params, ks


def test_hybrid_step_matches_reference(setup):
    groups, y, params, ranks = setup
    tx = optax.sgd(1e-2)
    jlosses, jparams, ks = _jax_hybrid(groups, y, params, tx, 1)

    def ref_loss(p):
        ces = []
        for g, (s, r, x) in enumerate(groups):
            # N is a multiple of the group's ranks: no padding rows
            logits, _ = reference_pooled_forward(
                p, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), None, N,
                ks=ks, num_valid=N)
            ces.append(optax.softmax_cross_entropy_with_integer_labels(
                logits[None], jnp.asarray(y)[g][None]).mean())
        return jnp.stack(ces).mean()

    ref_l, ref_g = jax.value_and_grad(ref_loss)(params)
    ref_params = optax.apply_updates(params, tx.update(ref_g,
                                                       tx.init(params))[0])
    for rk in ranks:
        losses, got, got_ks = rk["sgd"]
        assert tuple(got_ks) == ks
        np.testing.assert_allclose(losses[0], float(ref_l), **TOL)
        np.testing.assert_allclose(losses[0], jlosses[0], **TOL)
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(ref_params[k]),
                                       err_msg=k, **TOL)
            np.testing.assert_allclose(got[k], np.asarray(jparams[k]),
                                       err_msg=k, **TOL)
        assert rk["sgd_repeat_equal"]
    assert sorted(rk["coords"] for rk in ranks) == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
    assert all(rk["initialized"] for rk in ranks)


def test_hybrid_two_steps_decrease_loss(setup):
    groups, y, params, ranks = setup
    jlosses, jparams, _ = _jax_hybrid(groups, y, params, optax.adam(5e-3), 3)
    for rk in ranks:
        losses, got, _ = rk["adam"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, jlosses, **TOL)
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(jparams[k]),
                                       err_msg=k, **TOL)


def test_stack_group_graphs_validates_padding():
    a = (torch.zeros((4, 8), dtype=torch.int32),
         torch.zeros((4, 8), dtype=torch.int32), torch.zeros((4, 8)), 128, 32)
    b = (torch.zeros((4, 16), dtype=torch.int32),
         torch.zeros((4, 16), dtype=torch.int32), torch.zeros((4, 16)), 256,
         64)
    with pytest.raises(ValueError):
        T.stack_group_graphs([a, b])
    S, R, W, n_pad, rows_per = T.stack_group_graphs([a, a])
    assert S.shape == (2, 4, 8) and n_pad == 128 and rows_per == 32
    c = (torch.ones((4, 4), dtype=torch.int32),) * 2 + (torch.ones((4, 4)),
                                                        128, 32)
    S, R, W, _, _ = T.stack_group_graphs([a, c])
    assert S.shape == (2, 4, 8) and int(S[1, :, 4:].abs().sum()) == 0


def test_make_hybrid_mesh_validates_count():
    with pytest.raises(ValueError, match="need 64 devices"):
        T.make_hybrid_mesh(4, 16)


def test_initialize_multihost_without_and_with_bad_configuration(
        monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert T.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    # an explicit address must fail loudly (nothing listens on port 1)
    with pytest.raises(Exception):
        T.initialize_multihost("localhost:1", num_processes=2, process_id=1,
                               backend="gloo", timeout_s=3)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        T.initialize_multihost("localhost:1")


def test_spawn_world_raises_on_a_failed_rank_and_on_its_timeout():
    with pytest.raises(RuntimeError, match="rank 1 .* failed(.|\n)*rank one"):
        spawn_world(failing_rank, 2, "gloo", 60)
    with pytest.raises(TimeoutError, match="still running"):
        spawn_world(sleeping_rank, 2, "gloo", 3)
