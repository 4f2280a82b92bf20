"""``tgp_tpu_torch.parallel.dense_pool`` against ``tgp_tpu``'s, case for
case with ``tests/parallel/test_dense_pool_sharded.py``: the port's gloo
world of D = 4 CPU ranks (one world for the file, every case run in it)
against JAX's sharded step on 4 of its 8 virtual devices and JAX's
single-device unbatched forward, on the same numpy graphs and the same
weights (``params_from_flax``).  BNPool takes JAX's per-node draws
(``fold_in(fold_in(key, g), p)``, computed here) in place of the port's
own, and JAX's negatives.

Tolerances are JAX's: pooled values rtol 1e-4 / atol 1e-5, losses rtol
1e-4 / atol 1e-6, gradients rtol 2e-4 / atol 1e-6.  Partitions and
negatives are array-equal; every rank returns the same replicated
values; a repeat gives the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tgp_tpu.graph import from_graphs
from tgp_tpu.parallel import dense_pool as J
from tgp_tpu.parallel.train import make_mesh
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.parallel import dense_pool as T
from tgp_tpu_torch.parallel.launch import spawn_world
from tgp_tpu_torch.poolers import get_pooler as t_get
from tests.torch_parallel_ranks import dense_pool_cases

D = 4
VALUES = dict(rtol=1e-4, atol=1e-5)
LOSSES = dict(rtol=1e-4, atol=1e-6)
GRADS = dict(rtol=2e-4, atol=1e-6)

#: JAX's eight ``test_sharded_matches_unbatched`` cases
CASES = {
    "mincut": ("mincut", {}),
    "diff": ("diff", {}),
    "dmon": ("dmon", {}),
    "hosc": ("hosc", {}),
    "hosc_alpha0": ("hosc", {"alpha": 0.0}),
    "hosc_ortho": ("hosc", {"hosc_ortho": True}),
    "jb": ("jb", {}),
    "acc": ("acc", {}),
}


def _random_graph(n, e, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int64)
    r = rng.integers(0, n, e).astype(np.int64)
    keep = s != r
    s, r = (np.concatenate([s[keep], r[keep]]),
            np.concatenate([r[keep], s[keep]]))
    w = rng.uniform(0.5, 1.5, len(s)).astype(np.float32)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    return x, s, r, w


def _flat(x, s, r, w, n_pad):
    return from_graphs([(x, np.stack([s, r]), w)], pad_nodes=n_pad,
                       pad_edges=len(s))


def _state(params):
    """A flax pooler tree as the port pooler's ``state_dict`` (numpy)."""
    sd = params_from_flax({"pooler": params["params"]})
    return {k[len("pooler."):]: v.numpy() for k, v in sd.items()}


def _case(alias, kw, n, e, seed, k=4, keys=None):
    """One case: JAX's pooler and weights on a random graph, and the
    port's keywords for the same pooler."""
    x, s, r, w = _random_graph(n, e, seed)
    pooler = j_get(alias, k=k, batched=False, **dict(
        {"in_channels": 6}, **kw))
    n_pad = -(-n // D) * D
    batch = _flat(x, s, r, w, n_pad)
    params = pooler.init(jax.random.key(3) if keys is None else keys, batch)
    port = (alias, dict({"in_channels": 6}, k=k, **kw), _state(params),
            (x, s, r, w, n))
    return dict(pooler=pooler, params=params, batch=batch,
                graph=(x, s, r, w, n), port=port)


def _jax_draws(pooler, params, batch, key):
    """JAX's per-node Gamma draws of BNPool's selector: its own
    ``fold_in(fold_in(key, g), p)`` scheme on the key its ``make_rng``
    hands the selector, as two ``[N, K − 1]`` tables by node."""
    rngs = {"sample": key}
    kk = pooler.apply(params, batch, rngs=rngs,
                      method=lambda m, b: m.selector.make_rng("sample"))
    so = pooler.apply(params, batch, rngs=rngs,
                      method=lambda m, b: m.selector(b))

    def draw(g, p, a, b):
        k2 = jax.random.fold_in(jax.random.fold_in(kk, g), p)
        k_a, k_b = jax.random.split(k2)
        return jax.random.gamma(k_a, a), jax.random.gamma(k_b, b)

    g1, g2 = jax.vmap(draw)(batch.node_graph.astype(jnp.uint32),
                            batch.node_pos.astype(jnp.uint32),
                            so.extras["q_alpha"], so.extras["q_beta"])
    return np.asarray(g1), np.asarray(g2)


@pytest.fixture(scope="module")
def cases():
    forward = {name: _case(alias, kw, 48, 160, 11)
               for name, (alias, kw) in CASES.items()}
    forward["diff_normalized"] = _case("diff", {"normalize_loss": True}, 40,
                                       120, 5, k=3)
    bn = _case("bnpool", {"per_node_keys": True}, 48, 160, 23,
               keys={"params": jax.random.key(3),
                     "sample": jax.random.key(0)})
    bn["key"] = jax.random.PRNGKey(11)
    bn["draws"] = _jax_draws(bn["pooler"], bn["params"], bn["batch"],
                             bn["key"])
    return dict(forward=forward, bnpool=bn,
                grads=_case("mincut", {}, 32, 96, 7),
                dropout=_case("mincut", {"in_channels": [6, 8],
                                         "dropout": 0.5}, 48, 160, 13))


@pytest.fixture(scope="module")
def world(cases):
    bn = cases["bnpool"]
    payload = dict(
        forward={name: c["port"] for name, c in cases["forward"].items()},
        grads=cases["grads"]["port"],
        bnpool=bn["port"] + (7, bn["draws"]),
        dropout=cases["dropout"]["port"])
    return spawn_world(dense_pool_cases, D, "gloo", 120, args=(payload,))


def _jax_sharded(case, *extra, rng=None):
    """JAX's sharded step on 4 of the virtual devices."""
    x, s, r, w, n = case["graph"]
    x_pad, mask, S, R, W, n_pad, rows_per = J.prepare_sharded_dense_graph(
        x, s, r, w, n, D)
    mesh = make_mesh(D, axis="n")
    step = J.make_sharded_dense_pool_step(case["pooler"], mesh, rows_per,
                                          axis="n")
    with mesh:
        args = J.device_put_sharded_dense(mesh, x_pad, mask, S, R, W,
                                          axis="n")
        if rng is None:
            return step(case["params"], *args)
        return step(rng, case["params"], *args, *extra)


def _check_values(got, x_pool, adj_pool, losses, what):
    np.testing.assert_allclose(got["x_pool"], np.asarray(x_pool), **VALUES,
                               err_msg=what)
    np.testing.assert_allclose(got["adj_pool"], np.asarray(adj_pool),
                               **VALUES, err_msg=what)
    assert set(got["losses"]) == set(losses), what
    for name, v in losses.items():
        np.testing.assert_allclose(got["losses"][name], float(v), **LOSSES,
                                   err_msg=f"{what} {name}")


def _check_replicated(ranks, key):
    for rk in ranks[1:]:
        np.testing.assert_array_equal(rk[key]["x_pool"],
                                      ranks[0][key]["x_pool"])
        np.testing.assert_array_equal(rk[key]["adj_pool"],
                                      ranks[0][key]["adj_pool"])
        assert rk[key]["losses"] == ranks[0][key]["losses"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_unbatched(cases, world, name):
    """Each alias's sharded forward at D = 4 equals JAX's single-device
    unbatched forward and JAX's sharded step (same weights), and the
    port's own single-device forward; a repeat is bit-equal."""
    case = cases["forward"][name]
    ref = case["pooler"].apply(case["params"], case["batch"])
    jx, ja, jl = _jax_sharded(case)
    for rk in world:
        got = rk[name]
        _check_values(got, ref.dense.x[0], ref.dense.adj[0], ref.loss,
                      f"{name} vs JAX single-device")
        _check_values(got, jx, ja, jl, f"{name} vs JAX sharded")
        _check_values(got, got["ref"]["x_pool"], got["ref"]["adj_pool"],
                      got["ref"]["losses"], f"{name} vs the port's own")
        assert got["repeat_equal"], name
    _check_replicated(world, name)


def test_sharded_diff_normalized_loss(cases, world):
    case = cases["forward"]["diff_normalized"]
    ref = case["pooler"].apply(case["params"], case["batch"])
    for rk in world:
        np.testing.assert_allclose(rk["diff_normalized"]["losses"]
                                   ["link_loss"],
                                   float(ref.loss["link_loss"]), rtol=1e-4,
                                   atol=1e-8)


def test_sharded_gradients_match_unbatched(cases, world):
    """d(cut + ortho)/d(selector) at D = 4, seeded 1/D and summed over the
    ranks, equals JAX's single-device gradient and the port's; a repeat
    gives the same bits on every rank."""
    case = cases["grads"]
    pooler, batch = case["pooler"], case["batch"]

    def ref_loss(p):
        out = pooler.apply(p, batch)
        return out.loss["cut_loss"] + out.loss["ortho_loss"]

    want = _state(jax.grad(ref_loss)(case["params"]))
    for rk in world:
        got = rk["grads"]
        assert set(got["grads"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["grads"][k], v, **GRADS,
                                       err_msg=k)
            np.testing.assert_allclose(got["grads"][k], got["ref_grads"][k],
                                       **GRADS, err_msg=f"{k} vs the port")
        assert got["repeat_equal"]
    for rk in world[1:]:
        for k, v in rk["grads"]["grads"].items():
            np.testing.assert_array_equal(v, world[0]["grads"]["grads"][k])


def test_supported_list_and_rejection():
    assert T.supported_sharded_poolers() == J.supported_sharded_poolers()
    # the checks come before the mesh is read
    with pytest.raises(NotImplementedError):
        T.make_sharded_dense_pool_step(t_get("lap", device="cpu"), None,
                                       rows_per=8, axis="n")
    batched = t_get("mincut", in_channels=6, k=4, device="cpu")
    with pytest.raises(AssertionError):
        T.make_sharded_dense_pool_step(batched, None, rows_per=8, axis="n")
    keyless = t_get("bnpool", in_channels=6, k=4, batched=False,
                    device="cpu")
    with pytest.raises(AssertionError, match="per_node_keys"):
        T.make_sharded_dense_pool_step(keyless, None, rows_per=8, axis="n")


def test_sharded_bnpool_matches_unbatched(cases, world):
    """BNPool at D = 4 on JAX's per-node draws and negatives equals JAX's
    single-device forward (same params, key and negatives) and JAX's
    sharded step; on the port's own keyed draws it equals the port's
    single-device forward given the same base seed."""
    bn = cases["bnpool"]
    x, s, r, w, n = bn["graph"]
    NS, NR, NM, flat_neg = J.prepare_sharded_negatives(7, s, r, n, D)
    ref = bn["pooler"].apply(bn["params"], bn["batch"], negatives=flat_neg,
                             rngs={"sample": bn["key"]})
    jx, ja, jl = _jax_sharded(bn, NS, NR, NM, rng=bn["key"])
    for rk in world:
        got = rk["bnpool"]
        _check_values(got, ref.dense.x[0], ref.dense.adj[0], ref.loss,
                      "bnpool vs JAX single-device")
        _check_values(got, jx, ja, jl, "bnpool vs JAX sharded")
        _check_values(got, got["ref"]["x_pool"], got["ref"]["adj_pool"],
                      got["ref"]["losses"], "bnpool vs the port's own")
        assert got["repeat_equal"]
        own = rk["bnpool_own"]
        _check_values(own, own["ref"]["x_pool"], own["ref"]["adj_pool"],
                      own["ref"]["losses"], "bnpool, the port's draws")
    _check_replicated(world, "bnpool")


def test_sharded_dropout_training_mode(world):
    """``deterministic=False``: the same seed gives the same bits,
    another seed other assignments, and the selector's mode is restored
    after the call."""
    for rk in world:
        a, b, c = rk["dropout"]
        np.testing.assert_array_equal(a, b)
        assert not np.allclose(a, c)
        assert not np.allclose(a, rk["dropout_off"])
        assert rk["selector_training_restored"]


def test_prepared_arrays_equal_jax():
    x, s, r, w = _random_graph(50, 170, 2)
    got = T.prepare_sharded_dense_graph(x, s, r, w, 50, D, device="cpu")
    ref = J.prepare_sharded_dense_graph(x, s, r, w, 50, D)
    for a, b in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[5:] == ref[5:]
    for num in (None, 37):
        got = T.prepare_sharded_negatives(9, s, r, 50, D, num, device="cpu")
        ref = J.prepare_sharded_negatives(9, s, r, 50, D, num)
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype
        for a, b in zip(got[3], ref[3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_carried_weights_give_jax_bnpool_draws_and_state_keys(cases):
    """The carried state covers the port pooler exactly, and the draws
    handed to the ranks reproduce JAX's own sample ``s``."""
    from tgp_tpu.select.dp import stick_breaking

    bn = cases["bnpool"]
    alias, kw, state, _ = bn["port"]
    port = t_get(alias, batched=False, device="cpu", **kw)
    assert set(port.state_dict()) == set(state)
    g1, g2 = (jnp.asarray(t) for t in bn["draws"])
    z = jnp.clip(g1 / jnp.clip(g1 + g2, 1e-12, None), 1e-6, 1 - 1e-6)
    so = bn["pooler"].apply(bn["params"], bn["batch"],
                            rngs={"sample": bn["key"]},
                            method=lambda m, b: m.selector(b))
    np.testing.assert_array_equal(np.asarray(stick_breaking(z) *
                                             bn["batch"].node_mask[:, None]),
                                  np.asarray(so.s))
