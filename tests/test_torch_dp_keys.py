"""``DPSelect(per_node_keys=True)`` in the port (``select/dp.py``): the
counter-based per-node Gamma draws (Philox-4x32-10 over (position, graph,
column, stream, round), Marsaglia–Tsang) against the properties JAX's
``fold_in(fold_in(key, g), p)`` draws have, and the port's selector
against JAX's when it is handed JAX's per-node draws.

Tolerances: ``s`` across layouts rtol 1e-6 / atol 1e-7 (JAX's layout
test; the MLP runs on other shapes); the Gamma gradient rtol 1e-3 (JAX's
and torch's series for ``d sample / d α`` agree to about 4 digits, as in
``test_torch_bnpool.py``); on JAX's draws, ``s`` within 1e-5 of its
largest value.  The KS tests draw 20,000 samples a shape from a fixed
seed and ask for a p-value above 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tgp_tpu.graph import from_graphs as j_from, to_dense as j_dense
from tgp_tpu.select.dp import DPSelect as JDP
from tgp_tpu_torch.graph import from_graphs as t_from, to_dense as t_dense
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.select import dp

torch.set_num_threads(1)
LAYOUT = dict(rtol=1e-6, atol=1e-7)


def _graphs(seed=3, sizes=(5, 3, 7)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.normal(size=(n, 4)).astype(np.float32)
        s = rng.integers(0, n, 2 * n)
        r = rng.integers(0, n, 2 * n)
        out.append((x, np.stack([s, r])))
    return out


def _selector(batched, seed=0):
    return dp.DPSelect(4, k=3, batched=batched, per_node_keys=True,
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _shared(flat_sel, dense_sel):
    dense_sel.load_state_dict(flat_sel.state_dict())
    return dense_sel


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox-4x32-10."""
    vectors = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in vectors:
        got = dp.philox4x32(*(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(g) for g in got) == want


def test_flat_and_batched_layouts_draw_identical_s():
    """The batched ``[B, N]`` and flat layouts draw the same sticks for
    the same (graph, position), as JAX's
    ``test_dp_select_per_node_keys_layout_invariant`` asks."""
    flat = t_from(_graphs(), device="cpu")
    dense = t_dense(flat)
    sel_f = _selector(False)
    sel_d = _shared(sel_f, _selector(True))
    with torch.no_grad():
        sf = sel_f(flat, sample_seed=5).s.numpy()
        sd = sel_d(dense, sample_seed=5).s.numpy()
    ng, pos = flat.node_graph.numpy(), flat.node_pos.numpy()
    for i in np.nonzero(flat.node_mask.numpy())[0]:
        np.testing.assert_allclose(sf[i], sd[ng[i], pos[i]], **LAYOUT)


def test_same_node_draws_the_same_shuffled_or_sharded():
    """A node's draws depend on its identity only: shuffling the rows of a
    flat batch permutes the draws with them, and drawing a block of rows
    alone (one rank's shard, global positions) gives that block's draws."""
    n, width = 50, 6
    rng = np.random.default_rng(0)
    alpha = torch.tensor(rng.uniform(0.2, 5.0, (n, width)))
    graph = torch.tensor(rng.integers(0, 3, n))
    pos = torch.arange(n)
    full = dp.draw_gamma_keyed(alpha, 9, graph, pos, 1)
    perm = torch.tensor(rng.permutation(n))
    shuffled = dp.draw_gamma_keyed(alpha[perm], 9, graph[perm], pos[perm],
                                   1)
    assert torch.equal(shuffled, full[perm])
    for lo, hi in ((0, 13), (13, 26), (26, 50)):
        block = dp.draw_gamma_keyed(alpha[lo:hi], 9, graph[lo:hi],
                                    pos[lo:hi], 1)
        assert torch.equal(block, full[lo:hi])
    other = dp.draw_gamma_keyed(alpha, 9, graph, pos, 0)
    assert not torch.equal(other, full)
    assert not torch.equal(dp.draw_gamma_keyed(alpha, 10, graph, pos, 1),
                           full)


@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.0])
def test_keyed_draws_follow_the_gamma_law(alpha):
    """A KS test of 20,000 keyed draws against ``scipy.stats.gamma``."""
    m = 20_000
    g = dp.draw_gamma_keyed(torch.full((m, 1), alpha), 2024,
                            torch.zeros(m, dtype=torch.int64),
                            torch.arange(m), 0)
    assert g.dtype == torch.float32 and bool((g > 0).all())
    assert stats.kstest(g[:, 0].numpy().astype(np.float64),
                        stats.gamma(alpha).cdf).pvalue > 1e-3


@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.0])
def test_gradient_in_alpha_matches_jax(alpha):
    """On the keyed draws, the reparameterised gradient ``d sample / d α``
    equals ``jax.lax.random_gamma_grad``."""
    m = 256
    a = torch.full((m, 1), alpha, requires_grad=True)
    draws = dp.draw_gamma_keyed(a, 5, torch.zeros(m, dtype=torch.int64),
                                torch.arange(m), 1)
    dp._GammaSample.apply(a, draws).sum().backward()
    want = jax.lax.random_gamma_grad(jnp.full((m, 1), alpha, jnp.float32),
                                     jnp.asarray(draws.numpy()))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=1e-3)


def test_base_seed_comes_from_the_sample_generator():
    """Without ``sample_seed`` the base seed is drawn from
    ``sample_generator``: the same state gives the same draws, another
    state others; a given ``sample_seed`` reads no generator."""
    flat = t_from(_graphs(), device="cpu")
    sel = _selector(False)

    def run(gen_seed, **kw):
        sel.sample_generator = torch.Generator().manual_seed(gen_seed)
        with torch.no_grad():
            return sel(flat, **kw).s

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, sample_seed=4), run(2, sample_seed=4))


def test_a_lane_left_unaccepted_raises(monkeypatch):
    monkeypatch.setattr(dp, "GAMMA_ROUNDS", 0)
    with pytest.raises(RuntimeError, match="still rejected"):
        dp.draw_gamma_keyed(torch.ones(3, 2), 0, torch.zeros(3),
                            torch.arange(3), 0)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "flat"])
def test_dp_select_matches_jax_on_its_per_node_draws(batched, monkeypatch):
    """The port's selector, handed JAX's per-node draws (its own
    ``fold_in(fold_in(key, g), p)`` scheme, computed here on the port's
    α), gives JAX's ``DPSelect(per_node_keys=True)``'s ``s``."""
    graphs = _graphs(4)
    jflat = j_from(graphs)
    jin = j_dense(jflat) if batched else jflat
    jsel = JDP(in_channels=4, k=3, batched=batched, per_node_keys=True)
    params = jsel.init({"params": jax.random.key(0),
                        "sample": jax.random.key(1)}, jin)
    key = jax.random.PRNGKey(5)
    kk = jsel.apply(params, jin, rngs={"sample": key},
                    method=lambda m, b: m.make_rng("sample"))

    def jax_draws(alpha, seed, graph, pos, stream):
        def draw(g, p, a):
            k2 = jax.random.fold_in(jax.random.fold_in(kk, g), p)
            return jax.random.gamma(jax.random.split(k2)[stream], a)

        return torch.tensor(np.asarray(jax.vmap(draw)(
            jnp.asarray(graph.numpy(), jnp.uint32),
            jnp.asarray(pos.numpy(), jnp.uint32),
            jnp.asarray(alpha.numpy()))))

    monkeypatch.setattr(dp, "draw_gamma_keyed", jax_draws)
    sd = params_from_flax({"pooler": {"selector": params["params"]}})
    sel = dp.DPSelect(4, k=3, batched=batched, per_node_keys=True,
                      device="cpu")
    sel.load_state_dict({k[len("pooler.selector."):]: v
                         for k, v in sd.items()})
    tflat = t_from(graphs, device="cpu")
    with torch.no_grad():
        got = sel(t_dense(tflat) if batched else tflat).s.numpy()
    want = np.asarray(jsel.apply(params, jin, rngs={"sample": key}).s)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("alias", ["bnpool", "bnpool_u"])
def test_bnpool_with_per_node_keys_runs_on_both_layouts(alias):
    """``BNPool(per_node_keys=True)`` builds and runs batched and ``_u``:
    finite losses, the same bits again for the same base seed."""
    flat = t_from(_graphs(), device="cpu")
    gen = torch.Generator()
    pool = get_pooler(alias, in_channels=4, k=3, per_node_keys=True,
                      device="cpu",
                      generator=torch.Generator().manual_seed(0),
                      sample_generator=gen)
    assert pool.selector.per_node_keys
    with torch.no_grad():  # the generator draws _u's negatives
        a = pool(flat, sample_seed=3)
        gen.manual_seed(1)
        a = pool(flat, sample_seed=3)
        gen.manual_seed(1)
        b = pool(flat, sample_seed=3)
    for name, v in a.loss.items():
        assert torch.isfinite(v).all(), name
        assert torch.equal(v, b.loss[name]), name
    assert torch.equal(a.so.s, b.so.s)
