"""BNPool in the port (``select/dp.py``, ``poolers/bnpool.py``) against
the JAX package on the same numpy graphs and converted parameters.

JAX's Gamma draws are recorded (``jax.random.gamma`` wrapped) and handed
to the port in place of its own (``dp.draw_gamma`` replaced), and the
unbatched loss takes JAX's negatives, so both packages compute the same
function: the stick-breaking weights, the selection, the pooled values,
the three losses and every gradient (``K``'s too).

Tolerances: values 1e-5 of each output's largest |value| (at least 1),
f32 sums in other orders; the Gamma gradient 1e-3 relative (JAX's and
torch's series for ``d sample / d α`` agree to about 4 digits), and so
every gradient that flows through it 1e-3 of its leaf's largest |value|
(at least 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils_graphs import erdos_renyi_graph
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.prepare import prepare_batch as j_prepare
from tgp_tpu.ops.sampling import negative_edge_sampling as j_negatives
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.select.dp import stick_breaking as j_stick
from tgp_tpu_torch import get_pooler, prepare_batch
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.poolers import BNPool
from tgp_tpu_torch.select import dp as dp_mod

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN, K = 7, 5
#: the tolerance of a gradient through the Gamma draws (see above)
GRAD = 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel=1e-5, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
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


@pytest.fixture(scope="module")
def batches():
    graphs = _graphs()
    kw = dict(pad_nodes=32, pad_edges=160)
    jb, tb = j_from(graphs, **kw), t_from(graphs, **kw, **CPU)
    return dict(jb=jb, tb=tb, jd=j_prepare(jb, densify=True),
                td=prepare_batch(tb, densify=True))


@pytest.fixture(scope="module")
def jax_params(batches):
    """A flax init (both modes share the shapes), perturbed."""
    p = j_get("bnpool", in_channels=F_IN, k=K).init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        batches["jd"])
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(2)
    return jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                    .astype(np.float32)) for v in leaves])


def _carry(tree):
    sd = params_from_flax({"pooler": tree["params"]})
    return {k[len("pooler."):]: v for k, v in sd.items()}


@pytest.fixture
def jax_draws(monkeypatch):
    """Every ``jax.random.gamma`` sample made while the fixture is live,
    in order (concrete calls only)."""
    seen = []
    real = jax.random.gamma

    def gamma(key, a, *args, **kw):
        out = real(key, a, *args, **kw)
        if not isinstance(out, jax.core.Tracer):
            seen.append(torch.tensor(np.asarray(out)))
        return out

    monkeypatch.setattr(jax.random, "gamma", gamma)
    return seen


def _replay(monkeypatch, draws):
    """The port's Gamma draws become ``draws``, in order, every forward."""
    calls = []

    def draw(alpha, generator):
        out = draws[len(calls) % len(draws)]
        calls.append(1)
        assert out.shape == alpha.shape
        return out

    monkeypatch.setattr(dp_mod, "draw_gamma", draw)
    return calls


def _probe(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_stick_breaking_matches_jax():
    z = np.random.default_rng(0).uniform(1e-7, 1 - 1e-7, (6, 4, K - 1))
    z = z.astype(np.float32)
    z[0, 0] = [0.0, 1.0, 0.5, 1e-9]
    got = dp_mod.stick_breaking(torch.tensor(z))
    _close(got, j_stick(jnp.asarray(z)))
    np.testing.assert_allclose(_np(got).sum(-1)[1:], 1.0, rtol=1e-5)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 3.0, 10.0])
def test_gamma_gradient_matches_jax(alpha):
    """On JAX's draws, the port's reparameterised gradient ``d sample / d
    α`` equals JAX's (``jax.random.gamma``'s implicit gradient)."""
    a = jnp.full((64,), alpha, jnp.float32)
    key = jax.random.key(3)
    draws = jax.random.gamma(key, a)
    j_grad = jax.grad(lambda v: jax.random.gamma(key, v).sum())(a)
    np.testing.assert_allclose(
        _np(j_grad), _np(jax.lax.random_gamma_grad(a, draws)), rtol=1e-6)
    ta = torch.tensor(np.asarray(a), requires_grad=True)
    g = dp_mod._GammaSample.apply(ta, torch.tensor(np.asarray(draws)))
    assert torch.equal(g.detach(), torch.tensor(np.asarray(draws)))
    g.sum().backward()
    np.testing.assert_allclose(_np(ta.grad), _np(j_grad), rtol=1e-3)


def test_gamma_draws_follow_the_generator():
    """Draws come from the generator: the same seed, the same draws."""
    a = torch.full((100,), 2.0)
    d1 = dp_mod.draw_gamma(a, torch.Generator().manual_seed(4))
    d2 = dp_mod.draw_gamma(a, torch.Generator().manual_seed(4))
    d3 = dp_mod.draw_gamma(a, torch.Generator().manual_seed(5))
    assert torch.equal(d1, d2) and not torch.equal(d1, d3)
    assert (d1 > 0).all() and abs(float(d1.mean()) - 2.0) < 0.5


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "u"])
def test_dp_select_matches_jax_on_its_draws(batched, batches, jax_params,
                                            jax_draws, monkeypatch):
    """DPSelect on JAX's draws: ``s``, the posterior parameters, and the
    gradients of ⟨G, s⟩ for the MLP and the input features."""
    from tgp_tpu.select.dp import DPSelect as JDP

    jin = batches["jd"] if batched else batches["jb"]
    tin = batches["td"] if batched else batches["tb"]
    jsel = JDP(in_channels=F_IN, k=K, batched=batched)
    jp = {"params": jax_params["params"]["selector"]}
    key = {"sample": jax.random.key(7)}
    jso = jsel.apply(jp, jin, rngs=key)
    assert len(jax_draws) == 2
    G = _probe(jso.s.shape, 1)

    def obj(q, x):
        return jnp.sum(jsel.apply(q, jin.replace(x=x), rngs=key).s * G)

    jg_p, jg_x = jax.grad(obj, argnums=(0, 1))(jp, jin.x)
    _replay(monkeypatch, list(jax_draws))
    tsel = dp_mod.DPSelect(F_IN, K, batched=batched, **CPU)
    tsel.load_state_dict({k[len("selector."):]: v for k, v in _carry(
        jax_params).items() if k.startswith("selector.")})
    x = tin.x.clone().requires_grad_(True)
    tso = tsel(tin.replace(x=x))
    _close(tso.s, jso.s, what="s")
    for name in ("q_alpha", "q_beta"):
        _close(tso.extras[name], jso.extras[name], what=name)
    (tso.s * torch.tensor(G)).sum().backward()
    _close(x.grad, jg_x, GRAD, what="d x")
    got = dict(tsel.named_parameters())
    for k, v in _carry({"params": {"selector": jg_p["params"]}}).items():
        _close(got[k[len("selector."):]].grad, v, GRAD, what=f"d {k}")


def _pair(batched, jax_params, **kw):
    jp = j_get("bnpool", in_channels=F_IN, k=K, batched=batched, **kw)
    tp = get_pooler("bnpool" if batched else "bnpool_u", in_channels=F_IN,
                    k=K, **kw, **CPU)
    assert isinstance(tp, BNPool) and tp.batched == batched
    tp.load_state_dict(_carry(jax_params))
    return jp, tp


@pytest.mark.parametrize("train_K", [True, False], ids=["K", "frozen_K"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "u"])
def test_bnpool_matches_jax(batched, train_K, batches, jax_params,
                            jax_draws, monkeypatch):
    """Given JAX's draws (and negatives, unbatched): pooled x, adjacency
    and mask, the three losses, and the gradients of Σ losses + ⟨G, x'⟩ +
    ⟨H, A'⟩ for every parameter (``K`` too, none with ``train_K=False``)
    and the input features."""
    jp, tp = _pair(batched, jax_params, train_K=train_K)
    jin = batches["jd"] if batched else batches["jb"]
    tin = batches["td"] if batched else batches["tb"]
    kw = {}
    if not batched:
        neg = j_negatives(jax.random.key(11), batches["jb"])
        kw = dict(negatives=neg)
        t_neg = tuple(torch.tensor(np.asarray(a)) for a in neg)
    rng = {"sample": jax.random.key(5)}
    jout = jp.apply(jax_params, jin, rngs=rng, **kw)
    draws = list(jax_draws)
    assert len(draws) == 2
    G = _probe(jout.dense.x.shape, 1)
    H = _probe(jout.dense.adj.shape, 2)

    def j_obj(q, x):
        o = jp.apply(q, jin.replace(x=x), rngs=rng, **kw)
        return (o.loss_sum() + jnp.sum(o.dense.x * G)
                + jnp.sum(o.dense.adj * H))

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(jax_params, jin.x)
    _replay(monkeypatch, draws)
    x = tin.x.clone().requires_grad_(True)
    tout = tp(tin.replace(x=x), **({} if batched else dict(negatives=t_neg)))
    for f in ("x", "adj"):
        _close(getattr(tout.dense, f), getattr(jout.dense, f), what=f)
    np.testing.assert_array_equal(_np(tout.dense.mask),
                                  _np(jout.dense.mask))
    assert set(tout.loss) == set(jout.loss) == {"quality", "kl", "K_prior"}
    for name, v in jout.loss.items():
        _close(tout.loss[name], v, what=name)
    (tout.loss_sum() + (tout.dense.x * torch.tensor(G)).sum()
     + (tout.dense.adj * torch.tensor(H)).sum()).backward()
    _close(x.grad, jg_x, GRAD, what="d x")
    got = dict(tp.named_parameters())
    for k, v in _carry(jg_p).items():
        if k == "K" and not train_K:
            assert got[k].grad is None and not got[k].requires_grad
            np.testing.assert_array_equal(_np(v), 0.0)
            continue
        assert torch.isfinite(got[k].grad).all(), k
        _close(got[k].grad, v, GRAD, what=f"d {k}")


def test_batched_and_unbatched_pool_the_same_graph(batches, jax_params,
                                                   monkeypatch):
    """The two modes on the same draws (the dense draws read at each
    node's cell for the flat layout): the same pooled features and
    adjacency within 5e-4, the contract of the dense family.  The losses
    are not compared: the batched ones normalize by N² over every pair,
    the unbatched ones by the sampled pairs."""
    _, tb_pool = _pair(True, jax_params)
    _, tu_pool = _pair(False, jax_params)
    td, tb = batches["td"], batches["tb"]
    gen = torch.Generator().manual_seed(8)
    dense = [torch.rand(td.num_graphs, td.max_nodes, K - 1, generator=gen)
             * 3 + 0.1 for _ in range(2)]
    cells = (tb.node_graph.long() * td.max_nodes + tb.node_pos.long())
    flat = [d.reshape(-1, K - 1)[cells] for d in dense]
    _replay(monkeypatch, dense)
    ob = tb_pool(td)
    _replay(monkeypatch, flat)
    ou = tu_pool(tb)
    for f in ("x", "adj", "mask"):
        np.testing.assert_allclose(_np(getattr(ob.dense, f)),
                                   _np(getattr(ou.dense, f)),
                                   rtol=5e-4, atol=5e-4, err_msg=f)


def test_empty_padded_graph_stays_finite(jax_params):
    """A batch whose last graph has no node: every loss and gradient is
    finite in both modes (the clipped N² and per-graph counts)."""
    graphs = _graphs()
    kw = dict(pad_nodes=32, pad_edges=160)
    tb = t_from(graphs + [(np.zeros((0, F_IN), np.float32),
                           np.zeros((2, 0), np.int64))], **kw, **CPU)
    for batched in (True, False):
        _, tp = _pair(batched, jax_params,
                      sample_generator=torch.Generator().manual_seed(0))
        tin = prepare_batch(tb, densify=True) if batched else tb
        out = tp(tin)
        total = out.loss_sum()
        assert torch.isfinite(total), batched
        total.backward()
        for k, p in tp.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), k


def test_bnpool_draws_from_its_sample_generator(batches, jax_params):
    """Same generator seed, same selection; another seed, another; the
    unbatched negatives come from it too."""
    def run(seed, batched):
        _, tp = _pair(batched, jax_params,
                      sample_generator=torch.Generator().manual_seed(seed))
        tin = batches["td"] if batched else batches["tb"]
        with torch.no_grad():
            out = tp(tin)
        return out.so.s, out.loss["quality"]

    for batched in (True, False):
        a, b, c = run(1, batched), run(1, batched), run(2, batched)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])


def test_per_node_keys_points_at_the_roadmap():
    """``per_node_keys`` is ported (``ROADMAP.md`` queued it): the pooler
    builds, its selector keys each node's draws by (graph, position), and
    a forward on the same base seed repeats bit for bit (the keyed draws
    themselves: ``tests/test_torch_dp_keys.py``)."""
    pool = get_pooler("bnpool_u", in_channels=F_IN, k=K, per_node_keys=True,
                      **CPU)
    assert pool.selector.per_node_keys
    tb = t_from(_graphs(), pad_nodes=32, pad_edges=160, **CPU)
    with torch.no_grad():
        a = pool.selector(tb, sample_seed=2).s
        b = pool.selector(tb, sample_seed=2).s
        c = pool.selector(tb, sample_seed=3).s
    assert torch.equal(a, b) and not torch.equal(a, c)
