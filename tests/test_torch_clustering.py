"""The clustering and autoencoder models of the port against
``tgp_tpu``'s, through :func:`~tgp_tpu_torch.models.convert.
params_from_flax`: ``ClusteringModel`` (GCN and GTV layers; MinCut batched
and ``_u``, AsymCheegerCut) and ``PoolLiftNodeClassifier`` (top-k, MinCut)
on the same two-graph CSBM batch: ``s``, logits, every loss and every
parameter's gradient, then one Adam step against optax; ``nmi_score`` in
numpy against the scikit-learn one JAX calls; and the dense lift's
re-pack, whose gradient adds no floats.

Tolerances: values and losses within 1e-4 of their largest |value|
(relative), gradients within 1e-4 of each leaf's largest |value| (f32
sums in other orders), the parameters after one Adam step within 1e-2 of
the learning rate (a first Adam step moves every leaf by about the
rate), NMI within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tests.float_scatter_spy import spy_with_k4_paused
from tgp_tpu.datasets.csbm import CSBMDataset as JCSBM
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.autoencoder import PoolLiftNodeClassifier as JPL
from tgp_tpu.models.clustering import ClusteringModel as JCM
from tgp_tpu.models.clustering import nmi_score as j_nmi
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu_torch.graph import from_graphs as t_from
from tgp_tpu_torch.models.autoencoder import PoolLiftNodeClassifier
from tgp_tpu_torch.models.clustering import ClusteringModel, nmi_score
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops import segment as seg
from tgp_tpu_torch.poolers import get_pooler

torch.set_num_threads(1)
CPU = dict(device="cpu")
F_IN, HIDDEN, K_CL, CLASSES = 8, 16, 3, 3
LR = 5e-3


@pytest.fixture(scope="module")
def data():
    ds = JCSBM(num_graphs=2, num_nodes=30, num_communities=3, p_in=0.35,
               p_out=0.05, feature_dim=F_IN, seed=1)
    graphs = [(x, ei) for x, ei, _ in ds.samples]
    kw = dict(pad_nodes=64, pad_edges=512)
    labels = np.concatenate([c for _, _, c in ds.samples])
    y = np.zeros(64, np.int32)
    y[:labels.size] = labels
    train = np.zeros(64, bool)
    train[:labels.size] = np.random.default_rng(0).random(labels.size) < 0.5
    return dict(jb=j_from(graphs, **kw), tb=t_from(graphs, **kw, **CPU),
                y=y, train=train)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0,
                               err_msg=what)


def _models(kind, mp_or_alias, alias=None):
    """A flax model and the port's twin (its pooler alias from ``alias``
    for the clustering model)."""
    if kind == "cluster":
        jm = JCM(pooler=j_get(alias, in_channels=HIDDEN, k=K_CL),
                 hidden=HIDDEN, mp_type=mp_or_alias)
        tm = ClusteringModel(get_pooler(alias, in_channels=HIDDEN, k=K_CL,
                                        **CPU),
                             hidden=HIDDEN, mp_type=mp_or_alias,
                             in_channels=F_IN, **CPU)
    else:
        kw = dict(in_channels=HIDDEN, ratio=0.5, k=8)
        jm = JPL(pooler=j_get(mp_or_alias, **kw), num_classes=CLASSES,
                 hidden=HIDDEN)
        tm = PoolLiftNodeClassifier(get_pooler(mp_or_alias, **kw, **CPU),
                                    num_classes=CLASSES, hidden=HIDDEN,
                                    in_channels=F_IN, **CPU)
    return jm, tm


def _losses(kind, data):
    """The training loss of each model, in JAX and in torch: the pooler's
    losses, plus masked cross-entropy for node classification."""
    y, train = data["y"], data["train"]

    def j_loss(out):
        head, po = out
        if kind == "cluster":
            return po.loss_sum()
        ce = optax.softmax_cross_entropy_with_integer_labels(head,
                                                             jnp.asarray(y))
        ce = jnp.where(jnp.asarray(train), ce, 0.0).sum() / train.sum()
        return ce + po.loss_sum()

    def t_loss(out):
        head, po = out
        if kind == "cluster":
            return po.loss_sum()
        ce = F.cross_entropy(head, torch.tensor(y).long(), reduction="none")
        tr = torch.tensor(train)
        return torch.where(tr, ce, 0.0).sum() / tr.sum() + po.loss_sum()

    return j_loss, t_loss


CASES = ([("cluster", mp, a) for mp in ("gcn", "gtv")
          for a in ("mincut", "mincut_u", "acc")]
         + [("node", "topk", None), ("node", "mincut", None)])


@pytest.mark.parametrize("kind,arg,alias", CASES + [
    ("cluster", "gtv", "acc_u")])
def test_training_step_adds_no_floats_out_of_order(kind, arg, alias, data,
                                                   monkeypatch):
    """A training step of each model (forward and backward): every float
    sum in a fixed order (K4), none by a scatter."""
    spy = spy_with_k4_paused(monkeypatch)
    _, tm = _models(kind, arg, alias)
    _, t_loss = _losses(kind, data)
    with spy:
        t_loss(tm(data["tb"])).backward()
    assert spy.seen == [], spy.seen


@pytest.mark.parametrize("kind,arg,alias", CASES)
def test_model_matches_jax(kind, arg, alias, data):
    jb, tb = data["jb"], data["tb"]
    jm, tm = _models(kind, arg, alias)
    jp = jm.init(jax.random.key(0), jb)
    tm.load_state_dict(params_from_flax(jp))
    j_loss, t_loss = _losses(kind, data)

    j_out = jm.apply(jp, jb)
    t_out = tm(tb)
    what = f"{kind}/{arg}/{alias}"
    _close(t_out[0], j_out[0], 1e-4, f"{what} head")
    assert set(t_out[1].loss) == set(j_out[1].loss)
    for name, v in j_out[1].loss.items():
        _close(t_out[1].loss[name], v, 1e-4, f"{what} {name}")

    # gradients of the training loss, leaf by leaf
    jg = jax.grad(lambda p: j_loss(jm.apply(p, jb)))(jp)
    t_loss(t_out).backward()
    named = dict(tm.named_parameters())
    ref = params_from_flax(jg)
    assert set(ref) == set(named), (what, set(ref) ^ set(named))
    for name, g in ref.items():
        _close(named[name].grad, g, 1e-4, f"{what} d{name}")

    # one Adam step from the same weights and gradients
    tx = optax.adam(LR)
    upd, _ = tx.update(jg, tx.init(jp), jp)
    j_new = params_from_flax(optax.apply_updates(jp, upd))
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    opt.step()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), _np(j_new[name]), rtol=0,
                                   atol=1e-2 * LR,
                                   err_msg=f"{what} {name} after Adam")


@pytest.mark.parametrize("case", ["random", "permuted", "single", "empty",
                                  "one_vs_many", "all_distinct", "strings"])
def test_nmi_matches_sklearn(case):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 5, 200)
    b = {"random": lambda: rng.integers(0, 7, 200),
         "permuted": lambda: (a + 3) % 5,
         "single": lambda: np.zeros(200, int),
         "empty": lambda: np.zeros(0, int),
         "one_vs_many": lambda: rng.integers(0, 4, 200),
         "all_distinct": lambda: np.arange(200),
         "strings": lambda: np.array(list("abc"))[rng.integers(0, 3, 200)],
         }[case]()
    if case == "empty":
        a = np.zeros(0, int)
    if case == "one_vs_many":
        a = np.zeros(200, int)
    got, ref = nmi_score(a, b), j_nmi(a, b)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-12, (case, got, ref)
    assert abs(nmi_score(b, a) - j_nmi(b, a)) <= 1e-12
    if case in ("single", "empty"):
        assert nmi_score(b, b) == 1.0


def test_nmi_over_many_labellings():
    rng = np.random.default_rng(5)
    for trial in range(50):
        n = int(rng.integers(1, 300))
        a = rng.integers(0, int(rng.integers(1, 9)), n)
        b = rng.integers(0, int(rng.integers(1, 9)), n)
        assert abs(nmi_score(a, b) - j_nmi(a, b)) <= 1e-12, trial


def test_dense_lift_repack_adds_no_floats(data, monkeypatch):
    """``PoolLiftNodeClassifier`` with MinCut (a ``[B, Nmax, F]`` lift
    re-packed by ``node_rows``): no float scatter in the forward or the
    backward, and ``node_rows``'s gradient is each node's row in its
    cell, padding nodes ignored."""
    spy = spy_with_k4_paused(monkeypatch)
    _, tm = _models("node", "mincut")
    _, t_loss = _losses("node", data)
    with spy:
        t_loss(tm(data["tb"])).backward()
    assert spy.seen == []
    # node_rows alone: forward values and an exact gradient
    tb = data["tb"]
    t = torch.randn(tb.num_graphs, tb.max_nodes, 4, requires_grad=True)
    rows = seg.node_rows(t, tb.node_graph, tb.node_pos, tb.node_mask)
    nm = tb.node_mask
    ref = t[tb.node_graph.long(), tb.node_pos.long()]
    assert torch.equal(rows[nm], ref[nm]) and not rows[~nm].any()
    g = torch.randn_like(rows)
    with spy:
        rows.backward(g)
    assert spy.seen == []
    want = torch.zeros_like(t)
    want[tb.node_graph[nm].long(), tb.node_pos[nm].long()] = g[nm]
    assert torch.equal(t.grad, want)
    # the spy sees what it looks for
    x = torch.ones(3, requires_grad=True)
    with spy:
        x[torch.tensor([0, 0])].sum().backward()
    assert spy.seen == ["index_put"]
