"""The PyTorch twins of the classification examples on the CPU, held to
the accuracy bounds of ``tests/test_examples_smoke.py``'s JAX tests (0.6
for ``examples/classification.py`` and 0.4 for
``examples/classification_pan.py``, two epochs each; 0.5 for
``examples/classification_aggr_reduce.py``, five epochs), the
aggregation example's ``Net`` against the JAX one, the precoarsening
twin (each schedule one epoch; its ``PrecoarsenedNet`` against JAX's:
logits, and step one's loss, gradients and Adam update against optax),
the classification twin's datasets (equal to the JAX example's) and
checkpoints, and the clustering, TVGNN and node-classification twins at
the JAX smoke tests' epochs and bounds (NMI above 0.5, accuracy above
0.6)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import examples.classification_torch as ex
from examples.classification_aggr_reduce import Net as JNet
import examples.classification_aggr_reduce_torch as aggr_ex
from examples.classification_aggr_reduce_torch import Net as AggrNet
from examples.classification_pan_torch import main as pan_main
import examples.pre_coarsening as j_pre
import examples.pre_coarsening_torch as pre_ex
from tgp_tpu.data.loaders import GraphLoader as JLoader
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.data.pooled_loader import PooledGraphLoader as JPooledLoader
from tgp_tpu_torch.data.loaders import GraphLoader
from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
from tgp_tpu_torch.datasets import SyntheticGraphClassification
from tgp_tpu_torch.models.convert import params_from_flax

#: the aggregation example's dataset
AGGR_GRAPHS, AGGR_LABELS = SyntheticGraphClassification(
    num_graphs=240, num_features=8, seed=5).generate()

torch.set_num_threads(1)


@pytest.mark.parametrize("alias,route", [("topk", "dense"),
                                         ("sag", "sparse"),
                                         ("asap", "sparse"),
                                         ("pan", "sparse"),
                                         ("ec", "sparse"),
                                         ("graclus", "sparse"),
                                         ("kmis", "sparse"),
                                         ("lap", "sparse"),
                                         ("mincut", "dense"),
                                         ("mincut_u", "sparse"),
                                         ("bnpool", "dense"),
                                         ("maxcut", "sparse")])
def test_classification_twin_trains(alias, route):
    acc = ex.main(alias, epochs=2, verbose=False, device="cpu")
    assert acc > 0.6
    # top-k and the batched dense family take a dense batch, the other
    # poolers (and the "_u" modes) stay sparse
    assert ex.LAST_ROUTE == route


def test_classification_pan_twin_trains():
    assert pan_main(epochs=2, verbose=False, device="cpu") > 0.4


def test_classification_twin_names_what_is_not_ported(tmp_path):
    """Every dataset is ported now: what the twin cannot load is named by
    the dataset's own error, the missing files, as in the JAX example."""
    with pytest.raises(FileNotFoundError, match="PROTEINS"):
        ex.load_dataset("PROTEINS", str(tmp_path))
    for name in ("gcb", "expwl1"):
        with pytest.raises(RuntimeError, match=re.escape(str(tmp_path))):
            ex.load_dataset(name, str(tmp_path))
    assert not hasattr(ex, "TODO_ITEM")


@pytest.mark.parametrize("name,data_dir", [
    ("MINI", "tests/fixtures/tu"), ("PROTEINS_SYN", "tests/fixtures/tu"),
    ("gcb", "tests/fixtures/gcb"), ("expwl1", "tests/fixtures/expwl1"),
    ("synthetic", None)])
def test_classification_twin_load_dataset_matches_jax(name, data_dir):
    import examples.classification as j_ex

    jg, jy, jc = j_ex.load_dataset(name, data_dir)
    tg, ty, tc = ex.load_dataset(name, data_dir)
    assert jc == tc and len(jg) == len(tg)
    np.testing.assert_array_equal(ty, jy)
    assert ty.dtype == jy.dtype
    for (jx, jei), (tx, tei) in zip(jg, tg):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tei, jei)
        assert (tx.dtype, tei.dtype) == (jx.dtype, jei.dtype)


def test_classification_twin_trains_on_a_tu_fixture():
    acc = ex.main("topk", epochs=2, verbose=False, device="cpu",
                  dataset="PROTEINS_SYN", data_dir="tests/fixtures/tu")
    assert acc > 0.6


@pytest.mark.parametrize("alias", ["sag", "bnpool"])
def test_classification_twin_checkpoint_restores(alias, tmp_path):
    """``--checkpoint-dir`` writes the trained weights, which restore into
    a fresh model (the twin checks its logits bit for bit; BNPool's draws
    from one generator state)."""
    from tgp_tpu_torch.utils.checkpoint import restore_params

    ex.main(alias, epochs=1, verbose=False, device="cpu",
            checkpoint_dir=str(tmp_path / "ck"))
    sd = restore_params(tmp_path / "ck", device="cpu")
    g, _, c = ex.load_dataset("synthetic")
    fresh = ex.build_model(alias, c, 64, g[0][0].shape[1], device="cpu",
                           seed=5)
    assert set(sd) == set(fresh.state_dict())
    fresh.load_state_dict(sd)


def test_cluster_twins_learn_as_jax_tests_ask():
    """The JAX smoke tests' epochs and bounds: clustering (MinCut, 60
    epochs) and TVGNN (60) NMI above 0.5, node classification (top-k, 40)
    test accuracy above 0.6; the unbatched MinCut and a dense lift too."""
    from examples.clustering_torch import main as cluster
    from examples.clustering_tvgnn_torch import main as tvgnn
    from examples.node_class_torch import main as node_class

    assert cluster("mincut", epochs=60, verbose=False, device="cpu") > 0.5
    assert cluster("mincut_u", epochs=60, verbose=False, device="cpu") > 0.5
    assert tvgnn(epochs=60, verbose=False, device="cpu") > 0.5
    assert node_class("topk", epochs=40, verbose=False, device="cpu") > 0.6
    assert node_class("mincut", epochs=40, verbose=False,
                      device="cpu") > 0.6


def test_cluster_twins_match_jax_examples_data():
    """The twins' CSBM settings give the JAX examples' graphs."""
    from tgp_tpu.datasets.csbm import CSBMDataset as JCSBM
    from tgp_tpu_torch.datasets.csbm import CSBMDataset

    for kw in (dict(num_graphs=1, num_nodes=150, num_communities=4,
                    p_in=0.35, p_out=0.03, feature_dim=16, mu=1.2, seed=1),
               dict(num_graphs=1, num_nodes=160, num_communities=4,
                    p_in=0.3, p_out=0.03, feature_dim=16, mu=1.0, seed=3)):
        for a, b in zip(JCSBM(**kw)[0], CSBMDataset(**kw)[0]):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_aggr_net(aggr):
    """The JAX example's ``Net`` and its initial parameters, built as its
    ``main`` builds them (on the training loader's first batch)."""
    jl = JLoader(AGGR_GRAPHS[:200], AGGR_LABELS[:200], batch_size=32,
                 shuffle=True)
    b0, y0 = next(iter(jl))
    net = JNet(pooler=j_get("topk", in_channels=32, ratio=0.5), aggr=aggr)
    params = jax.jit(net.init)(jax.random.key(0), b0)
    return net, params, b0, y0


@pytest.mark.parametrize("aggr", ["set2set", "lstm"])
def test_classification_aggr_reduce_twin_trains(aggr, monkeypatch):
    """The JAX example's test (5 epochs, accuracy above 0.5) from the JAX
    example's initial weights, carried over (the twin's ``Net`` loads
    them when built): the same start, the same batches."""
    init = params_from_flax(_jax_aggr_net(aggr)[1])

    class FromJax(AggrNet):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.load_state_dict(init)

    monkeypatch.setattr(aggr_ex, "Net", FromJax)
    assert aggr_ex.main(aggr, epochs=5, verbose=False, device="cpu") > 0.5


@pytest.mark.parametrize("aggr", ["sum", "mean", "lstm", "set2set"])
def test_classification_aggr_reduce_net_matches_jax(aggr):
    """The twin's ``Net`` with the JAX ``Net``'s parameters on the JAX
    loader's first batch: logits within 1e-5 of their largest |value|,
    the cross-entropy loss within 1e-5 relative and every gradient leaf
    within 1e-4 of its largest |value| (other sum orders)."""
    jnet, params, jb, y = _jax_aggr_net(aggr)
    params = jax.tree_util.tree_map(lambda p: p + 0.05, params)
    loader = GraphLoader(AGGR_GRAPHS[:200], AGGR_LABELS[:200],
                         batch_size=32, shuffle=True, device="cpu")
    tb, ty = next(iter(loader))
    np.testing.assert_array_equal(ty, y)
    net = AggrNet(8, aggr, device="cpu")
    net.load_state_dict(params_from_flax(params))

    def loss_fn(p):
        logits = jnet.apply(p, jb)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = net(tb)
    loss = torch.nn.functional.cross_entropy(logits, torch.as_tensor(y).long())
    loss.backward()
    jlogits = np.asarray(jlogits)
    assert np.abs(logits.detach().numpy() - jlogits).max() <= \
        1e-5 * np.abs(jlogits).max()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = params_from_flax(jgrads)
    got = {k: p.grad for k, p in net.named_parameters()}
    # the torch cells' extra biases take the gradient of the bias they add to
    if aggr == "set2set":
        ref["aggr_reduce.aggr.cell.bias_ih"] = ref["aggr_reduce.aggr.cell.bias_hh"]
    if aggr == "lstm":
        ref["aggr_reduce.aggr.rnn.bias_ih_l0"] = \
            ref["aggr_reduce.aggr.rnn.bias_hh_l0"]
    assert set(got) == set(ref)
    for k, g in ref.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got[k] - g).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("schedule", ["graclus", "mixed", "eigen", "sep"])
def test_pre_coarsening_twin_trains_one_epoch(schedule):
    acc = pre_ex.main(schedule, epochs=1, verbose=False, device="cpu")
    assert 0.0 <= acc <= 1.0


def test_pre_coarsening_twin_learns_as_jax_test_asks():
    """``tests/test_examples_smoke.py``'s bound for the JAX example:
    Graclus, 5 epochs, accuracy above 0.5."""
    assert pre_ex.main("graclus", epochs=5, verbose=False,
                       device="cpu") > 0.5


@functools.lru_cache(maxsize=None)
def _precoarsened(schedule):
    graphs, labels = SyntheticGraphClassification(
        num_graphs=12, num_features=8, seed=3).generate()
    tf = pre_ex.schedule_transform(schedule)
    return [tf(g) for g in graphs], labels


@pytest.mark.parametrize("schedule", ["graclus", "mixed", "eigen", "sep",
                                      "nmf"])
def test_precoarsened_net_matches_jax(schedule):
    """``PrecoarsenedNet`` with the flax model's parameters on the same
    batch: logits within 1e-5 of their largest |value|; step one's loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its largest
    |value|, and the weights after one Adam step (lr 1e-3) within 1e-6 of
    optax's."""
    pooled, labels = _precoarsened(schedule)
    jb, jlb, y = next(iter(JPooledLoader(pooled, labels, batch_size=6)))
    tb, tlb, ty = next(iter(PooledGraphLoader(pooled, labels, batch_size=6,
                                              device="cpu")))
    np.testing.assert_array_equal(ty, y)
    jnet = j_pre.PrecoarsenedNet(num_classes=3, hidden=16)
    params = jnet.init(jax.random.key(0), jb, jlb)
    net = pre_ex.PrecoarsenedNet(8, 3, hidden=16,
                                 level_modes=pre_ex.level_modes(pooled[0]),
                                 device="cpu")
    net.load_state_dict(params_from_flax(params))

    def loss_fn(p):
        logits = jnet.apply(p, jb, jlb)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(jgrads, tx.init(params))
    jnew = params_from_flax(optax.apply_updates(params, updates))

    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    logits = net(tb, tlb)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.as_tensor(y).long())
    loss.backward()
    jlogits = np.asarray(jlogits)
    assert np.abs(logits.detach().numpy() - jlogits).max() <= \
        1e-5 * np.abs(jlogits).max()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = params_from_flax(jgrads)
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    assert set(got) == set(ref)
    for k, g in ref.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got[k] - g).abs().max()) <= 1e-4 * scale, k
    opt.step()
    for k, p in net.named_parameters():
        assert float((p.detach() - jnew[k]).abs().max()) <= 1e-6, k
