"""The whole serving slice: the JAX ``Predictor`` over ``PoolingClassifier``
against the port's ``Predictor`` with weights carried over by
``params_from_flax`` (f32 logits, atol 1e-4), plus the port's import
guard and its CUDA-by-default entry points.

The kernel path runs as it does on the card, with the kernels' plain
versions standing in on CPU tensors: the port's ``use_kernel=True`` and
masked pooling against JAX's ``use_pallas=True`` (interpret mode) and
``pool_mode="masked"``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.models.inference import Predictor as JPredictor
from tgp_tpu.models.inference import geometric_budget as j_budget
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu_torch import (PoolingClassifier, Predictor, from_graphs,
                           get_pooler)
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.models.inference import geometric_budget

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
F_IN, HIDDEN = 12, 16


def _requests(seed, count=3, n_range=(70, 120)):
    """Loop-free random graphs, one seed each (the JAX CSR branch adds a
    second unit loop where a graph has its own); the default sizes share
    one bucket, so the JAX side compiles once."""
    out = []
    for i in range(count):
        rng = np.random.default_rng(seed + i)
        n = int(rng.integers(*n_range))
        s, r = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
        keep = s != r
        x = rng.normal(size=(n, F_IN)).astype(np.float32)
        out.append((x, np.stack([s[keep], r[keep]])))
    return out


def _models(pool_mode, use_kernel, compute_dtype=None, seed=0):
    jm = JPC(pooler=j_get("topk", in_channels=HIDDEN, ratio=0.5,
                          pool_mode=pool_mode),
             num_classes=3, hidden=HIDDEN, use_pallas=use_kernel,
             compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    params = jm.init(jax.random.key(seed),
                     j_from(_requests(99, 1), sort_edges=True))
    tm = PoolingClassifier(
        get_pooler("topk", in_channels=HIDDEN, ratio=0.5,
                   pool_mode=pool_mode, device="cpu"),
        num_classes=3, hidden=HIDDEN, in_channels=F_IN,
        use_kernel=use_kernel, compute_dtype=compute_dtype, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("batch_size", [1, 2])
def test_serving_slice_matches_jax(batch_size):
    """Kernel path: CSR GCN → masked top-k → CSR GCN → readout → head."""
    jm, params, tm = _models("masked", True)
    graphs = _requests(1)
    jp = JPredictor(lambda p, b: jm.apply(p, b)[0], params,
                    batch_size=batch_size, sort_edges=True)
    tp = Predictor(lambda b: tm(b)[0], batch_size=batch_size,
                   sort_edges=True, device="cpu")
    ref, got = jp(graphs), tp(graphs)
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert tp.num_compiled == jp.num_compiled


def test_serving_compact_path_below_kernel_regime_matches_jax():
    """Default flags: below 2¹⁸ edges both packages take the generic GCN
    branch and compact top-k pooling."""
    jm, params, tm = _models("auto", None, seed=1)
    graphs = _requests(10)
    ref = JPredictor(lambda p, b: jm.apply(p, b)[0], params,
                     batch_size=1)(graphs)
    tp = Predictor(lambda b: tm(b)[0], batch_size=1, device="cpu")
    np.testing.assert_allclose(tp(graphs), ref, atol=1e-4)
    _, out = tm(from_graphs(graphs[:1], device="cpu"))
    assert out.so.extras.get("pool_mode") is None  # compact
    assert out.graph.num_nodes == out.so.max_clusters


def test_serving_bf16_matches_jax():
    """bf16 compute (the chip configuration): 2e-2 of the logit scale —
    bf16 rounding of the GCN products in both packages, and of the edge
    weights inside the Pallas kernel."""
    jm, params, tm = _models("masked", True, torch.bfloat16, seed=2)
    graphs = _requests(20)
    ref = JPredictor(lambda p, b: jm.apply(p, b)[0], params, batch_size=1,
                     sort_edges=True)(graphs)
    got = Predictor(lambda b: tm(b)[0], batch_size=1, sort_edges=True,
                    device="cpu")(graphs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max())


def test_predictor_empty_input_width_and_buckets():
    _, _, tm = _models("auto", None)
    tp = Predictor(lambda b: tm(b)[0], batch_size=2, device="cpu")
    assert tp(()).shape == (0,)
    assert Predictor(lambda b: tm(b)[0], out_width=3,
                     device="cpu")([]).shape == (0, 3)
    tp(_requests(30, count=3, n_range=(10, 20)))
    assert tp(()).shape == (0, 3)  # width learned from the first call
    tp(_requests(40, count=1, n_range=(200, 210)))
    assert tp.num_compiled == 2
    for n in (1, 64, 65, 1000):
        assert geometric_budget(n) == j_budget(n)
    with pytest.raises(ValueError, match="growth"):
        geometric_budget(5, growth=1.0)


def test_params_from_flax_layout():
    _, params, tm = _models("auto", None)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert sd["pre_convs.0.lin.weight"].shape == (HIDDEN, F_IN)
    inner = params_from_flax(params["params"])  # the inner dict works too
    assert all(torch.equal(sd[k], v) for k, v in inner.items())
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_flax({"params": {"gat_0": {"kernel": np.zeros(2)}}})


_GUARD = """
import importlib
import pkgutil
import sys
import numpy as np
import tgp_tpu_torch
from tgp_tpu_torch.data import GraphLoader
from tgp_tpu_torch.ops.ordering import plan_locality_spmm
mods = [m.name for m in pkgutil.walk_packages(tgp_tpu_torch.__path__,
                                               'tgp_tpu_torch.')]
for name in mods:
    importlib.import_module(name)
assert {'tgp_tpu_torch.ops.kernels.bmm', 'tgp_tpu_torch.models.prepare',
        'tgp_tpu_torch.models.fast_dense', 'tgp_tpu_torch.ops.ordering',
        'tgp_tpu_torch.ops.kernels.sddmm', 'tgp_tpu_torch.data.loaders',
        'tgp_tpu_torch.data.transforms', 'tgp_tpu_torch.datasets.synthetic',
        'tgp_tpu_torch.mp.leconv', 'tgp_tpu_torch.mp.pan',
        'tgp_tpu_torch.poolers.sag', 'tgp_tpu_torch.poolers.asap',
        'tgp_tpu_torch.poolers.pan', 'tgp_tpu_torch.losses',
        'tgp_tpu_torch.select.mlp', 'tgp_tpu_torch.poolers.dense_base',
        'tgp_tpu_torch.poolers.mincut', 'tgp_tpu_torch.poolers.diffpool',
        'tgp_tpu_torch.poolers.dmon', 'tgp_tpu_torch.poolers.hosc',
        'tgp_tpu_torch.poolers.just_balance',
        'tgp_tpu_torch.poolers.asym_cheeger_cut',
        'tgp_tpu_torch.ops.sampling', 'tgp_tpu_torch.ops.lap',
        'tgp_tpu_torch.ops.assignment', 'tgp_tpu_torch.select.dp',
        'tgp_tpu_torch.select.maxcut', 'tgp_tpu_torch.poolers.bnpool',
        'tgp_tpu_torch.poolers.maxcut',
        'tgp_tpu_torch.reduce.aggr', 'tgp_tpu_torch._native',
        'tgp_tpu_torch.precoarsen.api', 'tgp_tpu_torch.precoarsen.common',
        'tgp_tpu_torch.precoarsen.graclus', 'tgp_tpu_torch.precoarsen.ndp',
        'tgp_tpu_torch.precoarsen.sep', 'tgp_tpu_torch.precoarsen.nmf',
        'tgp_tpu_torch.precoarsen.eigenpool',
        'tgp_tpu_torch.data.pooled_loader', 'tgp_tpu_torch.reduce.eigenpool',
        'tgp_tpu_torch.lift.eigenpool', 'tgp_tpu_torch.poolers.host_base',
        'tgp_tpu_torch.poolers.ndp', 'tgp_tpu_torch.poolers.nmf',
        'tgp_tpu_torch.poolers.sep', 'tgp_tpu_torch.poolers.eigenpool',
        'tgp_tpu_torch.mp.gtvconv', 'tgp_tpu_torch.models.clustering',
        'tgp_tpu_torch.models.autoencoder', 'tgp_tpu_torch.datasets.csbm',
        'tgp_tpu_torch.datasets.multipartite', 'tgp_tpu_torch.datasets.gset',
        'tgp_tpu_torch.datasets.pygsp', 'tgp_tpu_torch.datasets.tudataset',
        'tgp_tpu_torch.datasets.downloads', 'tgp_tpu_torch.utils.checkpoint',
        'tgp_tpu_torch.utils.cheatsheet', 'tgp_tpu_torch.utils.typing',
        'tgp_tpu_torch.parallel.dense_pool',
        'tgp_tpu_torch.parallel.sparse_pool'
        } <= set(mods), mods
import examples.classification_torch
import examples.classification_pan_torch
import examples.classification_aggr_reduce_torch
import examples.pre_coarsening_torch
import examples.clustering_torch
import examples.clustering_tvgnn_torch
import examples.node_class_torch
from tgp_tpu_torch.datasets import PyGSPDataset
from tgp_tpu_torch.models.autoencoder import PoolLiftNodeClassifier
from tgp_tpu_torch.models.clustering import ClusteringModel, nmi_score
from tgp_tpu_torch.mp.gtvconv import GTVConv
from tgp_tpu_torch.utils.cheatsheet import render_cheatsheet
# NMI runs without scikit-learn
assert nmi_score([0, 0, 1, 1], [1, 1, 0, 0]) == 1.0
render_cheatsheet()
from tgp_tpu_torch.reduce.aggr import AggrReduce, get_aggr
from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader, collate_level
from tgp_tpu_torch.precoarsen import PreCoarsening, precoarsen_graph
from tgp_tpu_torch.precoarsen.ndp import ndp_level
# the host level functions run without scikit-learn (and without a card)
ring = np.array([[0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 0]])
for alias, kw in (('graclus', {}), ('ndp', {}), ('sep', {}),
                  ('nmf', {'k': 3}), ('eigen', {'k': 3})):
    precoarsen_graph(alias, ring, 6, levels=2, **kw)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'sklearn', 'tgp_tpu'))
assert not bad, bad
import torch
assert not torch.cuda.is_available()
g = [(np.zeros((3, 2), np.float32), np.array([[0, 1], [1, 2]]))]
for call in (lambda: tgp_tpu_torch.from_graphs(g),
             lambda: tgp_tpu_torch.Predictor(lambda b: b.x),
             lambda: tgp_tpu_torch.get_pooler('topk', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('sag', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('asap', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('pan', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('mincut', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('acc_u', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('bnpool', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('bnpool_u', in_channels=4),
             lambda: tgp_tpu_torch.get_pooler('maxcut', in_channels=4),
             lambda: get_aggr('lstm', in_channels=4),
             lambda: get_aggr('set2set', in_channels=4),
             lambda: AggrReduce('sum'),
             lambda: AggrReduce('set_transformer', in_channels=4),
             lambda: examples.classification_aggr_reduce_torch.Net(4),
             lambda: examples.classification_aggr_reduce_torch.main('lstm'),
             lambda: GraphLoader(g),
             lambda: examples.classification_torch.main('sag', epochs=1),
             lambda: tgp_tpu_torch.PoolingClassifier(None, 3, hidden=4),
             lambda: tgp_tpu_torch.DenseTopkClassifier(3, hidden=4),
             lambda: plan_locality_spmm(g[0][1], 3),
             lambda: PooledGraphLoader([PreCoarsening('graclus')(g[0])]),
             lambda: collate_level([precoarsen_graph('graclus', g[0][1], 3)[0]],
                                   np.zeros(1), 3, 8, 128, 2),
             lambda: ndp_level(g[0][1], 3, eigensolver='lobpcg'),
             lambda: examples.pre_coarsening_torch.PrecoarsenedNet(2, 3),
             lambda: examples.pre_coarsening_torch.main('graclus', epochs=1),
             lambda: GTVConv(4, 4),
             lambda: ClusteringModel(None, hidden=4),
             lambda: PoolLiftNodeClassifier(None, 3, hidden=4),
             lambda: PyGSPDataset('Ring', n=8).as_graph_batch(),
             lambda: examples.clustering_torch.main('mincut', epochs=1),
             lambda: examples.clustering_tvgnn_torch.main(epochs=1),
             lambda: examples.node_class_torch.main('topk', epochs=1)):
    try:
        call()
    except RuntimeError as e:
        assert 'CUDA is not available' in str(e), e
    else:
        raise AssertionError('entry point ran without CUDA')
print('ok')
"""


def test_port_imports_no_jax_and_defaults_to_cuda():
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                           if p)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": path}
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
