"""The port's capability flags and ``PrecoarseningMixin`` against
``tgp_tpu``'s: every alias of both registries carries JAX's six flags
(``IS_DENSE``, ``HAS_LOSS``, ``IS_TRAINABLE``, ``IS_PRECOARSENABLE``,
``SUPPORTS_SPARSE_OUT``, ``ACCEPTS_DENSE_BATCH``; a flag JAX's host
poolers do not define is absent on the port's too), and the mixin's
greedy rollout gives JAX's levels."""

import numpy as np
import pytest

from tgp_tpu.poolers import pooler_map as j_map
from tgp_tpu.src import PrecoarseningMixin as JMixin
from tgp_tpu.precoarsen.graclus import graclus_level as j_graclus
from tgp_tpu_torch.poolers import get_pooler, pooler_map
from tgp_tpu_torch.precoarsen.graclus import graclus_level
from tgp_tpu_torch.src import PrecoarseningMixin, SRCPooling

FLAGS = ("IS_DENSE", "HAS_LOSS", "IS_TRAINABLE", "IS_PRECOARSENABLE",
         "SUPPORTS_SPARSE_OUT", "ACCEPTS_DENSE_BATCH")
_MISSING = object()
#: flags the port sets against JAX, each a choice pinned by its own test:
#: LaPool keeps the batch sparse where JAX's densifies and fails
#: (tests/test_torch_lapool.py::test_lapool_keeps_the_batch_sparse_where_jax_fails)
PORT_CHOICES = {("lap", "ACCEPTS_DENSE_BATCH"): False}


def test_both_registries_know_the_same_21_aliases():
    assert sorted(pooler_map()) == sorted(j_map())
    assert len(pooler_map()) == 21


@pytest.mark.parametrize("alias", sorted(j_map()))
def test_capability_flags_equal_jax(alias):
    j_cls, t_cls = j_map()[alias], pooler_map()[alias]
    for flag in FLAGS:
        want = PORT_CHOICES.get((alias, flag), getattr(j_cls, flag, _MISSING))
        got = getattr(t_cls, flag, _MISSING)
        assert got is want or got == want, (alias, flag, got, want)


def test_base_class_flags_equal_jax():
    from tgp_tpu.src import DenseSRCPooling as JDense, SRCPooling as JSRC
    from tgp_tpu_torch.src import DenseSRCPooling

    for j, t in ((JSRC, SRCPooling), (JDense, DenseSRCPooling)):
        assert {f: getattr(t, f) for f in FLAGS} == \
            {f: getattr(j, f) for f in FLAGS}


def test_flags_read_the_same_on_instances():
    pooler = get_pooler("kmis", in_channels=4, device="cpu")
    assert pooler.IS_TRAINABLE and pooler.IS_PRECOARSENABLE
    assert not get_pooler("ndp").IS_TRAINABLE


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    up = np.triu(rng.random((n, n)) < p, 1)
    s, r = np.nonzero(up | up.T)
    return np.stack([s, r]).astype(np.int64), rng.random(s.size) + 0.5


@pytest.mark.parametrize("levels", [1, 3])
def test_precoarsening_mixin_rollout_matches_jax(levels):
    class T(PrecoarseningMixin):
        def precoarsen_graph(self, edge_index, num_nodes, edge_weight=None):
            return graclus_level(edge_index, num_nodes, edge_weight)

    class J(JMixin):
        def precoarsen_graph(self, edge_index, num_nodes, edge_weight=None):
            return j_graclus(edge_index, num_nodes, edge_weight)

    ei, w = _er(40, 0.15, 3)
    got = T().multi_level_precoarsen(ei, 40, w, levels=levels)
    want = J().multi_level_precoarsen(ei, 40, w, levels=levels)
    assert len(got) == len(want) == levels
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_precoarsening_mixin_needs_its_level_function():
    with pytest.raises(NotImplementedError):
        PrecoarseningMixin().multi_level_precoarsen(np.zeros((2, 0)), 3)
