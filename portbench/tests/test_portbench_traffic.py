"""The traffic generator: the same seed gives the same inputs, other
indices other graphs, and every seed the same set of sizes."""

import collections

import numpy as np
import pytest

from portbench.harness import gen, spec

MIXES = ["large-graph-requests", "large-graph-fullbatch", "er-batch-128x256",
         "dd-requests-of-8"]
SMALL = {"large-graph-requests": dict(nodes={"dist": "fixed", "value": 512},
                                      edges={"kind": "uniform_directed",
                                             "count": 4000}),
         "large-graph-fullbatch": dict(nodes={"dist": "fixed", "value": 512},
                                       edges={"kind": "uniform_directed",
                                              "count": 4000}),
         "er-batch-128x256": dict(graphs_per_request=4),
         "dd-requests-of-8": {}}
SEEDS = [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3, -5]


def mix(name):
    tr = spec.load_json(spec.HERE / "traffic" / f"{name}.json")
    tr.update(SMALL[name])
    return tr


def same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x1, x2) and np.array_equal(e1, e2)
        for (x1, e1), (x2, e2) in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_graphs(name, seed):
    tr = mix(name)
    assert same(gen.graphs(tr, seed, 3), gen.graphs(tr, seed, 3))


@pytest.mark.parametrize("name", MIXES)
def test_other_index_other_graphs(name):
    tr = mix(name)
    a, b = gen.graphs(tr, 11, 0), gen.graphs(tr, 11, 1)
    assert not same(a, b)
    assert not same(gen.graphs(tr, 11, 0), gen.graphs(tr, 12, 0))
    assert not same(a, gen.graphs(tr, 11, 0, gen.WARMUP))


@pytest.mark.parametrize("name", MIXES)
def test_shapes_as_the_mix_states(name):
    tr = mix(name)
    for x, ei in gen.graphs(tr, 5, 2):
        n = x.shape[0]
        assert x.shape == (n, tr["features"]) and x.dtype == np.float32
        assert ei.shape[0] == 2 and ei.min() >= 0 and ei.max() < n
        want = gen.edge_count(tr, n)
        if want is not None:
            assert ei.shape[1] == want
        if tr["edges"]["kind"] != "uniform_directed":
            # undirected: every edge in both directions, no loop
            fwd = collections.Counter(zip(ei[0].tolist(), ei[1].tolist()))
            bwd = collections.Counter(zip(ei[1].tolist(), ei[0].tolist()))
            assert fwd == bwd and not (ei[0] == ei[1]).any()


def test_every_seed_serves_the_same_sizes():
    tr = mix("dd-requests-of-8")
    n_req = tr["nodes"]["pool_requests"]

    def sizes(seed):
        return sorted(tuple(gen.node_counts(tr, seed, i)) for i in range(n_req))

    assert sizes(1) == sizes(2 ** 33 + 1)
    order1 = [gen.node_counts(tr, 1, i) for i in range(8)]
    order2 = [gen.node_counts(tr, 2 ** 33 + 1, i) for i in range(8)]
    assert order1 != order2
    flat = np.array(sizes(1)).ravel()
    assert flat.min() >= 30 and flat.max() <= 5748
    assert 230 < flat.mean() < 340  # D&D's mean is 284.3


def test_warmup_requests_have_the_window_sizes():
    tr = mix("dd-requests-of-8")
    for i in range(5):
        w = [g[0].shape[0] for g in gen.graphs(tr, 9, i, gen.WARMUP, 1)]
        assert w == gen.node_counts(tr, 9, i)


def test_labels():
    tr = mix("er-batch-128x256")
    a, b = gen.labels(tr, 3, 64), gen.labels(tr, 3, 64)
    assert np.array_equal(a, b) and set(a.tolist()) <= {0, 1, 2}
    assert (gen.labels(mix("large-graph-fullbatch"), 3, 1) == 1).all()
