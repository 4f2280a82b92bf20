"""``PoolingClassifier``'s CUDA-graph replay
(``tgp_tpu_torch/models/graph_replay.py``), on the CPU.

The replay engages only on the card; here the tests hold what it rests
on: that the forward of every pooler marked ``CAPTURABLE`` reads nothing
back to the host on either route (a capture would fail on the card where
it does), that every other call dispatches exactly the eager forward's
ops, and the signature cache's order of eager, capture and replay and
the outputs a replay hands back, with a stand-in for the captured graph
(``cuda_graph_stub``).  The card's own tests (bit-equal
replays, fresh outputs, launch counts, no sync) are in
``tests/test_torch_cuda_kernels.py``.
"""

import copy
import pickle

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import cuda_graph_stub
from tgp_tpu_torch import (PoolingClassifier, from_graphs, get_pooler,
                           pooler_map, tracing)
from tgp_tpu_torch.models import graph_replay as R

F_IN, HIDDEN = 8, 16
CAPTURABLE = sorted(a for a, c in pooler_map().items()
                    if getattr(c, "CAPTURABLE", False))
aten = torch.ops.aten
# ops whose output size or value the host must read from the card
HOST_READS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
              aten._unique2, aten.unique_dim, aten.unique_consecutive}
HOST_METHODS = {"cpu", "numpy", "tolist", "item"}
MIN_SCORE = 0.1  # top-k's threshold mode: a score bound in place of k


def _graphs(seed, count=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(40, 70))
        s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        out.append((rng.normal(size=(n, F_IN)).astype(np.float32),
                    np.stack([s, r])))
    return out


def _model(alias, route, seed=0, **pooler):
    """The served model's shape on the CPU: bf16 GCN layers, a mean
    readout; ``route`` "masked" runs K1's plain version over the CSR
    layout and pools in place, "compact" the generic layers and the
    compact pooled graph; ``pooler``: more of the pooler's arguments."""
    g = torch.Generator().manual_seed(seed)
    pool = get_pooler(alias, in_channels=HIDDEN, ratio=0.5, pool_mode=route,
                      device="cpu", generator=g, **pooler)
    return PoolingClassifier(
        pool, num_classes=3, hidden=HIDDEN, in_channels=F_IN,
        readout="mean", compute_dtype=torch.bfloat16,
        use_kernel=True if route == "masked" else None, device="cpu",
        generator=g).eval()


def _batch(route, seed=5):
    return from_graphs(_graphs(seed), sort_edges=route == "masked",
                       device="cpu")


def _padded(seed, nodes=256):
    """A compact-route batch padded to fixed sizes."""
    return from_graphs(_graphs(seed), pad_nodes=nodes, pad_edges=1024,
                       max_nodes=128, device="cpu")


class _HostTraffic(TorchDispatchMode):
    """Records the ops that would read the card's memory on the host or
    copy host memory to the card: the ops above, an index by a bool mask
    (a ``nonzero`` on the card), a copy to the CPU from another device,
    and a tensor made from host data (``torch.tensor``: a pageable copy
    to the card, which a capture refuses)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if func.overloadpacket in HOST_READS:
            self.found.append(name)
        elif func.overloadpacket in (aten.index, aten.index_put_,
                                     aten.index_put) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            self.found.append(name + " by a bool mask")
        elif func.overloadpacket in (aten.lift_fresh,
                                     aten.lift_fresh_copy):
            self.found.append(name + " from host data")
        elif (func.overloadpacket is aten._to_copy
              and kwargs.get("device") is not None
              and torch.device(kwargs["device"]).type == "cpu"
              and args[0].device.type != "cpu"):
            self.found.append(name + " to the host")
        return func(*args, **kwargs)


class _HostMethods(TorchFunctionMode):
    """Records the tensor methods that hand values to the host."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_METHODS or (name == "to" and "cpu" in args[1:]):
            self.found.append(name)
        return func(*args, **(kwargs or {}))


def test_topk_is_marked_capturable():
    assert CAPTURABLE == ["topk"]


@pytest.mark.parametrize("min_score", [None, MIN_SCORE])
@pytest.mark.parametrize("route", ["masked", "compact"])
@pytest.mark.parametrize("alias", CAPTURABLE)
def test_capturable_forward_reads_nothing_back(alias, route, min_score):
    """Every marked pooler's forward, on both routes and in each of its
    modes (top-k's ``min_score``), moves nothing between host and card."""
    model = _model(alias, route, min_score=min_score)
    batch = _batch(route)
    with torch.inference_mode():
        want, _ = model(batch)
        with _HostMethods() as methods, _HostTraffic() as reads:
            logits, out = model(batch)
    assert reads.found == [] and methods.found == []
    assert (out.so.extras.get("pool_mode") == "masked") == (
        route == "masked")
    assert torch.equal(logits, want)
    # the proof sees what it looks for
    with _HostMethods() as methods, _HostTraffic() as reads:
        out.so.node_sel_mask.sum().item()
        batch.x[out.so.node_sel_mask].numpy()
        torch.tensor(MIN_SCORE)
    assert reads.found[:2] == ["aten._local_scalar_dense.default",
                               "aten.index.Tensor by a bool mask"]
    assert reads.found[-1] == "aten.lift_fresh.default from host data"
    assert methods.found == ["item", "numpy"]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["cpu", "cpu-inference", "grad",
                                  "unmarked"])
def test_forward_is_the_eager_one_off_the_replay(case):
    """On the CPU, with a gradient taken, or with a pooler not marked
    capturable, a call dispatches exactly the eager forward's ops and
    gives its outputs; the span says ``"eager"`` and nothing is cached."""
    model = _model("sag" if case == "unmarked" else "topk", "masked")
    batch = _batch("masked")
    mode = {"cpu-inference": torch.inference_mode,
            "grad": torch.enable_grad}.get(case, torch.no_grad)
    with mode():
        with _Ops() as eager:
            want, _ = model._forward(batch)
        for _ in range(3):
            tracing.reset()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                with _Ops() as called:
                    got, _ = model(batch)
            assert called.ops == eager.ops
            assert torch.equal(got, want)
            (fwd,) = [r for r in tracing.spans()
                      if r["name"] == "tgp.model.forward"]
            assert fwd["attrs"]["graph"] == "eager"
    assert got.requires_grad == (case == "grad")
    assert len(model._graphs) == 0


@pytest.fixture
def stub(monkeypatch):
    return cuda_graph_stub.install(monkeypatch)


def test_signature_cache_order_and_eviction(stub):
    """Each signature runs eagerly, is captured on its second call and
    replayed after; past ``MAX_SIGNATURES`` the least recently used is
    dropped and starts over."""
    model, replay = _model("topk", "compact"), R.GraphReplay()
    fn = model._forward

    def call(batch):
        how, _ = replay.run(fn, batch, model)
        return how

    sizes = [_padded(1, 256 + k) for k in range(R.MAX_SIGNATURES + 1)]
    with torch.inference_mode():
        assert [call(sizes[0]) for _ in range(4)] == [
            "eager", "capture", "replay", "replay"]
        # another batch of the same shapes: the same signature
        assert call(_padded(2)) == "replay"
        assert [call(b) for b in sizes[1:]] == ["eager"] * R.MAX_SIGNATURES
        assert len(replay) == R.MAX_SIGNATURES
        # sizes[0] was used before sizes[1..]: dropped first
        assert call(sizes[0]) == "eager"
        assert call(sizes[2]) == "capture"
        assert call(sizes[1]) == "eager"
    assert stub.captured == 2 and stub.replayed == 5


def test_signature_follows_parameters_and_modes():
    model, batch = _model("topk", "compact"), _padded(5)
    key = R.signature(batch, model)
    with torch.no_grad():
        model.dense_1.weight.add_(1.0)  # in place: the graph reads it
    assert R.signature(batch, model) == key
    model.dense_1.weight = torch.nn.Parameter(model.dense_1.weight.clone())
    assert R.signature(batch, model) != key
    key = R.signature(batch, model)
    with torch.inference_mode():
        assert R.signature(batch, model) != key
    assert R.signature(batch.replace(num_graphs=4), model) != key
    assert R.signature(_batch("masked"), model) != key
    # other graphs padded alike: the same signature
    assert R.signature(_padded(7), model) == key


def test_each_caller_stream_has_graphs_of_its_own(stub):
    """The same batch called on two streams in turn: a signature on each,
    each captured on a capture stream of its own (a kernel's scratch is
    its stream's, so no two streams' replays share it) over static
    tensors of its own."""
    model, batch = _model("topk", "compact"), _padded(3)
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    hows = []
    with torch.inference_mode():
        for s in (a, b) * 3:
            with torch.cuda.stream(s):
                hows.append(model._graphs.run(model._forward, batch,
                                              model)[0])
    assert hows == ["eager"] * 2 + ["capture"] * 2 + ["replay"] * 2
    assert stub.captured == 2 and stub.replayed == 4
    streams = model._graphs._streams
    assert set(streams) == {a, b} and streams[a] is not streams[b]
    statics = [e.static.x for e in model._graphs._entries.values()]
    assert len(statics) == 2 and statics[0] is not statics[1]


def test_copies_of_a_model_start_with_no_graphs(stub):
    model, batch = _model("topk", "compact"), _batch("compact")
    with torch.inference_mode():
        model._graphs.run(model._forward, batch, model)
    assert len(model._graphs) == 1
    assert len(copy.deepcopy(model)._graphs) == 0
    assert len(pickle.loads(pickle.dumps(model))._graphs) == 0


def test_fresh_outputs_alias_the_callers_inputs():
    """The replay's outputs: an output that is a static input becomes the
    caller's tensor, others are copied out once each (aliases stay
    aliased), everything else is kept."""
    batch, static = _batch("masked"), _batch("masked", seed=6)
    cap = R._Captured.__new__(R._Captured)
    made = torch.arange(4.0)
    cap._keep((made, {"a": static.x, "b": [made, 7]},
               static.replace(x=made)),
              {id(static.x): "x", id(static.senders): "senders"})
    cap.graph = type("G", (), {"replay": lambda self: None})()
    a, d, g = cap.outputs(batch)
    assert a is not made and torch.equal(a, made) and d["b"][0] is a
    assert d["a"] is batch.x and d["b"][1] == 7
    assert g.x is a and g.senders is batch.senders
    assert g.receivers is not static.receivers and g.num_graphs == 3
    assert torch.equal(g.receivers, static.receivers)


def test_replayed_calls_return_outputs_of_their_own(stub):
    """Through the model with the stand-in graph: a replay's outputs are
    new tensors each call, but those that are the batch's own (the masked
    pooled graph shares the input's layout) are the caller's."""
    model = _model("topk", "masked")
    batches = [_batch("masked") for _ in range(4)]
    with torch.inference_mode():
        outs = [model(b) for b in batches]
    assert (stub.captured, stub.replayed) == (1, 3)
    for (logits, out), b in zip(outs[1:], batches[1:]):
        assert out.graph.senders is b.senders
        assert out.graph.row_ptr is b.row_ptr
        assert out.so.node_graph is b.node_graph
    masks = [out.so.node_sel_mask for _, out in outs]
    logits = [lg for lg, _ in outs]
    assert len({id(t) for t in masks + logits}) == 8
    for lg, m in zip(logits[1:], masks[1:]):
        assert torch.equal(lg, logits[0]) and torch.equal(m, masks[0])
