"""The port's ``reduce/aggr.py`` (``get_aggr``'s 29 aliases and
``AggrReduce``) against ``tgp_tpu.reduce.aggr`` on the same seeded numpy
inputs, values and gradients (f32), the flax parameters carried over by
``params_from_flax`` (each leaf shifted by seeded noise, so no bias is 0).

Tolerance: every output within ``TOL`` = 1e-4 of the largest |value| of
JAX's output, every gradient leaf within ``TOL`` of its largest |value|
(the two packages add in other orders and fuse other ops).  JAX pads
every segment to ``_len_bucket(N)`` (32 here); the port pads ``lstm``,
``gru``, ``set_transformer``, ``graph_multiset_transformer``, ``lcm``,
``median`` and ``quantile`` to the longest valid segment, so these
comparisons also hold the trimmed budget against JAX's untrimmed one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu_torch.reduce.aggr as ta
from tests.float_scatter_spy import spy_with_k4_paused
from tgp_tpu.reduce import aggr as ja
from tgp_tpu.select.base import SelectOutput as JSelect
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.select.base import SelectOutput as TSelect

torch.set_num_threads(1)
TOL = 1e-4
N, C, F = 28, 6, 8
ALIASES = ta.aggr_aliases()
#: the aggregations whose budget the port trims to the longest segment
TRIMMED = ("lstm", "gru", "set_transformer", "graph_multiset_transformer",
           "lcm", "median", "quantile")
#: aggregations that size parameters from the budget: JAX's at N rows
SIZED = {"mlp": {"max_len": ja._len_bucket(N)},
         "patch_transformer": {"max_len": ja._len_bucket(N)}}


def _readout(seed=0):
    """``N`` rows in ``C`` segments, the last one empty, ~20% masked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    seg = rng.integers(0, C - 1, N).astype(np.int32)
    mask = rng.random(N) > 0.2
    return x, seg, mask


def _selection(seed=1):
    """A sparse assignment of the ``N`` rows to ``C`` clusters: weights,
    unselected rows, an empty cluster."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    ci = rng.integers(0, C - 1, N).astype(np.int32)
    w = rng.uniform(0.2, 1.5, N).astype(np.float32)
    sel = rng.random(N) > 0.25
    return x, ci, w, sel


def _shifted(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + scale * rng.normal(size=p.shape).astype(np.float32),
        params)


@functools.lru_cache(maxsize=None)
def _jax_init(alias, use, kw):
    """The flax parameters of ``AggrReduce(get_aggr(alias, **kw))`` on
    the case's data, from ``key(0)``: one jitted init (flax's eager init
    runs op by op), shared by the cases of one alias and use."""
    red = ja.AggrReduce(aggr=ja.get_aggr(alias, **dict(kw)))
    if use == "readout":
        x, seg, mask = _readout()
        return jax.jit(lambda key, x_: red.init(
            key, x_, None, node_graph=jnp.asarray(seg), num_graphs=C,
            node_mask=jnp.asarray(mask)))(jax.random.key(0), jnp.asarray(x))
    x, ci, w, sel = _selection()
    so = JSelect(cluster_index=jnp.asarray(ci), weight=jnp.asarray(w),
                 node_sel_mask=jnp.asarray(sel), num_clusters=C)
    return jax.jit(lambda key, x_: red.init(key, x_, so))(
        jax.random.key(0), jnp.asarray(x))


class _Case:
    """One alias as JAX's ``AggrReduce`` and the port's, with the JAX
    parameters carried over, applied as a readout or under a selection."""

    def __init__(self, alias, use, noise=0.1, offset=0.0, **kw):
        self.alias, self.use = alias, use
        if use == "readout":
            x, seg, mask = _readout()
            self.jargs = dict(node_graph=jnp.asarray(seg), num_graphs=C,
                              node_mask=jnp.asarray(mask))
            self.targs = dict(node_graph=torch.tensor(seg), num_graphs=C,
                              node_mask=torch.tensor(mask))
            self.jso = self.tso = None
        else:
            x, ci, w, sel = _selection()
            self.jso = JSelect(cluster_index=jnp.asarray(ci),
                               weight=jnp.asarray(w),
                               node_sel_mask=jnp.asarray(sel), num_clusters=C)
            self.tso = TSelect(cluster_index=torch.tensor(ci),
                               weight=torch.tensor(w),
                               node_sel_mask=torch.tensor(sel),
                               num_clusters=C)
            self.jargs = self.targs = {}
        self.x = x
        kw = {**SIZED.get(alias, {}), **kw}
        self.jred = ja.AggrReduce(aggr=ja.get_aggr(alias, **kw))
        params = _jax_init(alias, use, tuple(sorted(kw.items())))
        self.params = jax.tree_util.tree_map(lambda p: p + offset,
                                             _shifted(params, 7, noise))
        self.tred = ta.AggrReduce(alias, in_channels=F, device="cpu",
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
        if self.params:
            self.tred.load_state_dict(params_from_flax(self.params))

    def jax(self, x=None, params=None):
        x = jnp.asarray(self.x) if x is None else x
        return self.jred.apply(self.params if params is None else params, x,
                               self.jso, **self.jargs)

    def torch(self, x=None):
        x = torch.tensor(self.x) if x is None else x
        return self.tred(x, self.tso, **self.targs)


#: leaves whose gradient is 0 in exact arithmetic (besides every attention
#: block's key bias): the attentional gate's bias
_ZERO_GRADS = {"attentional": ("aggr.dense_0.bias",)}


def _close(got, ref, what, tol=TOL, scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if scale is None:
        scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all() and err <= tol * scale, (
        f"{what}: max |err| {err} > {tol} of {scale}")


def _ref_grads(case, R):
    """JAX's output and its gradients of Σ out·R by the input and by each
    parameter (named as the port's state_dict), one jitted call."""
    def loss(p, x):
        out = case.jax(x, p)
        return jnp.sum(out * R), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(case.params,
                                            jnp.asarray(case.x))
    return (np.asarray(out), np.asarray(gx),
            params_from_flax(gp) if case.params else {})


@functools.lru_cache(maxsize=None)
def _reference(alias, use):
    """``(case, R, JAX's output, d_x, d_params)`` of one alias and use,
    shared by the value and the gradient test."""
    case = _Case(alias, use)
    shape = jax.eval_shape(lambda x: case.jax(x), jnp.asarray(case.x)).shape
    R = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    return (case, R) + _ref_grads(case, R)


def _port_grads(case, R):
    x = torch.tensor(case.x, requires_grad=True)
    case.tred.zero_grad(set_to_none=True)
    (case.torch(x) * torch.tensor(R)).sum().backward()
    return x.grad.numpy(), {k: p.grad for k, p in
                            case.tred.named_parameters()}


def _param_refs(alias, ref):
    """Reference gradients of the bias slots flax does not have (each adds
    to another bias, so it takes that one's gradient): an LSTM's input
    bias its hidden bias's, a GRU's r and z hidden biases their input
    biases'."""
    ref = dict(ref)
    if alias == "set2set":
        ref["aggr.cell.bias_ih"] = ref["aggr.cell.bias_hh"]
    elif alias == "lstm":
        ref["aggr.rnn.bias_ih_l0"] = ref["aggr.rnn.bias_hh_l0"]
    elif alias == "gru":
        ref["aggr.rnn.bias_hh_l0"] = torch.cat(
            [ref["aggr.rnn.bias_ih_l0"][:2 * F],
             ref["aggr.rnn.bias_hh_l0"][2 * F:]])
    return ref


@pytest.mark.parametrize("use", ["readout", "select"])
@pytest.mark.parametrize("alias", ALIASES)
def test_aggr_matches_jax(alias, use):
    case, _, ref, _, _ = _reference(alias, use)
    got = case.torch()
    assert got.shape[0] == C
    if case.tred.out_channels is not None:
        assert got.shape[1] == case.tred.out_channels
    _close(got.detach().numpy(), ref, f"{alias} {use}")


@pytest.mark.parametrize("use", ["readout", "select"])
@pytest.mark.parametrize("alias", [a for a in ALIASES if a != "sort"])
def test_aggr_gradients_match_jax(alias, use):
    """Σ out·R by the input rows and, leaf by leaf, by every parameter
    (``sort`` has none and copies rows: its input gradient is a
    selection, held in ``test_aggr_matches_jax``'s values)."""
    case, R, _, gx_ref, gp_ref = _reference(alias, use)
    gx, gp = _port_grads(case, R)
    _close(gx, gx_ref, f"{alias} {use} d_x")
    gp_ref = _param_refs(alias, gp_ref)
    assert set(gp) == set(gp_ref), (set(gp) ^ set(gp_ref))
    for k, g in gp.items():
        # a bias that shifts every logit of a softmax equally takes a zero
        # gradient: rounding noise on both sides, held under its weight's
        # gradient scale
        zero = k in _ZERO_GRADS.get(alias, ()) or ".key.bias" in k
        _close(g.numpy(), gp_ref[k].numpy(), f"{alias} {use} d_{k}",
               scale=(float(gp_ref[k.replace("bias", "weight")].abs().max())
                      if zero else None))


def test_sort_gradient_routes_each_row():
    """``sort`` copies each segment's top rows: a row's gradient is R's
    slot it went to, as in JAX."""
    case, R, _, gx_ref, _ = _reference("sort", "readout")
    gx, _ = _port_grads(case, R)
    np.testing.assert_array_equal(gx, gx_ref)


@pytest.mark.parametrize("alias", TRIMMED)
def test_trimmed_budget_is_shorter_than_jax(alias, monkeypatch):
    """The port's budget is the longest valid segment (a power of two for
    ``lcm``), not JAX's ``_len_bucket(N)``: the comparisons above hold
    the trimmed sequences against JAX's untrimmed ones."""
    seen = []
    real = ta._to_padded_sequences

    def spy(x, seg, C_, mask, L, key=None):
        seen.append(L)
        return real(x, seg, C_, mask, L, key)

    monkeypatch.setattr(ta, "_to_padded_sequences", spy)
    x, seg, mask = _readout()
    longest = int(np.bincount(seg[mask], minlength=C).max())
    want = 1 << (longest - 1).bit_length() if alias == "lcm" else longest
    _reference(alias, "readout")[0].torch()
    assert seen == [want] and want < ja._len_bucket(N)


@pytest.mark.parametrize("alias", ["lstm", "gru"])
def test_recurrent_chunks_carry_the_state(alias, monkeypatch):
    """A sequence longer than ``RNN_CHUNK`` goes through the recurrent net
    in chunks, the state carried over: the same values and gradients as
    JAX's one scan."""
    monkeypatch.setattr(ta, "RNN_CHUNK", 3)
    case, R, ref, gx_ref, gp_ref = _reference(alias, "readout")
    _close(case.torch().detach().numpy(), ref, f"{alias} in chunks of 3")
    gx, gp = _port_grads(case, R)
    _close(gx, gx_ref, f"{alias} in chunks of 3: d_x")
    gp_ref = _param_refs(alias, gp_ref)
    for k, g in gp.items():
        _close(g.numpy(), gp_ref[k].numpy(), f"{alias} chunks d_{k}")


@pytest.mark.parametrize("alias", ["lstm", "gru", "set_transformer",
                                   "graph_multiset_transformer"])
def test_empty_segments_match_jax(alias):
    """Every leaf shifted by 0.3: an empty segment reads what JAX reads
    (the recurrent nets' step 0 on a zero input, the attention blocks'
    uniform attention over masked keys), not 0."""
    case = _Case(alias, "readout", noise=0.0, offset=0.3)
    got = case.torch().detach().numpy()
    ref = np.asarray(case.jax())
    assert np.abs(ref[C - 1]).max() > 1e-3  # the empty segment is not 0
    _close(got, ref, f"{alias} with an empty segment")


# --------------------------------------------------------------------------
# an explicit max_len truncates as in JAX (tests/reduce/test_aggr.py)
# --------------------------------------------------------------------------


def test_padded_sequences_truncate_as_jax():
    rng = np.random.default_rng(3)
    n, c, L = 50, 2, 8
    x = rng.normal(size=(n, 3)).astype(np.float32)
    seg = (np.arange(n) % c).astype(np.int32)
    mask = rng.random(n) > 0.1
    js, jm = ja._to_padded_sequences(jnp.asarray(x), jnp.asarray(seg), c,
                                     jnp.asarray(mask), L)
    ts, tm = ta._to_padded_sequences(torch.tensor(x), torch.tensor(seg), c,
                                     torch.tensor(mask), L)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("alias,kw", [("median", {"max_len": 16}),
                                      ("quantile", {"max_len": 16,
                                                    "q": 0.25}),
                                      ("lstm", {"max_len": 8}),
                                      ("gru", {"max_len": 8}),
                                      ("set_transformer", {"max_len": 8}),
                                      ("lcm", {"max_len": 5}),
                                      ("sort", {"k": 3})])
def test_explicit_max_len_truncates_as_jax(alias, kw):
    """One segment of 40 rows, a budget under it: the port keeps JAX's
    first rows (``lcm``: JAX's power of two above ``max_len``)."""
    rng = np.random.default_rng(6)
    n = 40
    x = rng.normal(size=(n, F)).astype(np.float32)
    jmod = ja.AggrReduce(aggr=ja.get_aggr(alias, **kw))
    args = dict(node_graph=jnp.zeros(n, jnp.int32), num_graphs=1,
                node_mask=jnp.ones(n, bool))
    params = _shifted(jax.jit(lambda key, x_: jmod.init(key, x_, None, **args))(
        jax.random.key(0), jnp.asarray(x)), 2)
    tmod = ta.AggrReduce(alias, in_channels=F, device="cpu", **kw)
    if params:
        tmod.load_state_dict(params_from_flax(params))
    got = tmod(torch.tensor(x), node_graph=torch.zeros(n, dtype=torch.int32),
               num_graphs=1, node_mask=torch.ones(n, dtype=torch.bool))
    ref = jax.jit(lambda p, x_: jmod.apply(p, x_, None, **args))(
        params, jnp.asarray(x))
    _close(got.detach().numpy(), np.asarray(ref), f"{alias} {kw}")


def test_equilibrium_outer_gradient_matches_jax_grad():
    """The outer gradient differentiates through the unrolled inner
    steps (``create_graph``): by the rows and every parameter, at other
    ``grad_iter`` and ``lamb`` than the defaults."""
    case = _Case("equilibrium", "select", grad_iter=3, lamb=0.5)
    R = np.random.default_rng(5).normal(size=(C, F)).astype(np.float32)
    _, gx_ref, gp_ref = _ref_grads(case, R)
    gx, gp = _port_grads(case, R)
    _close(gx, gx_ref, "equilibrium d_x")
    for k in ("aggr.log_lr", "aggr.pot1.weight", "aggr.pot2.bias"):
        assert float(gp[k].abs().max()) > 0
        _close(gp[k].numpy(), gp_ref[k].numpy(), f"equilibrium d_{k}")


def test_equilibrium_runs_under_no_grad_and_inference_mode():
    case = _reference("equilibrium", "readout")[0]
    ref = case.torch().detach()
    with torch.no_grad():
        assert torch.equal(case.torch(), ref)
    with torch.inference_mode():
        assert torch.equal(case.torch(), ref)


# --------------------------------------------------------------------------
# the factory and AggrReduce
# --------------------------------------------------------------------------


def test_get_aggr_knows_jax_aliases_and_filters_kwargs():
    assert ta.aggr_aliases() == ja.aggr_aliases() and len(ALIASES) == 29
    st = ta.get_aggr("set_transformer", in_channels=F, num_heads=2,
                     bogus_kwarg=1, device="cpu")
    assert st.attn_0.num_heads == 2
    x, seg, mask = (torch.tensor(a) for a in _readout())
    assert torch.equal(ta.get_aggr("SUM", bogus_kwarg=1)(x, seg, C, mask),
                       ta.get_aggr("sum")(x, seg, C, mask))
    custom = ta.get_aggr("multi", aggrs=("min", "sum"))(x, seg, C, mask)
    assert custom.shape == (C, 2 * F)
    with pytest.raises(ValueError, match="unknown aggregation"):
        ta.get_aggr("bogus")
    with pytest.raises(ValueError, match="in_channels"):
        ta.get_aggr("lstm", device="cpu")
    for alias in ("mlp", "patch_transformer"):
        with pytest.raises(ValueError, match="max_len"):
            ta.get_aggr(alias, in_channels=F, device="cpu")


def test_aggr_reduce_takes_a_callable_and_a_module():
    x, seg, mask = _readout()
    args = dict(node_graph=torch.tensor(seg), num_graphs=C,
                node_mask=torch.tensor(mask))

    def mean_of_squares(x, seg, C_, mask):
        from tgp_tpu_torch.ops.segment import segment_mean
        return segment_mean(x * x, seg, C_, mask=mask)

    got = ta.AggrReduce(mean_of_squares, device="cpu")(torch.tensor(x),
                                                        **args)
    for c in range(C - 1):
        sel = (seg == c) & mask
        np.testing.assert_allclose(got[c].numpy(), (x[sel] ** 2).mean(0),
                                   rtol=1e-5, atol=1e-6)
    mod = ta.get_aggr("deep_sets", in_channels=F, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    red = ta.AggrReduce(mod, device="cpu")
    assert red.out_channels == F and set(dict(red.named_parameters())) == {
        f"aggr.{k}" for k, _ in mod.named_parameters()}
    assert torch.equal(red(torch.tensor(x), **args),
                       mod(torch.tensor(x), torch.tensor(seg), C,
                           torch.tensor(mask)))


def test_aggr_reduce_rejects_a_dense_assignment():
    so = TSelect(in_mask=torch.ones(1, 4, dtype=torch.bool),
                 batched_s=torch.ones(1, 4, 2))
    with pytest.raises(ValueError, match="sparse assignments only"):
        ta.AggrReduce("sum", device="cpu")(torch.ones(4, F), so)


def test_aggr_reduce_without_a_mask_takes_every_row():
    x, seg, _ = _readout()
    got = ta.AggrReduce("median", device="cpu")(
        torch.tensor(x), node_graph=torch.tensor(seg), num_graphs=C)
    ref = ja.AggrReduce(aggr="median").apply(
        {}, jnp.asarray(x), None, node_graph=jnp.asarray(seg), num_graphs=C)
    _close(got.numpy(), np.asarray(ref), "median without a mask")


# --------------------------------------------------------------------------
# no float scatter in a forward or a backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use", ["readout", "select"])
def test_no_float_scatter_in_any_aggregation(use, monkeypatch):
    spy = spy_with_k4_paused(monkeypatch)
    for alias in ALIASES:
        case = _reference(alias, use)[0]
        x = torch.tensor(case.x, requires_grad=True)
        with spy:
            out = case.torch(x)
            (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)
             ).sum().backward()
        assert spy.seen == [], (alias, spy.seen)
    # the spy sees what it looks for, forward and backward
    x = torch.ones(3, requires_grad=True)
    with spy:
        torch.zeros(3).index_add_(0, torch.tensor([0, 0]), torch.ones(2))
        x[torch.tensor([0, 0])].sum().backward()
    assert spy.seen == ["index_add_", "index_put"]
