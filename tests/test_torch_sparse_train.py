"""The sparse large-graph training slice against the JAX package on the
same numpy inputs: ``spmm_csr``'s gradients (``d_h`` over the transpose
layout, ``d_w`` when asked) against JAX's custom VJP, including padding
edges and a masked ``w_t``; ``segment_sum_sorted``'s gradient; the
gradients of the masked pool's gate and of ``global_reduce``; and a
training step of the sparse ``PoolingClassifier`` (CSR GCN → masked top-k
→ CSR GCN → readout → head, the kernel path forced) against
``jax.value_and_grad`` + optax Adam.

JAX's Pallas kernels run in interpret mode; the port's kernels run their
plain versions on CPU tensors, through the same ``autograd.Function``s
the card runs.  Graphs are loop-free (the JAX CSR branch adds a second
unit loop where a graph has its own; the port follows ``gcn_norm``).
Tolerances: f32 1e-5 of each output's or leaf's max |value| (f32 sums in
another order); bf16 2e-2 of it (bf16 rounding at places the two
frameworks order differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp_tpu.graph import from_graphs as j_from
from tgp_tpu.models.classifiers import PoolingClassifier as JPC
from tgp_tpu.ops.pallas.segment_spmm import segment_sum_sorted as j_sss
from tgp_tpu.ops.pallas.segment_spmm import spmm_csr as j_spmm_csr
from tgp_tpu.poolers import get_pooler as j_get
from tgp_tpu.reduce.global_reduce import global_reduce as j_readout
from tgp_tpu_torch import PoolingClassifier, from_graphs, get_pooler
from tgp_tpu_torch.models.convert import params_from_flax
from tgp_tpu_torch.ops.kernels import segment_spmm as K
from tgp_tpu_torch.reduce.global_reduce import global_reduce as t_readout
from tests.test_torch_cuda_kernels import _csr_case, _layout

torch.set_num_threads(1)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} * {scale}"


def _rel(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


# ---------------------------------------------------------------------------
# spmm_csr and segment_sum_sorted gradients
# ---------------------------------------------------------------------------


def _masked_case(seed, F, n_pad):
    """``_csr_case`` with every edge out of a node ≡ 0 (mod 5) given weight
    0 in both orders, as masked pooling zeroes removed edges."""
    c = _csr_case(seed, F, n_pad=n_pad)
    c["w"] = np.where(c["s"] % 5 == 0, 0, c["w"]).astype(np.float32)
    c["w_t"] = np.where(c["s_t"] % 5 == 0, 0, c["w_t"]).astype(np.float32)
    return c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 8, 130])
@pytest.mark.parametrize("n_pad,grad_w", [(37, False), (37, True),
                                          (600, True)])
def test_spmm_csr_gradients_match_jax_vjp(n_pad, grad_w, F, dtype):
    """``d_h = Aᵀg`` over the transpose layout (w_t rounded to g's dtype),
    ``d_w = ⟨h[s], g[r]⟩`` when w takes a gradient, on a graph with
    padding edges (600 of them make row 0 of both layouts long) and
    masked weights."""
    c = _masked_case(F + n_pad, F, n_pad)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j_args = [jnp.asarray(a) for a in _layout(c, np.asarray)]

    def jf(h, w):
        return j_spmm_csr(h, w, *j_args[1:], c["n"], True)

    out, vjp = jax.vjp(jf, jnp.asarray(c["x"], jdt), j_args[0])
    g = np.random.default_rng(F).normal(size=out.shape).astype(np.float32)
    jdh, jdw = vjp(jnp.asarray(g, out.dtype))

    h = torch.tensor(c["x"]).to(tdt).requires_grad_()
    args = list(_layout(c, torch.tensor))
    args[0].requires_grad_(grad_w)
    got = K.spmm_csr(h, *args, c["n"])
    _close(got, out, 1e-5 if dtype == "float32" else 1e-2, "out")
    got.backward(torch.tensor(np.asarray(jnp.asarray(g, out.dtype),
                                         np.float32)).to(tdt))
    assert h.grad.dtype == tdt and h.grad.shape == h.shape
    _close(h.grad, jdh, _rel(dtype), "d_h")
    if grad_w:
        _close(args[0].grad, jdw, _rel(dtype), "d_w")
    else:
        assert args[0].grad is None
    assert args[1].grad is None  # w_t: no gradient


def test_spmm_csr_backward_runs_the_kernel_path_over_the_transpose(
        monkeypatch):
    """The backward calls the same kernel entry as the forward, counted on
    ``spmm_csr``, with the transpose layout: clipped ``receivers_t`` as
    the gather index and ``row_ptr_t`` as the offsets."""
    c = _csr_case(3, 4)
    calls = []
    real = K._csr_sum

    def spy(x, w, idx, row_ptr, num_rows, counter):
        calls.append((counter, row_ptr))
        return real(x, w, idx, row_ptr, num_rows, counter)

    monkeypatch.setattr(K, "_csr_sum", spy)
    args = _layout(c, torch.tensor)
    h = torch.tensor(c["x"], requires_grad=True)
    K.spmm_csr(h, *args, c["n"]).sum().backward()
    assert [k for k, _ in calls] == [K.spmm_csr, K.spmm_csr]
    assert calls[0][1] is args[4] and calls[1][1] is args[7]
    with torch.no_grad():  # no gradient: the transpose layout may be absent
        K.spmm_csr(h, args[0], None, args[2], None, args[4], None, None,
                   None, c["n"])
    with pytest.raises(ValueError, match="transpose layout"):
        K.spmm_csr(h, args[0], None, args[2], args[3], args[4], None, None,
                   None, c["n"])


@pytest.mark.parametrize("with_row_ptr", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_sorted_gradient_matches_jax(dtype, with_row_ptr):
    """The gather ``g[clip(receivers)]``: padding edges (receiver 0) get
    row 0's cotangent."""
    c = _csr_case(7, 6)
    msgs = (c["x"][c["s"]] * c["w"][:, None]).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rp = jnp.asarray(c["rp"]) if with_row_ptr else None
    out, vjp = jax.vjp(lambda m: j_sss(m, jnp.asarray(c["r"]), c["n"],
                                       interpret=True, row_ptr=rp),
                       jnp.asarray(msgs, jdt))
    g = np.random.default_rng(8).normal(size=out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g, jdt))
    tm = torch.tensor(msgs).to(tdt).requires_grad_()
    got = K.segment_sum_sorted(
        tm, torch.tensor(c["r"]), c["n"],
        row_ptr=torch.tensor(c["rp"]) if with_row_ptr else None)
    got.backward(torch.tensor(np.asarray(jnp.asarray(g, jdt), np.float32)
                              ).to(tdt))
    assert tm.grad.dtype == tdt
    np.testing.assert_array_equal(_np(tm.grad), _np(ref))


# ---------------------------------------------------------------------------
# the model's plain-torch pieces: the masked pool's gate, the readout
# ---------------------------------------------------------------------------


def _sparse_graphs(seed, count=1, n=2048, deg=8, feat=16):
    """Loop-free random graphs, about ``deg`` edges a node."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s, r = rng.integers(0, n, deg * n), rng.integers(0, n, deg * n)
        keep = s != r
        x = rng.normal(size=(n, feat)).astype(np.float32)
        out.append((x, np.stack([s[keep], r[keep]])))
    return out


def test_masked_pool_gate_gradient_matches_jax():
    """``weight = where(keep, score, 0)``, ``x * gate``: the gradients of
    a weighted sum of the pooled features for x and the selector."""
    graphs = _sparse_graphs(1, count=2, n=60, feat=6)
    jb = j_from(graphs, sort_edges=True)
    tb = from_graphs(graphs, sort_edges=True, device="cpu")
    jp = j_get("topk", in_channels=6, ratio=0.5, pool_mode="masked")
    params = jp.init(jax.random.key(0), jb)
    tp = get_pooler("topk", in_channels=6, ratio=0.5, pool_mode="masked",
                    device="cpu")
    tp.selector.weight.data = torch.tensor(
        np.asarray(params["params"]["selector"]["weight"]))
    R = np.random.default_rng(2).normal(size=np.asarray(jb.x).shape
                                        ).astype(np.float32)

    def jloss(p, x):
        out = jp.apply(p, jb.replace(x=x))
        return (out.graph.x * R).sum()

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jb.x)
    tx = tb.x.clone().requires_grad_()
    out = tp(tb.with_features(tx))
    assert out.so.extras.get("pool_mode") == "masked"
    (out.graph.x * torch.tensor(R)).sum().backward()
    _close(tx.grad, jg_x, 1e-5, "d_x")
    _close(tp.selector.weight.grad,
           jg_p["params"]["selector"]["weight"], 1e-5, "d_selector")


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_global_reduce_gradient_matches_jax(op):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    ng = np.sort(rng.integers(0, 3, 20)).astype(np.int32)
    nm = rng.random(20) > 0.3
    nm[ng == 2] = False  # an empty graph
    R = rng.normal(size=(4, 4)).astype(np.float32)

    def jloss(x):
        z = j_readout(x, node_graph=jnp.asarray(ng), num_graphs=4,
                      node_mask=jnp.asarray(nm), op=op)
        return (z * R).sum()

    ref = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    z = t_readout(tx, node_graph=torch.tensor(ng), num_graphs=4,
                  node_mask=torch.tensor(nm), op=op)
    (z * torch.tensor(R)).sum().backward()
    _close(tx.grad, ref, 1e-6)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

HIDDEN, F_IN = 16, 16
LABELS = np.array([1], np.int32)


def _model_pair(graphs, bf16):
    jb = j_from(graphs, sort_edges=True)
    jm = JPC(pooler=j_get("topk", in_channels=HIDDEN, ratio=0.5,
                          pool_mode="masked"),
             num_classes=3, hidden=HIDDEN, use_pallas=True,
             compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jm.init(jax.random.key(0), jb)
    tm = PoolingClassifier(
        get_pooler("topk", in_channels=HIDDEN, ratio=0.5, pool_mode="masked",
                   device="cpu"),
        num_classes=3, hidden=HIDDEN, in_channels=F_IN, use_kernel=True,
        compute_dtype=torch.bfloat16 if bf16 else None, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    tb = from_graphs(graphs, sort_edges=True, device="cpu")
    return jm, params, jb, tm, tb


def _jax_steps(jm, params, jb, steps):
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    y = jnp.asarray(LABELS)

    def loss_fn(p):
        logits, _ = jm.apply(p, jb)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, logits

    out = []
    for _ in range(steps):
        (loss, logits), grads = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(params)
        out.append((float(loss), logits, grads))
        upd, opt = tx.update(grads, opt)
        params = optax.apply_updates(params, upd)
    return out


def _torch_steps(tm, tb, steps):
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    y = torch.tensor(LABELS).long()
    out = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logits, pooled = tm(tb)
        assert pooled.so.extras.get("pool_mode") == "masked"
        loss = torch.nn.functional.cross_entropy(logits, y)
        loss.backward()
        out.append((float(loss.detach()), logits.detach(),
                    {k: v.grad.clone() for k, v in tm.named_parameters()}))
        opt.step()
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sparse_training_step_matches_jax(bf16):
    """Step one's loss, logits and every gradient leaf (mapped through
    ``params_from_flax``), then step two's loss and logits after one Adam
    update: N = 2,048, ~16k edges, F = 16, the CSR GCN branch and masked
    pooling."""
    graphs = _sparse_graphs(21)
    jm, params, jb, tm, tb = _model_pair(graphs, bf16)
    assert tb.num_edges >= 16_000 and tb.row_ptr is not None
    rel = 2e-2 if bf16 else 1e-5
    ref = _jax_steps(jm, params, jb, 2)
    got = _torch_steps(tm, tb, 2)
    for step, ((jl, jlog, jg), (tl, tlog, tg)) in enumerate(zip(ref, got)):
        assert np.isfinite(tl)
        # the sum readout's logits are large, so the loss falls near 0 by
        # step two: held to the tolerance of max(|loss|, 1)
        assert abs(tl - jl) <= rel * max(abs(jl), 1.0), (step, tl, jl)
        _close(tlog, jlog, rel, f"logits, step {step + 1}")
        if step:  # the softmax saturates: step two's gradients are noise
            continue
        want = params_from_flax(jax.tree.map(np.asarray, jg))
        assert set(want) == set(tg)
        for k, v in want.items():
            _close(tg[k], v, rel, f"{k}, step {step + 1}")


def test_sparse_training_step_runs_five_k1_passes(monkeypatch):
    """The pinned count: conv1's product, conv2's degree pass and product
    forward; the two products' ``d_h`` backward (no ``d_w``: the edge
    weights take no gradient, and the degree pass none at all).  Beside
    them the sum readout runs K4 (``sorted_segment_sum``'s kernel on the
    shape rule's route, through ``gather_segment_sum``) once, forward
    only: its gradient is a gather."""
    graphs = _sparse_graphs(22, n=300, deg=4)
    _, _, _, tm, tb = _model_pair(graphs, False)
    calls = []
    real, real_k4 = K._csr_sum, K._k4_sum

    def spy(x, w, idx, row_ptr, num_rows, counter):
        calls.append((counter.__name__, torch.is_grad_enabled()))
        return real(x, w, idx, row_ptr, num_rows, counter)

    def spy_k4(*args):
        calls.append(("sorted_segment_sum", torch.is_grad_enabled()))
        return real_k4(*args)

    monkeypatch.setattr(K, "_csr_sum", spy)
    monkeypatch.setattr(K, "_k4_sum", spy_k4)
    logits, _ = tm(tb)
    n_fwd = len(calls)
    torch.nn.functional.cross_entropy(
        logits, torch.tensor(LABELS).long()).backward()
    assert n_fwd == 4
    assert [c for c, _ in calls] == (["spmm_csr"] * 3 + ["sorted_segment_sum"]
                                     + ["spmm_csr"] * 2)
