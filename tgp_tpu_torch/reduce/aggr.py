"""Aggregation reducers (port of ``tgp_tpu/reduce/aggr.py``): the
``get_aggr`` alias factory (the same 29 names), the aggregations behind
it and ``AggrReduce``.

Each aggregation takes the packed layout ``(x [N,F], seg [N], C, mask
[N])`` with ids in ``[0, C)`` (``AggrReduce`` drops rows outside it) and
returns ``[C, F']``.  Every float sum, forward and backward, adds in a
fixed order: the sums are :func:`~tgp_tpu_torch.ops.segment.segment_sum`
(K4 after a stable sort), a gather of a segment's value back to its rows
is :func:`~tgp_tpu_torch.ops.segment.gather_rows` (its gradient the same
sum), and the per-segment padded sequences are written by one indexed
write of the kept rows, whose ``(segment, rank)`` cells are unique, so
their gradient is a gather.  No float ``index_add_``, ``scatter_add`` or
accumulating ``index_put_`` runs in a forward or a backward.

Sequence budget.  JAX pads every segment to ``_len_bucket(N)`` when
``max_len`` is None.  Where no parameter depends on it (``lstm``,
``gru``, ``set_transformer``, ``graph_multiset_transformer``, ``lcm``,
``median``, ``quantile``) the port pads to the longest valid segment
instead (at least 1, capped by JAX's budget, a power of two for ``lcm``;
one host read a call): the valid outputs are JAX's, since padded keys are
masked, padded recurrent steps come after each segment's last one and
``lcm``'s extra tree levels pass single operands through.  ``mlp`` and
``patch_transformer`` size their parameters from the budget, so the port
needs their ``max_len`` when they are built (JAX's default is
``_len_bucket(N)`` of the batch they first see).

Learnable aggregations are ``nn.Module``s built at their input width
(``in_channels``), their weights drawn from an explicit
``torch.Generator`` as flax initialises them; their parameter names map
onto the flax tree (:func:`~tgp_tpu_torch.models.convert.
params_from_flax`).  ``lstm`` and ``gru`` are ``torch.nn.LSTM`` and
``torch.nn.GRU`` (one layer, ``batch_first``) run unpacked over the
padded sequences; an empty segment reads the output of step 0 on a zero
input, as JAX does.  Attention keeps flax's conventions: the query scaled
by ``1/sqrt(head_dim)``, masked logits set to the dtype's minimum (a
fully masked row attends uniformly), ``LayerNorm`` with ε = 1e-6.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.segment import (_bcast, gather_rows, segment_count,
                                       segment_max, segment_mean,
                                       segment_min, segment_sum,
                                       segment_topk_rank)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["get_aggr", "AggrReduce", "aggr_aliases"]

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# segment pieces whose gradients add in a fixed order
# --------------------------------------------------------------------------


class _SegmentExtreme(torch.autograd.Function):
    """Masked segment max or min; the gradient goes to the rows equal to
    their segment's extreme, split evenly among ties (JAX's rule), the
    tie counts an integer sum: no float scatter."""

    @staticmethod
    def forward(ctx, x, seg, keep, num_segments, reduce):
        fn = segment_max if reduce == "amax" else segment_min
        out = fn(x, seg, num_segments, mask=keep)
        ctx.save_for_backward(x, seg, keep, out)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        x, seg, keep, out = ctx.saved_tensors
        ids = seg.long()
        hit = _bcast(keep, x) & (x == out[ids])
        ties = segment_sum(hit.to(torch.int32), seg, ctx.num_segments)
        d_x = torch.where(hit, g[ids] / torch.clamp(ties[ids], min=1), 0.0)
        return d_x, None, None, None, None


def _softmax(scores: Tensor, seg: Tensor, C: int, mask: Tensor) -> Tensor:
    """Per-segment softmax (masked entries 0).  The shift by the segment
    max is a constant of the gradient (a softmax does not depend on it),
    and the normalizer is gathered by ``gather_rows``."""
    ids = seg.long()
    with torch.no_grad():
        m = segment_max(scores, seg, C, mask=mask)
        m = torch.where(torch.isfinite(m), m, 0.0)[ids]
    e = torch.where(_bcast(mask, scores), torch.exp(scores - m), 0.0)
    denom = torch.clamp(segment_sum(e, seg, C), min=1e-16)
    return e / gather_rows(denom, ids, C)


# --------------------------------------------------------------------------
# stateless aggregations
# --------------------------------------------------------------------------


def _agg_sum(x, seg, C, mask):
    return segment_sum(x, seg, C, mask=mask)


def _agg_mean(x, seg, C, mask):
    return segment_mean(x, seg, C, mask=mask)


def _agg_max(x, seg, C, mask):
    out = _SegmentExtreme.apply(x, seg, mask, C, "amax")
    return torch.where(torch.isfinite(out), out, 0.0)


def _agg_min(x, seg, C, mask):
    out = _SegmentExtreme.apply(x, seg, mask, C, "amin")
    return torch.where(torch.isfinite(out), out, 0.0)


def _agg_mul(x, seg, C, mask):
    m = mask[:, None]
    logx = torch.where(m, torch.log(torch.clamp(x.abs(), min=1e-20)), 0.0)
    neg = segment_sum((m & (x < 0)).to(torch.int32), seg, C)
    return (torch.exp(segment_sum(logx, seg, C))
            * torch.where(neg % 2 == 1, -1.0, 1.0))


def _agg_var(x, seg, C, mask):
    m = segment_mean(x, seg, C, mask=mask)
    sq = segment_mean(x * x, seg, C, mask=mask)
    return torch.clamp(sq - m * m, min=0.0)


def _agg_std(x, seg, C, mask):
    return torch.sqrt(_agg_var(x, seg, C, mask) + 1e-12)


def _agg_softmax(x, seg, C, mask):
    return segment_sum(_softmax(x, seg, C, mask) * x, seg, C)


def _agg_powermean(x, seg, C, mask, p: float = 2.0):
    xp = torch.pow(torch.clamp(x, min=1e-8), p)
    return torch.pow(segment_mean(xp, seg, C, mask=mask), 1.0 / p)


def _agg_variance_preserving(x, seg, C, mask):
    n = torch.clamp(segment_count(seg, C, mask=mask), min=1).to(x.dtype)
    return segment_sum(x, seg, C, mask=mask) / torch.sqrt(n)[:, None]


def _agg_degree_scaler(x, seg, C, mask):
    """PNA's degree scalers: the mean scaled by [identity,
    log-amplification, log-attenuation], concatenated → 3F; the batch's
    average log-degree is taken over the occupied segments only."""
    cnt = segment_count(seg, C, mask=mask).to(x.dtype)
    nonempty = (cnt > 0).to(x.dtype)
    log_n = torch.log(torch.clamp(cnt, min=1) + 1.0)
    mean = segment_mean(x, seg, C, mask=mask)
    avg_log = torch.clamp(torch.sum(log_n * nonempty)
                          / torch.clamp(torch.sum(nonempty), min=1.0),
                          min=1e-6)
    log_n = log_n[:, None]
    return torch.cat([mean, mean * (log_n / avg_log),
                      mean * (avg_log / log_n)], dim=-1)


def _agg_multi(x, seg, C, mask, aggrs=("mean", "max", "sum")):
    """Several aggregations concatenated."""
    return torch.cat([_STATELESS[a](x, seg, C, mask) for a in aggrs], -1)


# --------------------------------------------------------------------------
# per-segment padded sequences
# --------------------------------------------------------------------------


def _len_bucket(n: int) -> int:
    """A length bound rounded up to a power of two (at least 4)."""
    return max(4, 1 << (max(int(n), 1) - 1).bit_length())


def _resolve_len(max_len, x) -> int:
    """JAX's sequence budget: ``max_len``, else ``_len_bucket`` of the
    row count."""
    if max_len is not None:
        return int(max_len)
    return _len_bucket(x.shape[0])


def _longest(seg, C, mask) -> int:
    """The longest segment's valid row count (a host read), at least 1."""
    if seg.shape[0] == 0:
        return 1
    return max(1, int(segment_count(seg, C, mask=mask).max()))


def _to_padded_sequences(x, seg, C, mask, L, key=None):
    """``[N, F]`` → ``[C, L, F]`` and the length mask ``[C, L]``, each
    segment's valid rows in ascending row order (or by descending
    ``key``), rows ranked ``≥ L`` dropped (truncation).  One indexed
    write of the kept rows (their cells are unique; the rest go to a
    discarded slot), so the gradient is a gather."""
    n = x.shape[0]
    if key is None:
        key = -torch.arange(n, dtype=torch.float32, device=x.device)
    rank = segment_topk_rank(key.detach(), seg, C, mask=mask).long()
    ids = seg.long()
    keep = mask & (rank < L) & (ids >= 0) & (ids < C)
    cell = torch.where(keep, ids * L + rank, C * L)
    flat = x.new_zeros((C * L + 1,) + x.shape[1:]).index_put((cell,), x)
    lmask = torch.zeros(C * L + 1, dtype=torch.bool,
                        device=x.device).index_put((cell,), keep)
    return (flat[:C * L].reshape((C, L) + x.shape[1:]),
            lmask[:C * L].reshape(C, L))


def _pick(seqs: Tensor, pos: Tensor) -> Tensor:
    """``seqs[c, pos[c]]`` for ``seqs [C, L, F]``: a select and a sum of
    zeros (exact), so the gradient is elementwise."""
    hit = torch.arange(seqs.shape[1], device=seqs.device)[None] == pos[:, None]
    return torch.where(hit[..., None], seqs, 0.0).sum(1)


def _agg_quantile(x, seg, C, mask, L: int, q: float = 0.5):
    """Per-segment q-quantile ('lower' interpolation) of the first ``L``
    rows; 0 for an empty segment."""
    L = min(L, _longest(seg, C, mask))
    seqs, lmask = _to_padded_sequences(x, seg, C, mask, L)
    srt = torch.sort(torch.where(lmask[..., None], seqs, torch.inf),
                     dim=1).values
    n = torch.clamp(lmask.sum(-1), min=1)
    idx = torch.clamp((q * (n - 1).to(torch.float32)).to(torch.int64),
                      0, L - 1)
    out = _pick(srt, idx)
    return torch.where(torch.isfinite(out), out, 0.0)


def _agg_median(x, seg, C, mask, L: int):
    return _agg_quantile(x, seg, C, mask, L, q=0.5)


# --------------------------------------------------------------------------
# learnable aggregations
# --------------------------------------------------------------------------


def _normal(shape, std, generator):
    return nn.Parameter(torch.empty(shape).normal_(0.0, std,
                                                   generator=generator))


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)  # flax's epsilon


def _heads_width(width: int, heads: int) -> int:
    return ((width + heads - 1) // heads) * heads


class _Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention``: query, key and value
    projections to ``num_heads`` heads of ``qkv // num_heads``, the query
    scaled by ``1/sqrt(head_dim)``, logits where ``mask`` is False set to
    the dtype's minimum, softmax, the output projection to ``out``."""

    def __init__(self, width: int, qkv: int, out: int, num_heads: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.num_heads = num_heads
        self.query = lecun_normal_linear(width, qkv, generator=generator)
        self.key = lecun_normal_linear(width, qkv, generator=generator)
        self.value = lecun_normal_linear(width, qkv, generator=generator)
        self.out = lecun_normal_linear(qkv, out, generator=generator)

    def _heads(self, t: Tensor) -> Tensor:
        return t.reshape(t.shape[:-1] + (self.num_heads, -1)).transpose(-2,
                                                                         -3)

    def forward(self, q_in: Tensor, kv_in: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        q, k, v = (self._heads(lin(t)) for lin, t in
                   ((self.query, q_in), (self.key, kv_in),
                    (self.value, kv_in)))
        q = q / math.sqrt(q.shape[-1])
        logits = q @ k.transpose(-1, -2)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        o = torch.softmax(logits, dim=-1) @ v
        return self.out(o.transpose(-2, -3).flatten(-2))


def _recurrent_init(rnn: nn.Module, gates: int, width: int,
                    generator: Optional[torch.Generator]) -> None:
    """flax's cell initialisation on a torch LSTM/GRU: each gate's input
    kernel lecun-normal, its recurrent kernel orthogonal, biases 0."""
    for name, p in rnn.named_parameters():
        with torch.no_grad():
            if name.startswith("bias"):
                p.zero_()
                continue
            for block in p.split(width, dim=0)[:gates]:
                if name.startswith("weight_ih"):
                    n_in = block.shape[1]
                    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
                    nn.init.trunc_normal_(block, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                else:
                    nn.init.orthogonal_(block, generator=generator)


class AttentionalAggregation(nn.Module):
    """Gate-MLP attention pooling: ``Σ softmax(gate(x)) · nn(x)``."""

    def __init__(self, in_channels: int, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = in_channels
        self.dense_0 = lecun_normal_linear(in_channels, 1,
                                           generator=generator)
        self.dense_1 = lecun_normal_linear(in_channels, in_channels,
                                           generator=generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        w = _softmax(self.dense_0(x)[:, 0], seg, C, mask)
        return segment_sum(w[:, None] * self.dense_1(x), seg, C)


class Set2Set(nn.Module):
    """Set2Set: an LSTM cell (from a zero carry) drives
    ``processing_steps`` rounds of attention over each segment; output
    ``2F``."""

    def __init__(self, in_channels: int, processing_steps: int = 3, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.processing_steps = processing_steps
        self.out_channels = 2 * in_channels
        self.cell = nn.LSTMCell(2 * in_channels, in_channels)
        _recurrent_init(self.cell, 4, in_channels, generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        F_ = x.shape[-1]
        ids = seg.long()
        h = x.new_zeros(C, F_)
        c = x.new_zeros(C, F_)
        q_star = x.new_zeros(C, 2 * F_)
        for _ in range(self.processing_steps):
            h, c = self.cell(q_star, (h, c))
            e = (x * gather_rows(h, ids, C)).sum(-1)
            a = _softmax(e, seg, C, mask)
            r = segment_sum(a[:, None] * x, seg, C)
            q_star = torch.cat([h, r], -1)
        return q_star


#: steps of one recurrent call: cuDNN refuses an LSTM or GRU over 65,536
#: steps of batch 1 (it runs 49,152 on the H100), so a longer sequence goes
#: through in chunks of this many steps, the state carried from one to the
#: next
RNN_CHUNK = 1 << 14


class _RecurrentAggregation(nn.Module):
    """A one-layer recurrent net over each segment's rows in row order;
    the output at each segment's last valid step (step 0 for an empty
    segment)."""

    def __init__(self, rnn: nn.Module, gates: int, in_channels: int,
                 max_len: Optional[int], device, generator):
        super().__init__()
        self.max_len = max_len
        self.out_channels = in_channels
        self.rnn = rnn
        _recurrent_init(self.rnn, gates, in_channels, generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        L = min(_resolve_len(self.max_len, x), _longest(seg, C, mask))
        seqs, lmask = _to_padded_sequences(x, seg, C, mask, L)
        outs, state = [], None
        for t in range(0, L, RNN_CHUNK):
            out, state = self.rnn(seqs[:, t:t + RNN_CHUNK].contiguous(),
                                  state)
            outs.append(out)
        return _pick(torch.cat(outs, 1),
                     torch.clamp(lmask.sum(-1) - 1, 0, L - 1))


class LSTMAggregation(_RecurrentAggregation):
    """Order-sensitive LSTM over each segment's rows (``nn.LSTM``)."""

    def __init__(self, in_channels: int, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(nn.LSTM(in_channels, in_channels, batch_first=True),
                         4, in_channels, max_len, device, generator)


class GRUAggregation(_RecurrentAggregation):
    """Order-sensitive GRU over each segment's rows (``nn.GRU``)."""

    def __init__(self, in_channels: int, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(nn.GRU(in_channels, in_channels, batch_first=True),
                         3, in_channels, max_len, device, generator)


class SetTransformerAggregation(nn.Module):
    """Set Transformer pooling: the rows projected to a head-divisible
    width, a self-attention block over each segment's set, then
    ``num_seeds`` learned seeds attend over it (their outputs averaged)."""

    def __init__(self, in_channels: int, num_heads: int = 4,
                 num_seeds: int = 1, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len = max_len
        w = _heads_width(in_channels, num_heads)
        self.out_channels = w
        self.dense_0 = lecun_normal_linear(in_channels, w,
                                           generator=generator)
        self.attn_0 = _Attention(w, w, w, num_heads, generator)
        self.norm_0 = _layer_norm(w)
        self.seeds = _normal((num_seeds, w), 0.02, generator)
        self.attn_1 = _Attention(w, w, w, num_heads, generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        x = self.dense_0(x)
        L = min(_resolve_len(self.max_len, x), _longest(seg, C, mask))
        seqs, lmask = _to_padded_sequences(x, seg, C, mask, L)
        keys = lmask[:, None, None, :]
        h = self.attn_0(seqs, seqs, keys & lmask[:, None, :, None])
        h = self.norm_0(seqs + h) * lmask[..., None]
        q = self.seeds[None].expand(C, -1, -1)
        return self.attn_1(q, h, keys).mean(1)


class EquilibriumAggregation(nn.Module):
    """Equilibrium aggregation: the output ``y`` minimises ``E(y) =
    λ‖y‖² + Σ_i softplus(MLP([x_i; y_seg(i)]))`` by ``grad_iter``
    unrolled gradient steps with a learned step size; the outer gradient
    differentiates through them (``torch.autograd.grad`` with
    ``create_graph``)."""

    def __init__(self, in_channels: int, grad_iter: int = 5,
                 lamb: float = 0.1, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grad_iter = grad_iter
        self.lamb = lamb
        self.out_channels = in_channels
        self.pot1 = lecun_normal_linear(2 * in_channels, in_channels,
                                        generator=generator)
        self.pot2 = lecun_normal_linear(in_channels, 1, generator=generator)
        self.log_lr = nn.Parameter(torch.zeros(()))
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        outer = torch.is_grad_enabled()
        # the inner gradients need autograd, also under no_grad or
        # inference_mode (where the inputs are copied out of it)
        with torch.inference_mode(False), torch.enable_grad():
            if x.is_inference():
                x, seg, mask = x.clone(), seg.clone(), mask.clone()
            ids = seg.long()
            y = x.new_zeros(C, x.shape[-1]).requires_grad_()
            lr = torch.exp(self.log_lr) * 0.1
            for _ in range(self.grad_iter):
                h = torch.cat([x, gather_rows(y, ids, C)], -1)
                pot = F.softplus(self.pot2(F.relu(self.pot1(h))))[:, 0]
                energy = (self.lamb * torch.sum(y * y)
                          + torch.sum(torch.where(mask, pot, 0.0)))
                g, = torch.autograd.grad(energy, y, create_graph=outer)
                y = y - lr * g
        return y if outer else y.detach()


class LCMAggregation(nn.Module):
    """Learnable commutative monoid: each segment's rows reduced by a
    learned binary combine along a balanced binary tree; a (valid,
    invalid) pair passes the valid operand through."""

    def __init__(self, in_channels: int, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len = max_len
        self.out_channels = in_channels
        kw = dict(generator=generator)
        self.proj = lecun_normal_linear(in_channels, in_channels, **kw)
        self.comb1 = lecun_normal_linear(2 * in_channels, in_channels, **kw)
        self.comb2 = lecun_normal_linear(in_channels, in_channels, **kw)
        self.norm = _layer_norm(in_channels)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        def pow2(n):
            return 1 << max(1, (n - 1).bit_length())

        L = min(pow2(_resolve_len(self.max_len, x)),
                pow2(_longest(seg, C, mask)))
        seqs, valid = _to_padded_sequences(x, seg, C, mask, L)
        h = self.proj(seqs)
        while h.shape[1] > 1:
            a, b = h[:, 0::2], h[:, 1::2]
            va, vb = valid[:, 0::2, None], valid[:, 1::2, None]
            merged = self.norm(self.comb2(F.relu(self.comb1(
                torch.cat([a, b], -1)))))
            h = torch.where(va & vb, merged, torch.where(
                va, a, torch.where(vb, b, 0.0)))
            valid = (va | vb)[..., 0]
        return h[:, 0]


class PatchTransformerAggregation(nn.Module):
    """Patch transformer: each segment's rows (padded to ``max_len``)
    cut into ``patch_size`` patches, each embedded by a dense layer plus a
    learned position, one attention block over the patches, then mean,
    max and sum of the patches concatenated and projected back to F.
    ``max_len`` sizes the position table, so it is required."""

    def __init__(self, in_channels: int, patch_size: int = 4,
                 num_heads: int = 2, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if max_len is None:
            raise ValueError(
                "patch_transformer sizes its position table from max_len: "
                "pass max_len (JAX's default is _len_bucket(N) of the first "
                "batch)")
        self.patch_size = patch_size
        self.max_len = max_len
        self.out_channels = in_channels
        w = _heads_width(in_channels, num_heads)
        P = (max_len + patch_size - 1) // patch_size
        kw = dict(generator=generator)
        self.patch_mlp = lecun_normal_linear(patch_size * in_channels, w, **kw)
        self.pos = _normal((P, w), 0.02, generator)
        self.attn_0 = _Attention(w, w, w, num_heads, generator)
        self.norm_0 = _layer_norm(w)
        self.out = lecun_normal_linear(3 * w, in_channels, **kw)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        P = self.pos.shape[0]
        seqs, lmask = _to_padded_sequences(x, seg, C, mask,
                                           P * self.patch_size)
        h = self.patch_mlp(seqs.reshape(C, P, -1)) + self.pos
        pm = lmask.reshape(C, P, self.patch_size).any(-1)
        h = self.norm_0(h + self.attn_0(h, h, pm[:, None, None, :]
                                        & pm[:, None, :, None]))
        h = h * pm[..., None]
        mean = h.sum(1) / torch.clamp(pm.sum(-1, keepdim=True), min=1)
        mx = torch.where(pm[..., None], h, -torch.inf).amax(1)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        return self.out(torch.cat([mean, mx, h.sum(1)], -1))


class GraphMultisetTransformer(nn.Module):
    """Graph multiset transformer readout: ``k`` seeds attend over each
    segment's rows, a self-attention block over the ``k`` tokens, then
    one seed attends over them."""

    def __init__(self, in_channels: int, k: int = 4, num_heads: int = 2,
                 max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len = max_len
        w = _heads_width(in_channels, num_heads)
        self.out_channels = w
        self.dense_0 = lecun_normal_linear(in_channels, w,
                                           generator=generator)
        self.seeds = _normal((k, w), 0.02, generator)
        self.attn_0 = _Attention(w, w, w, num_heads, generator)
        self.attn_1 = _Attention(w, w, w, num_heads, generator)
        self.norm_0 = _layer_norm(w)
        self.seed_out = _normal((1, w), 0.02, generator)
        self.attn_2 = _Attention(w, w, w, num_heads, generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        x = self.dense_0(x)
        L = min(_resolve_len(self.max_len, x), _longest(seg, C, mask))
        seqs, lmask = _to_padded_sequences(x, seg, C, mask, L)
        h = self.attn_0(self.seeds[None].expand(C, -1, -1), seqs,
                        lmask[:, None, None, :])
        h = self.norm_0(h + self.attn_1(h, h))
        return self.attn_2(self.seed_out[None].expand(C, -1, -1), h)[:, 0]


class SortAggregation(nn.Module):
    """Sort pooling: each segment's top ``k`` rows by the last feature,
    concatenated (``k·F``; missing rows are zeros)."""

    def __init__(self, in_channels: int, k: int = 4, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.out_channels = k * in_channels
        resolve_device(device)

    def forward(self, x, seg, C, mask):
        seqs, _ = _to_padded_sequences(x, seg, C, mask, max(self.k, 4),
                                       key=x[:, -1])
        return seqs[:, :self.k].reshape(C, -1)


class DeepSetsAggregation(nn.Module):
    """``ρ(Σ φ(x))`` with two-layer ``φ`` and one-layer ``ρ``."""

    def __init__(self, in_channels: int, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = in_channels
        kw = dict(generator=generator)
        # flax's creation order: Dense_0 the outer layer of φ, Dense_1 its
        # inner one, Dense_2 ρ
        self.dense_0 = lecun_normal_linear(in_channels, in_channels, **kw)
        self.dense_1 = lecun_normal_linear(in_channels, in_channels, **kw)
        self.dense_2 = lecun_normal_linear(in_channels, in_channels, **kw)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        h = self.dense_0(F.relu(self.dense_1(x)))
        return self.dense_2(F.relu(segment_sum(h, seg, C, mask=mask)))


class MLPAggregation(nn.Module):
    """One dense layer over each segment's rows padded to ``max_len`` and
    flattened; ``max_len`` sizes the layer, so it is required."""

    def __init__(self, in_channels: int, max_len: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if max_len is None:
            raise ValueError(
                "mlp sizes its layer from max_len: pass max_len (JAX's "
                "default is _len_bucket(N) of the first batch)")
        self.max_len = max_len
        self.out_channels = in_channels
        self.dense_0 = lecun_normal_linear(max_len * in_channels,
                                           in_channels, generator=generator)
        self.to(resolve_device(device))

    def forward(self, x, seg, C, mask):
        seqs, _ = _to_padded_sequences(x, seg, C, mask, self.max_len)
        return self.dense_0(seqs.reshape(C, -1))


_STATELESS: Dict[str, Callable] = {
    "sum": _agg_sum, "add": _agg_sum, "mean": _agg_mean, "avg": _agg_mean,
    "max": _agg_max, "min": _agg_min, "mul": _agg_mul, "var": _agg_var,
    "std": _agg_std, "softmax": _agg_softmax, "powermean": _agg_powermean,
    "power_mean": _agg_powermean,
    "variance_preserving": _agg_variance_preserving,
    "degree_scaler": _agg_degree_scaler,
    "multi": _agg_multi,
}

_LEARNABLE = {
    "attentional": AttentionalAggregation,
    "set2set": Set2Set,
    "lstm": LSTMAggregation,
    "gru": GRUAggregation,
    "sort": SortAggregation,
    "deep_sets": DeepSetsAggregation,
    "mlp": MLPAggregation,
    "set_transformer": SetTransformerAggregation,
    "equilibrium": EquilibriumAggregation,
    "lcm": LCMAggregation,
    "patch_transformer": PatchTransformerAggregation,
    "graph_multiset_transformer": GraphMultisetTransformer,
}


def aggr_aliases():
    return sorted(set(_STATELESS) | set(_LEARNABLE) | {"median", "quantile"})


def _accepted(fn, kwargs, skip=0):
    names = list(inspect.signature(fn).parameters)[skip:]
    return {k: v for k, v in kwargs.items() if k in names}


def get_aggr(alias: str, **kwargs):
    """Alias → aggregation, kwargs filtered against what it takes
    (unknown ones are dropped).  A stateless alias gives a function of
    ``(x, seg, C, mask)``; a learnable one an ``nn.Module`` built at
    ``in_channels`` on ``device`` (default ``"cuda"``) from
    ``generator``."""
    alias = alias.lower()
    if alias in _STATELESS:
        fn = _STATELESS[alias]
        kw = _accepted(fn, kwargs, skip=4)
        if kw:
            return lambda x, seg, C, mask: fn(x, seg, C, mask, **kw)
        return fn
    if alias in ("median", "quantile"):
        L = kwargs.get("max_len")
        q = kwargs.get("q", 0.5) if alias == "quantile" else 0.5
        return lambda x, seg, C, mask: _agg_quantile(
            x, seg, C, mask, _resolve_len(L, x), q)
    if alias in _LEARNABLE:
        cls = _LEARNABLE[alias]
        if kwargs.get("in_channels") is None:
            raise ValueError(f"the learnable aggregation {alias!r} needs "
                             "in_channels")
        return cls(**_accepted(cls.__init__, kwargs, skip=1))
    raise ValueError(
        f"unknown aggregation {alias!r}; available: {aggr_aliases()}")


def _widens(alias: str, kwargs) -> int:
    """Output width over input width of a stateless aggregation (1 for
    the others: a module states its own ``out_channels``)."""
    if alias == "multi":
        return sum(_widens(a, {}) for a in kwargs.get(
            "aggrs", ("mean", "max", "sum")))
    return 3 if alias == "degree_scaler" else 1


class AggrReduce(nn.Module):
    """Reduce with any aggregation over the sparse assignment; ``so=None``
    reads each graph out (``node_graph``, ``num_graphs``, ``node_mask``).

    ``aggr``: an alias (built here by :func:`get_aggr` with
    ``in_channels``, ``device``, ``generator`` and the other kwargs), a
    callable of ``(x, seg, C, mask)`` or a module.  Under a
    ``SelectOutput`` the rows are weighted by ``so.weight``; a dense
    assignment is refused.  ``out_channels`` is the output width where it
    is known (None for a callable)."""

    def __init__(self, aggr: Any = "sum", in_channels: Optional[int] = None,
                 *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        device = resolve_device(device)
        width = None
        if isinstance(aggr, str):
            name = aggr.lower()
            aggr = get_aggr(name, in_channels=in_channels, device=device,
                            generator=generator, **kwargs)
            if in_channels is not None:
                width = _widens(name, kwargs) * in_channels
        self.out_channels = getattr(aggr, "out_channels", width)
        self.aggr = aggr

    def forward(self, x: Tensor, so: Optional[SelectOutput] = None, *,
                node_graph: Optional[Tensor] = None,
                num_graphs: Optional[int] = None,
                node_mask: Optional[Tensor] = None) -> Tensor:
        if so is None:
            seg, C, mask = node_graph, num_graphs, node_mask
        else:
            if not so.is_sparse:
                raise ValueError("AggrReduce takes sparse assignments only; "
                                 "reduce a dense S with base_reduce")
            seg, C, mask = so.cluster_index, so.num_clusters, so.node_sel_mask
            x = x * so.weight[:, None]
        ok = (seg >= 0) & (seg < C)
        mask = ok if mask is None else mask & ok
        seg = torch.where(ok, seg, 0)
        return self.aggr(x, seg, C, mask)
