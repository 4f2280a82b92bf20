"""Dirichlet-process stick-breaking selector (port of
``tgp_tpu/select/dp.py``; used by BNPool).

``MLP(X) → softplus → (α, β) → Beta(α, β) draw → stick-breaking π``.  The
Beta draw is two Gamma draws, ``z = g₁ / (g₁ + g₂)``, each reparameterised
as JAX's ``jax.random.gamma`` is: the sample is drawn with no gradient
(:func:`draw_gamma`, ``torch._standard_gamma`` from an explicit
generator) and its gradient in α is ``torch._standard_gamma_grad(α,
sample)`` (:class:`_GammaSample`).  Split so, draws made elsewhere (JAX's,
or the card's replayed on the CPU) can stand in for :func:`draw_gamma`'s.
The posterior parameters ride in ``extras["q_alpha"]`` /
``extras["q_beta"]`` for BNPool's KL term.

``per_node_keys``: each node's two Gamma draws depend only on the call's
base seed and the node's identity, (graph, position) in the flat layout
and (b, n) in the batched ``[B, N]`` one, so the sampled ``s`` is the same
flat, batched, single-device and sharded.  ``torch.Generator`` has no
``fold_in``, and a generator a node would cost a launch a node, so the
draws come from a counter-based source made of plain tensor ops on the
device: Philox-4x32-10 (:func:`philox4x32`, Salmon et al., SC'11) over the
counter ``(position, graph, column, stream + 2·round)`` and the key
``seed``, feeding a Marsaglia–Tsang Gamma sampler
(:func:`draw_gamma_keyed`: normals by Box–Muller, the ``α < 1`` boost
``U^{1/α}``, at most :data:`GAMMA_ROUNDS` masked rejection rounds, each on
the lanes still pending; it raises if any lane is left).  The base seed
is drawn once a call from ``sample_generator`` (or passed in), so ranks
holding the same generator state draw the same seed.  The draws are not
JAX's (threefry's ``fold_in``); the gradient is :class:`_GammaSample`'s
either way.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.mlp import SelectMLP

__all__ = ["DPSelect", "stick_breaking", "draw_gamma", "draw_gamma_keyed",
           "philox4x32", "keyed_words", "draw_base_seed"]

Tensor = torch.Tensor

#: Philox-4x32's round multipliers and Weyl key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
#: the Marsaglia–Tsang rejection rounds a lane may take; each accepts with
#: probability above 0.95, so a lane left after 16 is a fault, not chance
GAMMA_ROUNDS = 16


def stick_breaking(z: Tensor) -> Tensor:
    """Log-space stick-breaking: ``π_k = z_k · Π_{j<k}(1−z_j)`` with
    ``π_K = Π_j (1−z_j)``; ``[..., K−1] → [..., K]``."""
    log_z = torch.log(torch.clamp(z, min=1e-12))
    log_1mz = torch.log(torch.clamp(1 - z, min=1e-12))
    cum = torch.cumsum(log_1mz, -1)
    return torch.exp(torch.cat(
        [log_z[..., :1], log_z[..., 1:] + cum[..., :-1], cum[..., -1:]], -1))


def draw_gamma(alpha: Tensor, generator: Optional[torch.Generator]
               ) -> Tensor:
    """``Gamma(alpha, 1)`` samples from ``generator`` (no gradient)."""
    return torch._standard_gamma(alpha.detach(), generator=generator)


def _mulhilo(a: int, b: Tensor):
    """The high and low 32-bit words of ``a · b`` for a 32-bit constant
    ``a`` and int64 words ``b < 2³²``, exact in int64 (every product below
    2⁴⁸)."""
    low = a * (b & 0xFFFF)
    mid = a * (b >> 16) + (low >> 16)  # ⌊a·b / 2¹⁶⌋
    return mid >> 16, ((mid & 0xFFFF) << 16) | (low & 0xFFFF)


def philox4x32(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor, k0: int,
               k1: int, rounds: int = 10):
    """Philox-4x32 of the 32-bit counter words ``c0..c3`` (int64 tensors
    of one shape, values below 2³²) under the key ``(k0, k1)``: four int64
    tensors of 32-bit words, the same bits on every device."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def keyed_words(seed: int, graph: Tensor, pos: Tensor, column: Tensor,
                stream: int, rnd: int):
    """The four 32-bit words (int64 tensors) of each lane's draw in round
    ``rnd`` of ``stream``: Philox over ``(pos, graph, column, stream +
    2·rnd)`` keyed by the 64-bit ``seed``."""
    pos, graph, column = (t.to(torch.int64) for t in (pos, graph, column))
    c3 = torch.full_like(pos, stream + 2 * rnd)
    return philox4x32(pos & _MASK32, graph & _MASK32, column & _MASK32, c3,
                      seed & _MASK32, (seed >> 32) & _MASK32)


def _uniform(word: Tensor) -> Tensor:
    """A 32-bit word as a float64 uniform in (0, 1)."""
    return (word.to(torch.float64) + 0.5) * 2.0 ** -32


def draw_gamma_keyed(alpha: Tensor, seed: int, graph: Tensor, pos: Tensor,
                     stream: int) -> Tensor:
    """``Gamma(alpha, 1)`` samples (no gradient) keyed per node: row ``m``
    of ``alpha [M, C]`` belongs to the node ``(graph[m], pos[m])``, and
    each entry draws from the lanes ``(seed, graph, pos, column, stream,
    round)`` alone.  Marsaglia–Tsang in float64 on ``alpha``'s device,
    returned in ``alpha``'s dtype."""
    M, C = alpha.shape
    dev = alpha.device
    a = alpha.detach().to(torch.float64).reshape(-1)
    boost = a < 1
    shape = torch.where(boost, a + 1, a)
    d = shape - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    lane_pos = pos.to(torch.int64).repeat_interleave(C)
    lane_graph = graph.to(torch.int64).repeat_interleave(C)
    lane_col = torch.arange(C, device=dev, dtype=torch.int64).repeat(M)
    out = torch.zeros_like(a)
    pending = torch.arange(M * C, device=dev)
    for rnd in range(GAMMA_ROUNDS):
        if pending.numel() == 0:
            break
        w = keyed_words(seed, lane_graph[pending], lane_pos[pending],
                        lane_col[pending], stream, rnd)
        x = torch.sqrt(-2.0 * torch.log(_uniform(w[0]))) * torch.cos(
            2.0 * math.pi * _uniform(w[1]))
        dl, cl = d[pending], c[pending]
        v = (1.0 + cl * x) ** 3
        safe_v = torch.where(v > 0, v, 1.0)
        ok = (v > 0) & (torch.log(_uniform(w[2])) < 0.5 * x * x + dl
                        - dl * safe_v + dl * torch.log(safe_v))
        g = dl * safe_v
        g = torch.where(boost[pending],
                        g * _uniform(w[3]) ** (1.0 / a[pending]), g)
        out[pending[ok]] = g[ok]
        pending = pending[~ok]
    if pending.numel():
        raise RuntimeError(
            f"draw_gamma_keyed: {pending.numel()} lanes still rejected after "
            f"{GAMMA_ROUNDS} rounds (alpha {a[pending][:4].tolist()})")
    return out.to(alpha.dtype).reshape(M, C)


def draw_base_seed(generator: Optional[torch.Generator]) -> int:
    """One 63-bit base seed from ``generator`` (torch's default CPU
    generator when None)."""
    dev = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             device=dev))


class _GammaSample(torch.autograd.Function):
    """A Gamma sample as it is, with the implicit reparameterisation
    gradient ``d sample / d alpha`` of ``jax.random.gamma``."""

    @staticmethod
    def forward(ctx, alpha, sample):
        ctx.save_for_backward(alpha, sample)
        return sample.clone()

    @staticmethod
    def backward(ctx, g):
        alpha, sample = ctx.saved_tensors
        return g * torch._standard_gamma_grad(alpha, sample), None


class DPSelect(nn.Module):
    """The stick-breaking posterior ``S [B, N, K]`` (batched, a
    :class:`DenseGraphBatch`) or ``[N, K]`` (unbatched, a flat
    :class:`GraphBatch`).  ``in_channels``: the input width, or a list of
    it and the MLP's hidden widths; the MLP (``SelectMLP``, flax's
    ``SelectMLP_0``) gives ``2(k−1)`` outputs.  ``sample_generator`` (on
    the module's device) feeds the Gamma draws, at train and eval time
    alike, as in JAX.  ``per_node_keys``: each node's draws are keyed by
    its identity (:func:`draw_gamma_keyed`), the base seed drawn once a
    call from ``sample_generator`` unless ``forward`` is given
    ``sample_seed``."""

    def __init__(self, in_channels: Union[int, List[int]], k: int = 8,
                 batched: bool = True, act: Optional[str] = None,
                 dropout: float = 0.0, s_inv_op: str = "transpose",
                 per_node_keys: bool = False, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None,
                 sample_generator: Optional[torch.Generator] = None):
        super().__init__()
        ch = ([in_channels] if in_channels is None
              or isinstance(in_channels, int) else list(in_channels))
        self.k = k
        self.batched = batched
        self.s_inv_op = s_inv_op
        self.per_node_keys = per_node_keys
        self.sample_generator = sample_generator
        self.mlp = SelectMLP(ch, 2 * (k - 1), act, dropout,
                             generator=generator,
                             dropout_generator=dropout_generator)
        self.to(resolve_device(device))

    def _keyed_draws(self, batch, q_alpha, q_beta, seed):
        """Both streams' draws, keyed by each node's (graph, position)."""
        if seed is None:
            seed = draw_base_seed(self.sample_generator)
        dev = q_alpha.device
        if self.batched:
            B, N = q_alpha.shape[0], q_alpha.shape[1]
            graph = torch.arange(B, device=dev).repeat_interleave(N)
            pos = torch.arange(N, device=dev).repeat(B)
        else:
            graph, pos = batch.node_graph, batch.node_pos
        width = q_alpha.shape[-1]
        return tuple(
            draw_gamma_keyed(q.reshape(-1, width), seed, graph, pos,
                             stream).reshape(q.shape)
            for stream, q in enumerate((q_alpha, q_beta)))

    def forward(self, batch, *, sample_seed: Optional[int] = None
                ) -> SelectOutput:
        """``sample_seed``: the base seed of the per-node draws (drawn
        from ``sample_generator`` when None; read only with
        ``per_node_keys``)."""
        out = torch.clamp(F.softplus(self.mlp(batch.x)), 1e-3, 1e3)
        q_alpha, q_beta = out.chunk(2, dim=-1)
        if self.per_node_keys:
            d1, d2 = self._keyed_draws(batch, q_alpha, q_beta, sample_seed)
        else:
            d1 = draw_gamma(q_alpha, self.sample_generator)
            d2 = draw_gamma(q_beta, self.sample_generator)
        g1 = _GammaSample.apply(q_alpha, d1)
        g2 = _GammaSample.apply(q_beta, d2)
        z = torch.clamp(g1 / torch.clamp(g1 + g2, min=1e-12), 1e-6,
                        1 - 1e-6)
        s = stick_breaking(z)
        extras = {"q_alpha": q_alpha, "q_beta": q_beta}
        if self.batched:
            if not isinstance(batch, DenseGraphBatch):
                raise TypeError("batched DPSelect expects a DenseGraphBatch")
            return SelectOutput(
                batched_s=s * batch.mask[..., None], in_mask=batch.mask,
                num_clusters=self.k, num_graphs=batch.num_graphs,
                max_clusters=self.k, s_inv_op=self.s_inv_op, extras=extras)
        if not isinstance(batch, GraphBatch):
            raise TypeError("unbatched DPSelect expects a flat GraphBatch")
        return SelectOutput(
            assignment=s * batch.node_mask[:, None],
            node_graph=batch.node_graph, node_mask=batch.node_mask,
            node_pos=batch.node_pos, max_nodes=batch.max_nodes,
            num_clusters=self.k, num_graphs=batch.num_graphs,
            max_clusters=self.k, s_inv_op=self.s_inv_op, extras=extras)
