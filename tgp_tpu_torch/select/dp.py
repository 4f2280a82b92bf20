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
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.mlp import SelectMLP

__all__ = ["DPSelect", "stick_breaking", "draw_gamma"]

Tensor = torch.Tensor


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
    alike, as in JAX.  ``per_node_keys`` (JAX's layout-invariant draws
    for the sharded path) is not ported."""

    def __init__(self, in_channels: Union[int, List[int]], k: int = 8,
                 batched: bool = True, act: Optional[str] = None,
                 dropout: float = 0.0, s_inv_op: str = "transpose",
                 per_node_keys: bool = False, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None,
                 sample_generator: Optional[torch.Generator] = None):
        super().__init__()
        if per_node_keys:
            raise NotImplementedError(
                "DPSelect(per_node_keys=True) serves the sharded dense "
                "path (tgp_tpu/parallel/dense_pool.py), which is not "
                "ported yet: see ROADMAP.md, queue 1, item parallel/*")
        ch = ([in_channels] if in_channels is None
              or isinstance(in_channels, int) else list(in_channels))
        self.k = k
        self.batched = batched
        self.s_inv_op = s_inv_op
        self.sample_generator = sample_generator
        self.mlp = SelectMLP(ch, 2 * (k - 1), act, dropout,
                             generator=generator,
                             dropout_generator=dropout_generator)
        self.to(resolve_device(device))

    def forward(self, batch) -> SelectOutput:
        out = torch.clamp(F.softplus(self.mlp(batch.x)), 1e-3, 1e3)
        q_alpha, q_beta = out.chunk(2, dim=-1)
        g1 = _GammaSample.apply(q_alpha,
                                draw_gamma(q_alpha, self.sample_generator))
        g2 = _GammaSample.apply(q_beta,
                                draw_gamma(q_beta, self.sample_generator))
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
