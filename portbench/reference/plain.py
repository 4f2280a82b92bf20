"""Pieces shared by the plain references: float32 with TF32 off, and the
control's lower precision.

The references import torch and numpy only, never the port.
"""

from __future__ import annotations

import torch

#: largest finite float8 e4m3 value
E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Matrix products in true float32 (no TF32) from here on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in float32.  The gradient passes
    straight through."""
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def precision(name) -> callable:
    """The rounding applied where the configuration computes in its
    stated compute dtype: none for the reference, fp8 for the control."""
    return {None: identity, "fp8": fp8}[name]


def adam_steps(params: dict, loss_fn, steps: int, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """``steps`` steps of Adam (Kingma & Ba, as ``torch.optim.Adam`` with
    its defaults states it) written out.  ``loss_fn(params, t)`` gives
    step ``t``'s loss and anything else to keep.  Returns each step's loss
    and kept value, the first gradient and the parameters after the last
    step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, kept, first_grad = [], [], None
    for t in range(1, steps + 1):
        loss, extra = loss_fn(p, t - 1)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(p.items(), grads)}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        kept.append(extra)
        with torch.no_grad():
            for k in p:
                m[k].mul_(betas[0]).add_(grads[k], alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(grads[k], grads[k],
                                              value=1 - betas[1])
                m_hat = m[k] / (1 - betas[0] ** t)
                v_hat = v2[k] / (1 - betas[1] ** t)
                p[k].sub_(lr * m_hat / (v_hat.sqrt() + eps))
    return dict(losses=losses, kept=kept, first_grad=first_grad,
                params={k: v.detach() for k, v in p.items()})
