"""Linear layers initialised and applied as flax's ``nn.Dense``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["lecun_normal_linear", "apply_linear"]


def lecun_normal_linear(n_in: int, n_out: int, bias: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> nn.Linear:
    """``nn.Linear`` initialised like flax's ``nn.Dense``: truncated-normal
    kernel with variance 1/fan_in, zero bias."""
    lin = nn.Linear(n_in, n_out, bias=bias)
    # flax's variance_scaling divides by the std of a [-2, 2]-truncated
    # standard normal so the truncated draw keeps variance 1/fan_in
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def apply_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)`` in the promoted dtype of ``x`` and the weights, as flax's
    ``nn.Dense`` without ``dtype`` computes (bf16 features and f32 weights
    give f32)."""
    ct = torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(ct)
    return torch.nn.functional.linear(x.to(ct), lin.weight.to(ct), bias)
