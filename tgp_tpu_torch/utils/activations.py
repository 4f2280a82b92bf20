"""String → activation resolver (port of ``tgp_tpu/utils/activations.py``)."""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

_ACTS = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": F.relu,
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus,
    # jax.nn.leaky_relu's default slope
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "identity": lambda x: x,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def resolve_activation(act: Union[str, Callable, None]) -> Callable:
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    try:
        return _ACTS[act.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None
