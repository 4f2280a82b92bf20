"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.  Entry points default to
    ``"cuda"``; without a card that is an error, never a silent move to
    the CPU — pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: tgp_tpu_torch entry points run on the "
            "GPU by default; pass device='cpu' to run on the CPU")
    return dev
