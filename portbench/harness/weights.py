"""Weights from the seed, made on the device in one draw."""

from __future__ import annotations

import math

import torch

from portbench.harness.gen import seed64


def draw(shapes: dict, seed: int, device) -> dict:
    """Float32 parameters ``{name: tensor}``: one normal draw from a
    generator on ``device`` seeded by ``seed``, cut into the leaves of
    ``shapes`` (``name: (shape, std)``) and scaled."""
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed) * 0x9E3779B97F4A7C15 % 2 ** 64)
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, (shape, std)), size in zip(shapes.items(), sizes):
        out[name] = flat[at:at + size].view(shape) * std
        at += size
    return out
