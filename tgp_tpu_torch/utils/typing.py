"""Type aliases (port of ``tgp_tpu/utils/typing.py``)."""

from __future__ import annotations

from typing import Literal

SinvType = Literal["transpose", "inverse"]
LiftType = Literal["precomputed", "transpose", "inverse"]
ConnectionType = Literal["sum", "mean", "max"]
ReduceType = Literal["sum", "mean", "max", "min", "mul"]

__all__ = ["SinvType", "LiftType", "ConnectionType", "ReduceType"]
