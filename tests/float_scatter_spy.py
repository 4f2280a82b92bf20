"""A dispatch-mode spy for float sums in an order the card picks (float
``index_add_``/``scatter_add``, accumulating ``index_put_``, summing
``scatter_reduce``), paused while K4's entry runs: its CPU stand-in sums
by ``index_add_``, its CUDA kernel in a fixed order."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tgp_tpu_torch.ops.kernels import segment_spmm as K

#: aten ops that add floats in an order the card does not fix
_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "index_reduce", "index_reduce_"}
_PUTS = {"index_put", "index_put_", "_index_put_impl", "_index_put_impl_"}


class FloatScatterSpy(TorchDispatchMode):
    """Records the name of every float scatter dispatched while it is on
    and not ``paused``."""

    def __init__(self):
        super().__init__()
        self.seen, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        target = args[0] if args else None
        floating = (isinstance(target, torch.Tensor)
                    and target.dtype.is_floating_point)
        if not self.paused and floating and (
                name in _SCATTERS
                or name in _PUTS and (kwargs.get("accumulate")
                                      or len(args) > 3 and args[3])
                or name.startswith("scatter_reduce")
                and (kwargs.get("reduce", args[4] if len(args) > 4 else "")
                     in ("sum", "mean", "prod"))):
            self.seen.append(name)
        return func(*args, **kwargs)


def spy_with_k4_paused(monkeypatch) -> FloatScatterSpy:
    """A spy that pauses while ``K._k4_sum`` runs (monkeypatched)."""
    spy = FloatScatterSpy()
    real = K._k4_sum

    def k4(*a):
        spy.paused = True
        try:
            return real(*a)
        finally:
            spy.paused = False

    monkeypatch.setattr(K, "_k4_sum", k4)
    return spy
