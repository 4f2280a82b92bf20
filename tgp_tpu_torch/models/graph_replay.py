"""A model's forward replayed as CUDA graphs, one per input signature.

:class:`GraphReplay` runs a forward ``fn(batch)`` of a sparse
:class:`~tgp_tpu_torch.graph.GraphBatch` on a CUDA device.  A signature
(:func:`signature`: the batch's tensor shapes and dtypes, its static
fields, the device and the caller's stream on it, the inference and
training modes and the addresses of the module's parameters) runs
eagerly the first time it is seen, which builds the kernels and warms
cuBLAS and the allocator; the second time
its forward is captured into a ``torch.cuda.CUDAGraph`` over static
copies of the batch's tensors and replayed once; after that each call
copies the batch's tensors into the static ones and replays the graph:
one launch in place of the forward's Python dispatch.  Past
:data:`MAX_SIGNATURES` the least recently used signature is dropped.

Every call returns outputs of its own, so one call's outputs survive the
next: an output that is one of the batch's tensors (a pooled graph
sharing the input's layout) is the caller's tensor, every other one a
copy of the graph's static output; static ints are as captured.  The
copies in and out go by dtype, one multi-tensor copy a dtype.  The
graph reads the parameters' live storage, so in-place updates
(``load_state_dict``) hold, and a replaced parameter changes the
signature.  The forward must read nothing back to the host: the capture
raises where it does.

Each caller stream has a capture stream of its own, so a graph's kernels
hold the scratch of one stream (the kernels keep theirs per stream) and
replays on two streams never share it; a lock keeps the cache and a
graph's static tensors to one caller at a time.  A replay calls no
kernel wrapper, so :func:`~tgp_tpu_torch.tracing.launches` counts the
launches of eager and captured calls only; the device trace records a
replay's kernels under their own names.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable

import torch
from torch import nn

from tgp_tpu_torch.graph import GraphBatch

__all__ = ["MAX_SIGNATURES", "GraphReplay", "signature"]

#: signatures kept (seen once, or captured); past it the least recently
#: used is dropped with its graph
MAX_SIGNATURES = 32

_SEEN = object()  # a signature run eagerly once, not yet captured


def _caller_stream(device: torch.device):
    """The caller's current stream on ``device``; None off the card."""
    return (torch.cuda.current_stream(device) if device.type == "cuda"
            else None)


def signature(batch: GraphBatch, module: nn.Module) -> tuple:
    """What a captured graph depends on besides the values it reads."""
    parts = [batch.device, _caller_stream(batch.device),
             torch.is_inference_mode_enabled(), module.training]
    parts.extend((v.shape, v.dtype) if isinstance(v, torch.Tensor) else v
                 for v in vars(batch).values())
    stack = [module]  # the parameters' addresses, as module.parameters()
    while stack:      # finds them, without its generators
        m = stack.pop()
        parts.extend(p.data_ptr() for p in m._parameters.values()
                     if p is not None)
        stack.extend(c for c in m._modules.values() if c is not None)
    return tuple(parts)


def _map(obj, fn):
    """``obj`` with each tensor ``t`` inside it (dataclass fields, dicts,
    lists and tuples) replaced by ``fn(t)``; a dataclass is copied field
    for field, without its ``__init__``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        new = object.__new__(type(obj))
        vars(new).update({k: _map(v, fn) for k, v in vars(obj).items()})
        return new
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn) for v in obj)
    return obj


def _by_dtype(tensors) -> list:
    """The positions of ``tensors`` in groups of one dtype: one
    ``torch._foreach_copy_`` a group takes the multi-tensor kernel."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


class _Captured:
    """One signature's graph, its static batch and static outputs."""

    def __init__(self, fn: Callable, batch: GraphBatch,
                 stream: torch.cuda.Stream):
        self.fields = [f.name for f in dataclasses.fields(batch)
                       if isinstance(getattr(batch, f.name), torch.Tensor)]
        self.static = batch.replace(**{n: getattr(batch, n).clone()
                                       for n in self.fields})
        statics = [getattr(self.static, n) for n in self.fields]
        self.in_groups = [([self.fields[i] for i in g],
                           [statics[i] for i in g])
                          for g in _by_dtype(statics)]
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(batch.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(self.static)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)
        self._keep(out, {id(t): n for n, t in zip(self.fields, statics)})

    def _keep(self, out, inputs: dict) -> None:
        """Keep the static outputs ``out``; ``inputs``: the static inputs'
        field names by ``id``.  An output that is a static input is handed
        back as the caller's; every other one (once, where outputs alias)
        is copied out fresh."""
        self.out, self.inputs = out, inputs
        made = {}

        def note(t):
            if id(t) not in inputs:
                made.setdefault(id(t), t)
            return t

        _map(out, note)
        self.made = list(made.values())
        self.out_groups = _by_dtype(self.made)

    def outputs(self, batch: GraphBatch):
        """Replay on the static batch as it stands; fresh outputs."""
        self.graph.replay()
        fresh = [torch.empty_like(t) for t in self.made]
        for g in self.out_groups:
            torch._foreach_copy_([fresh[i] for i in g],
                                 [self.made[i] for i in g])
        by_id = {id(t): f for t, f in zip(self.made, fresh)}

        def fresh_or_callers(t):
            name = self.inputs.get(id(t))
            return by_id[id(t)] if name is None else getattr(batch, name)

        return _map(self.out, fresh_or_callers)

    def __call__(self, batch: GraphBatch):
        for names, statics in self.in_groups:
            torch._foreach_copy_(statics, [getattr(batch, n) for n in names])
        return self.outputs(batch)


class GraphReplay:
    """A module's captured forwards, by :func:`signature`.  Copies and
    pickles of it start empty: a graph belongs to the module's parameters
    where it was captured."""

    def __init__(self):
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._streams: dict = {}  # caller stream -> capture stream
        self._lock = threading.Lock()

    def __deepcopy__(self, memo):
        return GraphReplay()

    def __reduce__(self):
        return GraphReplay, ()

    def __len__(self) -> int:
        return len(self._entries)

    def run(self, fn: Callable, batch: GraphBatch, module: nn.Module):
        """``(how, fn(batch))``, ``how`` one of ``"eager"`` (the first
        sighting of the signature), ``"capture"`` (the second) and
        ``"replay"``."""
        key = signature(batch, module)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._entries[key] = _SEEN
                if len(self._entries) > MAX_SIGNATURES:
                    self._entries.popitem(last=False)
            else:
                self._entries.move_to_end(key)
                if entry is _SEEN:
                    caller = _caller_stream(batch.device)
                    stream = self._streams.get(caller)
                    if stream is None:
                        stream = self._streams[caller] = torch.cuda.Stream(
                            batch.device)
                    entry = self._entries[key] = _Captured(fn, batch, stream)
                    return "capture", entry.outputs(batch)
                return "replay", entry(batch)
        return "eager", fn(batch)
