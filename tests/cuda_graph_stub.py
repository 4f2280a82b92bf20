"""A stand-in for CUDA graph capture on the CPU, for the tests of
``PoolingClassifier``'s replay (``tgp_tpu_torch/models/graph_replay.py``).

:func:`install` lets the replay engage on CPU batches and swaps
``torch.cuda``'s graph and stream objects for ones that do nothing: the
"capture" runs the forward once on the static batch, as a real capture
runs its Python, and a "replay" launches nothing, so the static outputs
keep the values of the captured call.  Everything around them (the
signature cache, the static copies, the fresh outputs, the spans) is
the program's own.
"""

import contextlib

import torch

from tgp_tpu_torch.models import graph_replay
from tgp_tpu_torch.models.classifiers import PoolingClassifier


class Graph:
    """Counts the captures and replays of every stand-in graph."""

    captured = 0
    replayed = 0

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        Graph.captured += 1

    def replay(self):
        Graph.replayed += 1


class _Stream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


def install(monkeypatch) -> type:
    """Patch the replay's gate and ``torch.cuda``'s objects for this test
    (``torch.cuda.stream(s)`` makes ``s`` the current stream); the
    stand-in graph class, its counts at zero."""
    monkeypatch.setattr(
        PoolingClassifier, "_replayable",
        lambda self, batch: not torch.is_grad_enabled() and getattr(
            self.pooler, "CAPTURABLE", False))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    current = [_Stream()]

    @contextlib.contextmanager
    def stream(s):
        current.append(s)
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current[-1])
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(graph_replay, "_caller_stream",
                        lambda device: current[-1])
    Graph.captured = Graph.replayed = 0
    return Graph
