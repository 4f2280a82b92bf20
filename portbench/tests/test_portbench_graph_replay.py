"""``serve.graph_replay_share``: the share of the traced requests whose
forward span says it replayed a CUDA graph, on hand-built stores, on a
program that does not say, and in a traced run on the CPU (which never
replays)."""

import sys
import time

import pytest

import run
import tgp_tpu_torch
from tgp_tpu_torch import tracing

from test_portbench_control import SEED, tiny
from test_portbench_spans import read, rec, request, store  # noqa: F401

NAME = "serve.graph_replay_share"


def _said(req, *hows):
    """A served request whose forward spans (one a chunk) say ``hows``."""
    base = 10 * req
    out = [rec(base, "tgp.predict", None, req, 0, 10)]
    for k, how in enumerate(hows):
        out.append(rec(base + 1 + k, "tgp.model.forward", base, req, 1, 2,
                       launches={}, graph=how))
    return out


def test_reads_100_over_replayed_requests(store):
    store(_said(1, "replay") + _said(2, "replay") + _said(3, "replay"))
    assert read(NAME) == 100.0


def test_a_request_counts_when_every_forward_replayed(store):
    store(_said(1, "eager") + _said(2, "capture") + _said(3, "replay")
          + _said(4, "replay", "eager") + _said(5, "replay", "replay"))
    assert read(NAME) == pytest.approx(40.0)


def test_nothing_said_reads_nothing(store, monkeypatch):
    tracing.reset()
    assert read(NAME) is None
    # the spans of a program whose forward does not say how it ran
    store(request(1, 0, pack=4, csr=20, h2d=2, fwd=1.5, d2h=0.5, k1=3,
                  pad=10, copied=1000))
    assert read(NAME) is None
    store(_said(1, "replay"))
    assert read(NAME) == 100.0
    monkeypatch.delattr(tgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tgp_tpu_torch.tracing", None)
    assert read(NAME) is None


def test_a_traced_run_on_the_cpu_reads_0():
    res = run.run_cell(tiny("serve-small-graphs"), SEED, 0.3, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == 0.0
