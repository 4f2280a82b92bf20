#!/usr/bin/env python3
"""Time every training step of ``chip_smoke.py``, and the clustering
poolers' served forward, in several checkouts of the port on one card, in
turns: what the fixed-order sums (every float segment sum and every
gather's gradient on K4) cost a step or a forward.

    python3 scripts/ab_train_order.py LABEL=ROOT [LABEL=ROOT ...]

Each ``ROOT`` is the root of a checkout (this repository, or an unpacked
``git archive`` of another commit).  The checkouts run in turns (the
arguments in order, then in reverse), each in a process of its own with
``ROOT`` first on the path, on the models and batches of ``ROOT/
chip_smoke.py``'s phases at their full width:

* ``serve_graclus``, ``serve_kmis``, ``serve_ec`` and ``serve_maxcut``:
  the served model (hidden 128, bf16) with that pooler on the first
  request graph (65,536 nodes, 1M edges, ``sort_edges=True``);
* ``train_dense`` (``DenseTopkClassifier``, bf16, K3) and
  ``train_default`` (``prepare_batch`` + ``PoolingClassifier`` with top-k,
  K3) on the dense cell (64 graphs × 256 nodes);
* ``train_sparse`` (top-k), ``train_sag``, ``train_ec``, ``train_kmis``
  and ``train_maxcut`` on the same request graph, label 1;
* ``train_asap``, ``train_pan`` and ``train_lap`` through the example
  twins' models, and ``train_mincut``, ``train_mincut_u``,
  ``train_bnpool`` and ``train_bnpool_u``, on the dense cell's graphs.

A phase whose pooler the checkout lacks is skipped.  A served forward:
10 forwards after a warm-up timed by CUDA events (``forward_ms``, their
median), the device time of 3 forwards from ``torch.profiler``
(``busy_ms_per_forward``) and whether two forwards give the same bits
(``repeat_bit_equal``).  A training step: whether two backward passes from
the same weights, batch and generator state give the same loss and
gradient bits (``grad_repeat_bit_equal``, by this checkout's
``chip_smoke.step_one_repeats``, whichever checkout is measured), 5 Adam
steps timed by CUDA events (``step_ms_median``) and the device time of 3
steps (``busy_ms_per_step``) with its shares in the segment kernels (K1,
K2 and K4: ``segment_ms_per_step``), in sorts (``sort_ms_per_step``) and
in ``index_add_``'s kernels (``index_add_ms_per_step``).  One JSON line
per checkout and phase, each with the card's name and power limit.  Needs
a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

SERVED = ("graclus", "kmis", "ec", "maxcut")
SPARSE = ("topk", "sag", "ec", "kmis", "maxcut")
SMALL = ("asap", "pan", "lap")
SOFT = ("mincut", "mincut_u", "bnpool", "bnpool_u")
#: phases whose loss adds the pooler's auxiliary losses
AUX = {"train_default", "train_maxcut", *(f"train_{a}" for a in SOFT)}


def _events(fn, n):
    import torch

    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _profile(fn, unit, n=3):
    """Device ms a call of ``fn`` over ``n`` calls (``busy_ms_per_<unit>``):
    all kernels, and for a step the segment kernels', sorts' and
    ``index_add_``'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA
          and not e.is_user_annotation]

    def ms(pred):
        return sum(e.self_device_time_total for e in ev if pred(e.key)) / 1e3

    out = {f"busy_ms_per_{unit}": ms(lambda k: True) / n}
    if unit == "step":
        out.update(
            segment_ms_per_step=ms(lambda k: "segment_reduce_kernel" in k
                                   or "csr_wide_kernel" in k
                                   or "csr_narrow_kernel" in k) / n,
            sort_ms_per_step=ms(lambda k: "sort" in k.lower()) / n,
            index_add_ms_per_step=ms(lambda k: "indexfunc" in k.lower()) / n)
    return out


def _own_smoke():
    """This checkout's ``chip_smoke.py`` (for its repeat check), loaded
    under another name beside the measured checkout's."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_own_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phases(cs):
    """``(name, build)`` of each training phase this checkout has:
    ``build()`` gives ``(model, batch, labels, generators)``."""
    import torch

    from tgp_tpu_torch import from_graphs, gcn_norm_dense, prepare_batch
    from tgp_tpu_torch import to_dense
    from tgp_tpu_torch.poolers import pooler_map

    have = set(pooler_map())
    d_graphs, d_labels = cs.dense_graphs(0)
    d_y = torch.tensor(d_labels, device="cuda").long()
    big = {}

    def big_batch():
        if not big:
            x, ei = cs.request_graph(7)
            big["b"] = from_graphs([(x, ei)], sort_edges=True, device="cuda")
        return big["b"]

    def dense():
        from tgp_tpu_torch import DenseTopkClassifier

        model = DenseTopkClassifier(
            num_classes=cs.CLASSES, hidden=cs.HIDDEN, ratio=0.5,
            pre_normalized=True, compute_dtype=torch.bfloat16,
            use_kernel=True, in_channels=cs.FEATURES, device="cuda",
            generator=torch.Generator().manual_seed(0))
        batch = gcn_norm_dense(to_dense(from_graphs(d_graphs, device="cuda")),
                               adj_dtype=torch.bfloat16)
        return model, batch, d_y, ()

    def default():
        from tgp_tpu_torch import PoolingClassifier, get_pooler

        g = torch.Generator().manual_seed(1)
        pooler = get_pooler("topk", in_channels=cs.HIDDEN, ratio=0.5,
                            device="cuda", generator=g)
        batch = prepare_batch(from_graphs(d_graphs, device="cuda"),
                              pooler=pooler, normalize=True)
        model = PoolingClassifier(pooler, num_classes=cs.CLASSES,
                                  hidden=cs.HIDDEN, in_channels=cs.FEATURES,
                                  pre_normalized=True, use_kernel=True,
                                  device="cuda", generator=g)
        return model, batch, d_y, ()

    def sparse(alias):
        def build():
            model = cs.build_model("cuda", alias=alias)
            return model, big_batch(), torch.tensor([1], device="cuda"), ()
        return build

    def small(which):
        def build():
            from tgp_tpu_torch.data import GraphLoader

            batch, _ = next(iter(GraphLoader(d_graphs, d_labels,
                                             batch_size=len(d_graphs),
                                             device="cuda")))
            return cs._small_model(which, "cuda"), batch, d_y, ()
        return build

    def soft(alias):
        def build():
            from tgp_tpu_torch.data import GraphLoader

            model = cs._mincut_model("cuda", alias)
            if alias.endswith("_u"):
                raw, _ = next(iter(GraphLoader(d_graphs, d_labels,
                                               batch_size=len(d_graphs),
                                               device="cuda")))
            else:
                raw = from_graphs(d_graphs, device="cuda")
            batch = prepare_batch(raw, pooler=model.pooler, normalize=False)
            gen = getattr(model.pooler, "sample_generator", None)
            return model, batch, d_y, (gen,) if gen is not None else ()
        return build

    out = [("train_dense", dense), ("train_default", default)]
    out += [(f"train_{a}" if a != "topk" else "train_sparse", sparse(a))
            for a in SPARSE if a in have]
    out += [(f"train_{w}", small(w)) for w in SMALL]
    out += [(f"train_{a}", soft(a)) for a in SOFT
            if a.removesuffix("_u") in have]
    return out


def _serve(cs, label, card, have):
    """The served forwards (one JSON line each)."""
    import torch

    from tgp_tpu_torch import from_graphs

    x, ei = cs.request_graph(7)
    batch = from_graphs([(x, ei)], sort_edges=True, device="cuda")
    for alias in SERVED:
        if alias not in have:
            continue
        model = cs.build_model("cuda", alias=alias).eval()
        with torch.inference_mode():
            first = model(batch)[0].float().cpu()
            repeat = torch.equal(first, model(batch)[0].float().cpu())
            fwd = _events(lambda: model(batch), 10)
            busy = _profile(lambda: model(batch), "forward")
        print(json.dumps(dict(checkout=label, phase=f"serve_{alias}",
                              card=card, forward_ms=statistics.median(fwd),
                              forward_ms_all=fwd, repeat_bit_equal=repeat,
                              **busy)), flush=True)
        del model
        torch.cuda.empty_cache()


def child(label: str, root: str) -> None:
    """One checkout's measurements (run with ``root`` first on the path)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from tgp_tpu_torch.ops.kernels import _build
    from tgp_tpu_torch.poolers import pooler_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = cs.card_line()
    repeats = _own_smoke().step_one_repeats
    _serve(cs, label, card, set(pooler_map()))
    for name, build in _phases(cs):
        model, batch, y, gens = build()
        aux = name in AUX

        def loss_of():
            out = model(batch)
            logits, pooled = out if isinstance(out, tuple) else (out, None)
            loss = torch.nn.functional.cross_entropy(logits, y)
            return loss + pooled.loss_sum() if aux else loss

        def loss_and_grads():
            model.zero_grad(set_to_none=True)
            loss = loss_of()
            loss.backward()
            return loss, {k: q.grad.detach().clone()
                          for k, q in model.named_parameters()
                          if q.grad is not None}

        try:
            repeat = repeats(name, loss_and_grads, gens)
        except AssertionError:
            repeat = False
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss_of().backward()
            opt.step()

        step_ms = _events(step, 5)
        row = dict(checkout=label, phase=name, card=card,
                   grad_repeat_bit_equal=repeat, step_ms=step_ms,
                   step_ms_median=statistics.median(step_ms),
                   **_profile(step, "step"))
        print(json.dumps(row), flush=True)
        del model, batch, opt
        torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2])
        return 0
    pairs = [a.split("=", 1) for a in argv]
    if not pairs or any(len(p) != 2 for p in pairs):
        print(__doc__, file=sys.stderr)
        return 2
    for label, root in pairs + pairs[::-1]:
        root = os.path.abspath(root)
        env = {**os.environ, "PYTHONPATH": root}
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", label, root], cwd=root, env=env)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
