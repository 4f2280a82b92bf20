"""One run of one cell: set-up, the measured window, and the check of
what the window produced against the plain reference.

The window drives one system: the port (``system="program"``), or, to
show that the check can fail, the reference itself in the next lower
precision put in its place (``system="control"``).  ``fault`` plants a
fault in the port's timed path (the tests and the control script use it;
a benchmark run never does):

* ``altered``: the first graph's logits come out negated;
* ``stale``: a request is answered with the previous request's logits;
* ``half_batch``: serving, the second half of a batch gets the first
  half's answers; training, the loss is the mean over the first half;
* ``state_unchanged``: a training step leaves the weights as they were.
"""

from __future__ import annotations

import gc
import glob
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import counting, gen, spec, trace, weights
from portbench.reference.plain import adam_steps, strict_fp32

CONTROL_PRECISION = "fp8"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _load(model, names: dict, params: dict) -> None:
    """Copy the drawn weights into the port's parameters."""
    got = dict(model.named_parameters())
    if set(got) != set(names):
        raise ValueError(f"the port's parameters {sorted(got)} are not "
                         f"the ones mapped: {sorted(names)}")
    with torch.no_grad():
        for name, t in got.items():
            t.copy_(params[names[name]])


def _op_tables() -> dict:
    """Which device kernels carry each counted operation
    (``kernels/<op>.json``)."""
    out = {}
    for path in sorted(glob.glob(str(spec.HERE / "kernels" / "*.json"))):
        table = spec.load_json(Path(path))
        out[table["op"]] = table["kernels"]
    return out


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class _Phases:
    """Seconds of set-up from the process's start to each named point."""

    def __init__(self, t_start: float):
        self.t_start, self.got = t_start, {"imports": time.perf_counter()
                                           - t_start}

    def mark(self, name: str) -> None:
        self.got[name] = time.perf_counter() - self.t_start


class _Traced:
    """The profiler over the first ``n`` iterations of the window."""

    def __init__(self, on: bool, n: int, device):
        self.n = n if on else 0
        self.prof = (trace.profiler(torch.device(device).type == "cuda")
                     if on else None)
        self.events = []

    def start(self):
        if self.prof is not None:
            self.prof.start()

    def active(self, i: int) -> bool:
        return self.prof is not None and i < self.n

    def stop(self, device):
        if self.prof is not None and not self.events:
            with torch.profiler.record_function(trace.SYNC):
                _sync(device)
            self.prof.stop()
            self.events = trace.events(self.prof)
            self.prof = None


def _iterate(traced: _Traced, i: int, fn):
    if traced.active(i):
        with torch.profiler.record_function(trace.ITER):
            return fn()
    return fn()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve_fault(fault):
    """The logits a broken serving path would return (see above)."""
    state = {}

    def apply(logits):
        if fault == "altered":
            logits = torch.cat([-logits[:1], logits[1:]])
        elif fault == "stale":
            prev, state["prev"] = state.get("prev"), logits
            if prev is not None and prev.shape == logits.shape:
                logits = prev
        elif fault == "half_batch":
            h = logits.shape[0] // 2
            if h:
                logits = torch.cat([logits[:logits.shape[0] - h], logits[:h]])
        return logits
    return apply


def serve(cell, seed: int, seconds: float, traced_run: bool, device,
          t_start: float, system: str = "program", fault=None) -> dict:
    cfg, tr = cell.config, cell.traffic
    phases = _Phases(t_start)
    ref, prog = spec.reference(cfg), spec.program(cfg)
    params = weights.draw(ref.param_shapes(cfg), seed, device)
    phases.mark("weights")
    keeps = []
    state = {"model": prog.build(cfg, device) if system == "program"
             else None}  # freed with the predictor once the window closes
    if system == "program":
        _load(state["model"], prog.PARAMS, params)
        state["model"].eval()
        broken = _serve_fault(fault)

        def apply(batch):
            logits, keep = prog.forward(state["model"], batch)
            keeps.append(keep)
            return broken(logits)

        call = prog.predictor(apply, tr, device)
        plan = [prog.bucket([(n, gen.edge_count(tr, n))
                             for n in gen.node_counts(tr, seed, i)], call)
                for i in range(int(tr.get("plan_requests", 1)))]
        phases.mark("model")
    else:
        plan = [None]  # the control is not timed: one warm-up request

        def call(graphs):
            with torch.no_grad():
                logits, info = ref.forward(params, ref.pack(graphs, device),
                                           cfg, quant=CONTROL_PRECISION)
            keeps.append(info["keep"])
            return logits.float().cpu().numpy()

    # warm-up: each bucket the run's requests reach, on other graphs
    seen = {}
    for i, b in enumerate(plan):
        seen.setdefault(b, i)
    for i in seen.values():
        for rep in range(int(tr.get("warmup_per_bucket", 1))):
            call(gen.graphs(tr, seed, i, gen.WARMUP, rep))
    keeps.clear()
    _sync(device)
    phases.mark("warm-up")
    setup_s = time.perf_counter() - t_start

    buckets = prog.buckets_served(call) if system == "program" else 0
    traced = _Traced(traced_run, int(tr["trace_iterations"]), device)
    lat, outs = [], []
    traced.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        graphs = gen.graphs(tr, seed, i)

        def one():
            a = time.perf_counter()
            out = call(graphs)
            return out, time.perf_counter() - a

        out, dt = _iterate(traced, i, one)
        lat.append(dt)
        outs.append(out)
        i += 1
        if i == traced.n:
            traced.stop(device)
        if time.perf_counter() - t0 >= seconds:
            break
    traced.stop(device)
    window_s = time.perf_counter() - t0
    peak = _peak(device)
    # buckets first met inside the window: the warm-up plan missed them
    new_buckets = (prog.buckets_served(call) - buckets
                   if system == "program" else 0)
    call = state["model"] = None
    _free(device)

    keeps = [None if k is None else k.detach() for k in keeps]
    checks = _check_serving(cell, ref, params, seed, outs, keeps, device)
    ctx = dict(loop="serve", setup_s=setup_s, window_s=window_s,
               latencies_s=lat, peaks=spec.peaks(), setup_phases=phases.got,
               new_buckets=new_buckets,
               chunks_ms=_chunks(np.cumsum(lat), np.arange(1, len(lat) + 1),
                                 window_s))
    if traced_run:
        ctx.update(_trace_ctx(cell, ref, prog, traced.events,
                              [gen.graphs(tr, seed, j)
                               for j in range(min(traced.n, len(outs)))],
                              keeps, train=False))
    return dict(ctx=ctx, attempted=len(outs), checks=checks, peak=peak)


def _check_serving(cell, ref, params, seed, outs, keeps, device) -> dict:
    """The widest logit error over a sample of the requests served (drawn
    from the seed, the largest request always in it), each graph's error
    over its largest reference logit (or the sample's median graph's, if
    larger); and the widest selection gap."""
    cfg, tr = cell.config, cell.traffic
    n_done = len(outs)
    k = min(int(tr["check_requests"]), n_done)
    ids = set(gen.rng(seed, gen.SAMPLE).permutation(n_done)[:k].tolist())
    ids.add(max(range(n_done),
                key=lambda j: sum(gen.node_counts(tr, seed, j))))
    strict_fp32()
    got, want, gaps = [], [], []
    for i in sorted(ids):
        g = ref.pack(gen.graphs(tr, seed, i), device)
        keep = keeps[i]
        if keep is not None and keep.dim() == 1:
            keep = keep[:g.n]
        with torch.no_grad():
            logits, info = ref.forward(params, g, cfg, keep=keep)
        got.append(np.asarray(outs[i], dtype=np.float64))
        want.append(logits.double().cpu().numpy())
        gaps.append(info["gap"])
    return dict(logit_err=_logit_err(got, want),
                select_gap=float(max(gaps)), compared=int(len(ids)))


def _logit_err(got: list, want: list) -> float:
    """The widest gap between the port's and the reference's logits of a
    graph, over that graph's largest reference logit or the median
    graph's, whichever is larger (inf where a shape differs or a logit is
    not finite)."""
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return math.inf
    err = np.concatenate([np.abs(g - w).max(axis=1)
                          for g, w in zip(got, want)])
    scale = np.concatenate([np.abs(w).max(axis=1) for w in want])
    rel = err / np.maximum(scale, float(np.median(scale)))
    return float(rel.max()) if np.isfinite(rel).all() else math.inf


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class _Control:
    """The reference in the port's place: its parameters and forward."""

    def __init__(self, ref, cfg, graphs, device):
        self.ref, self.cfg = ref, cfg
        self.packed = ref.pack(graphs, device)
        self.params = {k: torch.zeros(shape, device=device,
                                      requires_grad=True)
                       for k, (shape, _) in ref.param_shapes(cfg).items()}

    def forward(self):
        logits, info = self.ref.forward(self.params, self.packed, self.cfg,
                                        quant=CONTROL_PRECISION)
        return logits, info["keep"]

    def load(self, params):
        with torch.no_grad():
            for k, v in params.items():
                self.params[k].copy_(v)


def train(cell, seed: int, seconds: float, traced_run: bool, device,
          t_start: float, system: str = "program", fault=None) -> dict:
    cfg, tr = cell.config, cell.traffic
    phases = _Phases(t_start)
    ref, prog = spec.reference(cfg), spec.program(cfg)
    graphs = gen.graphs(tr, seed, 0, gen.TRAIN)
    y = torch.as_tensor(gen.labels(tr, seed, len(graphs)), device=device)
    phases.mark("inputs")
    if system == "program":
        batch = prog.prepare(graphs, cfg, tr, device)
        phases.mark("collation")
        model = prog.build(cfg, device)
        model.train()
        named = [(prog.PARAMS[n], p) for n, p in model.named_parameters()]

        def forward():
            return prog.forward(model, batch)

        def load(params):
            _load(model, prog.PARAMS, params)
    else:
        control = _Control(ref, cfg, graphs, device)
        named = list(control.params.items())
        forward, load = control.forward, control.load

    params = weights.draw(ref.param_shapes(cfg), seed, device)
    load(params)
    phases.mark("model")
    opt = torch.optim.Adam([p for _, p in named], lr=float(tr["lr"]))
    beta1 = opt.defaults["betas"][0]
    half = y.shape[0] // 2

    def step():
        opt.zero_grad(set_to_none=True)
        logits, keep = forward()
        logits = logits.float()
        if fault == "altered":
            logits = torch.cat([-logits[:1], logits[1:]])
        if fault == "half_batch" and half:
            loss = F.cross_entropy(logits[:half], y[:half])
        else:
            loss = F.cross_entropy(logits, y)
        loss.backward()
        if fault != "state_unchanged":
            opt.step()
        return loss.detach(), keep, logits.detach()

    # the first steps, through the window's own call: the check follows them
    n_check = int(tr["check_steps"])
    p0 = {n: p.detach().clone() for n, p in named}
    losses, keeps, g1, logits1 = [], [], None, None
    for t in range(n_check):
        loss, keep, logits = step()
        losses.append(float(loss))
        keeps.append(None if keep is None else keep.detach().clone())
        if t == 0:
            logits1 = logits.clone()
            g1 = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).clone()
                  if p in opt.state else torch.zeros_like(p)
                  for n, p in named}
    p_end = {n: p.detach().clone() for n, p in named}
    _sync(device)
    phases.mark("first steps")
    setup_s = time.perf_counter() - t_start

    traced = _Traced(traced_run, int(tr["trace_iterations"]), device)
    traced_keeps = []
    traced.start()
    t0 = time.perf_counter()
    steps = 0
    marks_t, marks_n = [], []
    while True:
        loss, keep, _ = _iterate(traced, steps, step)
        if traced.active(steps):  # the node masks the work counts read
            traced_keeps.append(keep if keep is not None
                                and keep.dtype == torch.bool else None)
        steps += 1
        if steps == traced.n:
            traced.stop(device)
        now = time.perf_counter() - t0
        marks_t.append(now)
        marks_n.append(steps)
        if now >= seconds:
            break
    traced.stop(device)
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = _peak(device)
    # the window's last loss: a step that left the weights non-finite
    losses.append(float(loss))
    traced_keeps = [None if k is None else k.detach().cpu()
                    for k in traced_keeps]
    del opt, named, forward, step, load
    if system == "program":
        del model, batch
    else:
        del control
    _free(device)

    checks = _check_training(cell, ref, params, graphs, y, losses, logits1,
                             keeps, g1, p0, p_end, device)
    ctx = dict(loop="train", setup_s=setup_s, window_s=window_s,
               steps=steps, peaks=spec.peaks(), setup_phases=phases.got,
               chunks_ms=_chunks(np.asarray(marks_t), np.asarray(marks_n),
                                 window_s))
    if traced_run:
        ctx.update(_trace_ctx(cell, ref, prog, traced.events,
                              [graphs] * len(traced_keeps), traced_keeps,
                              train=True))
    return dict(ctx=ctx, attempted=steps, checks=checks, peak=peak)


def _chunks(t, n, window_s: float, width_s: float = 5.0) -> list:
    """Mean milliseconds a request or step in each ``width_s`` of the
    window, from the host time ``t`` at which the ``n``-th ended: how the
    rate moved inside one run (a diagnostic on standard error)."""
    out, t_prev, n_prev = [], 0.0, 0
    for edge in np.arange(width_s, window_s + width_s, width_s):
        j = int(np.searchsorted(t, edge, side="right")) - 1
        if j < 0 or n[j] == n_prev:
            continue
        out.append(round(1e3 * (t[j] - t_prev) / (n[j] - n_prev), 4))
        t_prev, n_prev = float(t[j]), int(n[j])
    return out


def _worst_leaf(got: dict, want: dict, leaves) -> float:
    """Largest gap between the port's and the reference's norm of a leaf,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    g = {k: float(got[k].double().norm()) for k in leaves}
    w = {k: float(want[k].double().norm()) for k in leaves}
    med = statistics.median(w.values())
    worst = max(abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in leaves)
    return worst if all(math.isfinite(v) for v in g.values()) else math.inf


def _check_training(cell, ref, params, graphs, y, losses, logits1, keeps,
                    g1, p0, p_end, device) -> dict:
    """The reference follows the first steps from the same weights (and,
    where the port reports one, the same selection, judged by the
    reference's scores): each step's loss, the first gradient as Adam
    holds it and each leaf's change after the steps."""
    cfg, tr = cell.config, cell.traffic
    strict_fp32()
    packed = ref.pack(graphs, device)
    yd = y.to(device)

    def loss_fn(p, t):
        keep = keeps[t]
        if keep is not None and keep.dim() == 1:
            keep = keep[:packed.n]
        logits, info = ref.forward(p, packed, cfg, keep=keep)
        return F.cross_entropy(logits, yd), (info["gap"], logits.detach())

    res = adam_steps(params, loss_fn, len(keeps), float(tr["lr"]))
    n = len(keeps)
    # each step's loss against the larger of its own and the first step's
    # (a loss that falls to ~0 after a step has no relative error to read)
    first = abs(res["losses"][0])
    loss_err = max(abs(a - b) / max(abs(b), first, 1e-30)
                   for a, b in zip(losses[:n], res["losses"]))
    if not all(math.isfinite(v) for v in losses):
        loss_err = math.inf
    names = list(res["first_grad"])
    grad_norm = {k: float(res["first_grad"][k].norm()) for k in names}
    med = statistics.median(grad_norm.values())
    # leaves whose gradient is nought to rounding move by round-off alone
    moving = [k for k in names if grad_norm[k] >= 1e-3 * med]
    change_p = {k: p_end[k] - p0[k] for k in names}
    change_r = {k: res["params"][k] - params[k] for k in names}
    ref_logits = res["kept"][0][1].double().cpu().numpy()
    return dict(loss_err=loss_err,
                logit_err=_logit_err(
                    [logits1.double().cpu().numpy()], [ref_logits]),
                grad_err=_worst_leaf(g1, res["first_grad"], names),
                change_err=_worst_leaf(change_p, change_r, moving),
                select_gap=float(max(gap for gap, _ in res["kept"])),
                leaves_left_out=",".join(k for k in names
                                         if k not in moving))


# ---------------------------------------------------------------------------
# what the per-layer readers see
# ---------------------------------------------------------------------------


def _trace_ctx(cell, ref, prog, events, graphs_list, keeps, train):
    red = trace.reduce(events, _op_tables()) if events else {}
    work = []
    for graphs, keep in zip(graphs_list, keeps):
        k = None if keep is None else keep.cpu().numpy()
        work.append(ref.work(cell.config, prog.shape(graphs, k), train,
                             counting))
    return dict(trace=red, work=work)
