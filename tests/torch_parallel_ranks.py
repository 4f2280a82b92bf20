"""Rank functions of the port's ``parallel`` tests: each runs every case of
one test file on one rank of a gloo world started by
``tgp_tpu_torch.parallel.launch.spawn_world``, and returns numpy results
that the test compares with ``tgp_tpu`` in the pytest process.  This
module imports torch, numpy and the port only, so the ranks never import
JAX."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CPU = torch.device("cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _params(arrays):
    from tgp_tpu_torch.models.convert import pooled_params_from_numpy

    return pooled_params_from_numpy(arrays, device=CPU)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_spmm.py
# ---------------------------------------------------------------------------


def spmm_cases(rank, world, cases):
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel.spmm import (balanced_node_order,
                                             make_ring_halo_spmm,
                                             make_sharded_spmm,
                                             partition_edges,
                                             partition_edges_2d)
    from tgp_tpu_torch.parallel.train import make_mesh

    mesh = make_mesh(world, axis="gp")
    group = mesh.get_group("gp")
    out = {}

    def shard_x(x, n_pad):
        x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
        x_pad[: x.shape[0]] = x
        return C.local_shard(torch.tensor(x_pad), group)

    # the gather variant: values, gradient, repeat bits, the comm log
    s, r, w, x, g = cases["sharded"]
    S, R, W, n_pad, rows_per = partition_edges(s, r, w, x.shape[0], world,
                                               device=CPU)
    fn = make_sharded_spmm(mesh, rows_per, axis="gp")
    xl = shard_x(x, n_pad).requires_grad_()
    C.COMM_LOG.clear()
    y = fn(xl, S[rank], R[rank], W[rank])
    out["sharded_log"] = list(C.COMM_LOG)
    out["sharded"] = _np(y)
    gl = C.local_shard(torch.tensor(np.pad(g, ((0, n_pad - len(g)),
                                               (0, 0)))), group)
    (y * gl).sum().backward()
    out["sharded_dx"] = _np(xl.grad)
    again = fn(xl, S[rank], R[rank], W[rank])
    out["sharded_repeat_equal"] = bool(torch.equal(y, again))

    # the ring variant
    s, r, w, x, g = cases["ring"]
    S, R, W, n_pad, rows_per = partition_edges_2d(s, r, w, x.shape[0],
                                                  world, device=CPU)
    ring = make_ring_halo_spmm(mesh, rows_per, world, axis="gp")
    xl = shard_x(x, n_pad).requires_grad_()
    C.COMM_LOG.clear()
    y = ring(xl, S[rank], R[rank], W[rank])
    out["ring_log"] = list(C.COMM_LOG)
    out["ring"] = _np(y)
    gl = C.local_shard(torch.tensor(np.pad(g, ((0, n_pad - len(g)),
                                               (0, 0)))), group)
    (y * gl).sum().backward()
    out["ring_dx"] = _np(xl.grad)
    out["ring_repeat_equal"] = bool(torch.equal(
        y, ring(xl, S[rank], R[rank], W[rank])))

    # the comm model at n = 128 (forward only, as JAX reads its HLO)
    for name, part, make in (("gather_comm", partition_edges, None),
                             ("ring_comm", partition_edges_2d, True)):
        s, r, w, n, feat = cases[name]
        S, R, W, n_pad, rows_per = part(s, r, w, n, world, device=CPU)
        f = (make_ring_halo_spmm(mesh, rows_per, world, axis="gp") if make
             else make_sharded_spmm(mesh, rows_per, axis="gp"))
        C.COMM_LOG.clear()
        f(torch.zeros(rows_per, feat), S[rank], R[rank], W[rank])
        out[name] = (list(C.COMM_LOG), n_pad, rows_per)

    # a balanced relabelling keeps the product exact
    s, r, w, x = cases["balanced"]
    n = x.shape[0]
    perm, inv = balanced_node_order(r, n, world, senders=s, device=CPU)
    perm, inv = perm.numpy(), inv.numpy()
    n_pad = perm.size
    S, R, W, _, rows_per = partition_edges(inv[s], inv[r], w, n_pad, world,
                                           device=CPU)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n] = x
    x_perm = x_pad[np.minimum(perm, n_pad - 1)]
    fn = make_sharded_spmm(mesh, rows_per, axis="gp")
    out["balanced"] = _np(fn(C.local_shard(torch.tensor(x_perm), group),
                             S[rank], R[rank], W[rank]))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_train.py
# ---------------------------------------------------------------------------


def train_cases(rank, world, cases):
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.models.classifiers import PoolingClassifier
    from tgp_tpu_torch.parallel.train import (make_dp_train_step, make_mesh,
                                              stack_batches)
    from tgp_tpu_torch.poolers import get_pooler

    out = {}
    try:
        make_mesh(world + 1)
    except ValueError as exc:
        out["too_many_raises"] = str(exc)
    mesh = make_mesh(world, axis="gp")

    def model_from(state):
        model = PoolingClassifier(get_pooler("topk", in_channels=8,
                                             ratio=0.5, device=CPU),
                                  num_classes=2, hidden=8, in_channels=4,
                                  device=CPU)
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        return model

    def loss_fn(model):
        def fn(params, b, yy):
            logits, pooled = model(b)
            return F.cross_entropy(logits, yy.long()) + pooled.loss_sum()
        return fn

    state = cases["state"]
    for name in ("same", "distinct"):
        graphs_per_rank, ys, pad = cases[name]
        batches = [from_graphs(g, device=CPU, **pad)
                   for g in graphs_per_rank]
        sb = stack_batches(batches)
        sy = torch.tensor(np.stack(ys))
        runs = []
        for _ in range(2):  # the second run repeats the first bit for bit
            model = model_from(state)
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            step = make_dp_train_step(loss_fn(model), opt, mesh, axis="gp")
            loss = step(list(model.parameters()), sb, sy)
            runs.append((float(loss), {k: _np(v) for k, v
                                       in model.state_dict().items()}))
        out[name] = runs[0]
        out[name + "_repeat_equal"] = (runs[0][0] == runs[1][0] and all(
            np.array_equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1]))

    # AdamW through the step (weight decay reads the parameters)
    dp_mesh = make_mesh(world)
    params = {"w": torch.ones(4, 2, requires_grad=True)}
    opt = torch.optim.AdamW(params.values(), lr=1e-3, weight_decay=1e-4)
    step = make_dp_train_step(
        lambda p, b, yy: torch.mean((b @ p["w"] - yy) ** 2), opt, dp_mesh)
    loss = step(params, torch.tensor(cases["adamw"][0]),
                torch.tensor(cases["adamw"][1]))
    out["adamw"] = (float(loss), _np(params["w"]))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_pooled.py
# ---------------------------------------------------------------------------


def _sharded_pooled(mesh, group, rank, case, num_levels, ratio=0.5):
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel.pooled_model import (
        make_sharded_pooled_forward, prepare_sharded_graph)

    x, ei, n_nodes, ew = case["x"], case["ei"], case["n"], case.get("ew")
    world = C.group_size(group)
    S, R, W, n_pad, rows_per = prepare_sharded_graph(
        ei[0], ei[1], ew, n_nodes, world, device=CPU)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n_nodes] = x
    fwd, ks = make_sharded_pooled_forward(
        mesh, rows_per=rows_per, n_pad=n_pad, num_valid=n_nodes,
        ratio=ratio, num_levels=num_levels)
    xl = C.local_shard(torch.tensor(x_pad), group)
    return (lambda p: fwd(p, xl, S[rank], R[rank], W[rank])), ks, x_pad


def pooled_cases(rank, world, cases):
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel.pooled_model import (
        level_ks, reference_pooled_forward)
    from tgp_tpu_torch.parallel.scaling import measure_pooled_scaling
    from tgp_tpu_torch.parallel.train import make_mesh

    mesh = make_mesh(world, axis="gp")
    group = mesh.get_group("gp")
    out = {}

    def grads(run, arrays):
        params = _params(arrays)
        logits, h = run(params)
        C.backward_replicated((logits ** 2).sum(), group)
        C.psum_grads_(params.values(), [group])
        return logits, h, {k: _np(v.grad) for k, v in params.items()}

    for key, case in cases["forward"].items():
        run, ks, x_pad = _sharded_pooled(mesh, group, rank, case,
                                         case["levels"])
        with torch.no_grad():
            logits, h = run(_params(case["params"]))
            ref_logits, ref_h = reference_pooled_forward(
                _params(case["params"]), torch.tensor(x_pad),
                case["ei"][0], case["ei"][1], None, case["n"], ks)
        out[key] = dict(logits=_np(logits), h=_np(h), ks=ks,
                        ref_logits=_np(ref_logits), ref_h=_np(ref_h))

    # gradients: the sharded world against the single-device twin, repeated
    case = cases["grads"]
    run, ks, x_pad = _sharded_pooled(mesh, group, rank, case, 1)
    first = grads(run, case["params"])
    second = grads(run, case["params"])
    ref_p = _params(case["params"])
    ref_logits, _ = reference_pooled_forward(
        ref_p, torch.tensor(x_pad), case["ei"][0], case["ei"][1], None,
        case["n"], ks)
    (ref_logits ** 2).sum().backward()
    out["grads"] = dict(
        logits=_np(first[0]), grads=first[2],
        ref_grads={k: _np(v.grad) for k, v in ref_p.items()},
        repeat_equal=bool(torch.equal(first[0], second[0]) and all(
            np.array_equal(first[2][k], second[2][k]) for k in first[2])))

    # the over-budget k: padding picks' gates stay out of the backward
    case = cases["overbudget"]
    run, ks, _ = _sharded_pooled(mesh, group, rank, case, 1, ratio=0.9)
    out["overbudget"] = dict(ks=ks, grads=grads(run, case["params"])[2])

    try:
        level_ks(64, 0.5, 0, world)
    except ValueError as exc:
        out["level_ks_error"] = str(exc)
    out["scaling"] = measure_pooled_scaling(
        n_nodes=512, n_feats=8, degree=4, device_counts=(1, 2, 4), iters=3)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_multihost.py
# ---------------------------------------------------------------------------


def multihost_cases(rank, world, cases):
    from tgp_tpu_torch.parallel.multihost import (
        device_put_hybrid, initialize_multihost, make_hybrid_mesh,
        make_hybrid_pooled_train_step, stack_group_graphs)
    from tgp_tpu_torch.parallel.pooled_model import prepare_sharded_graph

    out = {"initialized": initialize_multihost()}
    n_groups, per_group = cases["shape"]
    mesh = make_hybrid_mesh(n_groups, per_group)
    n = cases["n"]
    prepped = [prepare_sharded_graph(s, r, None, n, per_group, device=CPU)
               for s, r, _ in cases["groups"]]
    S, R, W, n_pad, rows_per = stack_group_graphs(prepped)
    X = np.stack([np.concatenate([x, np.zeros((n_pad - n, x.shape[1]),
                                              np.float32)])
                  for _, _, x in cases["groups"]])
    args = device_put_hybrid(mesh, torch.tensor(X), S, R, W,
                             torch.tensor(cases["y"]))

    def run(make_opt, steps):
        params = _params(cases["params"])
        opt = make_opt(params.values())
        step, ks = make_hybrid_pooled_train_step(
            mesh, opt, rows_per=rows_per, n_pad=n_pad, num_valid=n,
            ratio=0.5, num_levels=2)
        losses = [float(step(params, *args)) for _ in range(steps)]
        return losses, {k: _np(v) for k, v in params.items()}, ks

    out["sgd"] = run(lambda p: torch.optim.SGD(p, lr=1e-2), 1)
    out["sgd_repeat_equal"] = _equal_runs(
        out["sgd"], run(lambda p: torch.optim.SGD(p, lr=1e-2), 1))
    out["adam"] = run(lambda p: torch.optim.Adam(p, lr=5e-3), 3)
    out["coords"] = (mesh.get_local_rank("dcn"), mesh.get_local_rank("ici"))
    return out


def _equal_runs(a, b):
    return a[0] == b[0] and all(np.array_equal(a[1][k], b[1][k])
                                for k in a[1])


def failing_rank(rank, world):
    """Rank 1 raises; the others wait for it in a barrier."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()


def sleeping_rank(rank, world):
    import time

    time.sleep(60)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_dense_pool.py
# ---------------------------------------------------------------------------


def _dense_pooler(alias, kw, state):
    from tgp_tpu_torch.poolers import get_pooler

    pooler = get_pooler(alias, batched=False, device=CPU, **kw)
    pooler.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return pooler


def _dense_inputs(mesh, graph, world):
    from tgp_tpu_torch.graph import from_graphs
    from tgp_tpu_torch.parallel.dense_pool import (
        device_put_sharded_dense, prepare_sharded_dense_graph)

    x, s, r, w, n = graph
    x_pad, mask, S, R, W, n_pad, rows_per = prepare_sharded_dense_graph(
        x, s, r, w, n, world, device=CPU)
    args = device_put_sharded_dense(mesh, x_pad, mask, S, R, W, axis="n")
    flat = from_graphs([(x, np.stack([s, r]), w)], pad_nodes=n_pad,
                       pad_edges=len(s), device=CPU)
    return args, flat, rows_per


def _pool_out(x_pool, adj_pool, losses):
    return dict(x_pool=_np(x_pool), adj_pool=_np(adj_pool),
                losses={k: float(v) for k, v in losses.items()})


def _same_bits(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))


def dense_pool_cases(rank, world, cases):
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel.dense_pool import (
        make_sharded_dense_pool_step, prepare_sharded_negatives)
    from tgp_tpu_torch.parallel.train import make_mesh
    from tgp_tpu_torch.select import dp

    mesh = make_mesh(world, axis="n")
    group = mesh.get_group("n")
    out = {}

    # every alias of the family against its single-device forward
    for key, (alias, kw, state, graph) in cases["forward"].items():
        pooler = _dense_pooler(alias, kw, state)
        args, flat, rows_per = _dense_inputs(mesh, graph, world)
        step = make_sharded_dense_pool_step(pooler, mesh, rows_per, axis="n")
        with torch.no_grad():
            got = step(*args)
            ref = pooler(flat)
        out[key] = dict(_pool_out(*got), repeat_equal=_same_bits(
            got, step(*args)), ref=_pool_out(ref.dense.x[0],
                                              ref.dense.adj[0], ref.loss))

    # gradients of cut + ortho: seeded 1/D, summed over the ranks
    alias, kw, state, graph = cases["grads"]
    args, flat, rows_per = _dense_inputs(mesh, graph, world)

    def sharded_grads():
        pooler = _dense_pooler(alias, kw, state)
        step = make_sharded_dense_pool_step(pooler, mesh, rows_per, axis="n")
        _, _, losses = step(*args)
        C.backward_replicated(losses["cut_loss"] + losses["ortho_loss"],
                              group)
        C.psum_grads_(pooler.parameters(), [group])
        return {k: _np(v.grad) for k, v in pooler.named_parameters()}

    first, second = sharded_grads(), sharded_grads()
    ref_pooler = _dense_pooler(alias, kw, state)
    loss = ref_pooler(flat).loss
    (loss["cut_loss"] + loss["ortho_loss"]).backward()
    out["grads"] = dict(grads=first, repeat_equal=all(
        np.array_equal(first[k], second[k]) for k in first),
        ref_grads={k: _np(v.grad) for k, v in ref_pooler.named_parameters()})

    # BNPool on JAX's per-node draws (a table by global node index) and
    # negatives
    alias, kw, state, graph, neg_seed, (t1, t2) = cases["bnpool"]
    tables = (torch.tensor(t1), torch.tensor(t2))
    real = dp.draw_gamma_keyed
    dp.draw_gamma_keyed = (lambda alpha, seed, graph_ids, pos, stream:
                           tables[stream][pos.long()])
    try:
        pooler = _dense_pooler(alias, kw, state)
        args, flat, rows_per = _dense_inputs(mesh, graph, world)
        x, s, r, w, n = graph
        NS, NR, NM, flat_neg = prepare_sharded_negatives(
            neg_seed, s, r, n, world, device=CPU)
        step = make_sharded_dense_pool_step(pooler, mesh, rows_per, axis="n")
        neg = (NS[rank], NR[rank], NM[rank])
        with torch.no_grad():
            got = step(0, *args, *neg)
            ref = pooler(flat, negatives=flat_neg, sample_seed=0)
            again = step(0, *args, *neg)
    finally:
        dp.draw_gamma_keyed = real
    out["bnpool"] = dict(_pool_out(*got), repeat_equal=_same_bits(got, again),
                         ref=_pool_out(ref.dense.x[0], ref.dense.adj[0],
                                       ref.loss))
    # the port's own keyed draws: sharded equals single-device
    with torch.no_grad():
        got = step(3, *args, *neg)
        ref = pooler(flat, negatives=flat_neg, sample_seed=3)
    out["bnpool_own"] = dict(_pool_out(*got), ref=_pool_out(
        ref.dense.x[0], ref.dense.adj[0], ref.loss))

    # dropout: a seed a call, folded with the rank
    alias, kw, state, graph = cases["dropout"]
    pooler = _dense_pooler(alias, kw, state)
    args, _, rows_per = _dense_inputs(mesh, graph, world)
    step = make_sharded_dense_pool_step(pooler, mesh, rows_per, axis="n",
                                        deterministic=False)
    with torch.no_grad():
        out["dropout"] = [_np(step(seed, *args)[0]) for seed in (0, 0, 7)]
        det = make_sharded_dense_pool_step(pooler, mesh, rows_per, axis="n")
        out["dropout_off"] = _np(det(*args)[0])
    out["selector_training_restored"] = pooler.selector.mlp.training
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_sparse_pool.py
# ---------------------------------------------------------------------------


def _topk_model(alias, pool_kw, state, feat):
    from tgp_tpu_torch.parallel.sparse_pool import TopkPoolModel
    from tgp_tpu_torch.poolers import get_pooler

    pooler = get_pooler(alias, in_channels=16, device=CPU, **pool_kw)
    model = TopkPoolModel(pooler, hidden=16, num_classes=3,
                          in_channels=feat, device=CPU)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


def sparse_pool_cases(rank, world, cases):
    from tgp_tpu_torch.parallel import _collectives as C
    from tgp_tpu_torch.parallel.sparse_pool import (
        make_sharded_topk_model_forward)
    from tgp_tpu_torch.parallel.train import make_mesh

    mesh = make_mesh(world, axis="n")
    group = mesh.get_group("n")
    out = {}

    def forward_of(model, graph):
        args, flat, rows_per = _dense_inputs(mesh, graph, world)
        fwd = make_sharded_topk_model_forward(
            model, mesh, rows_per=rows_per, max_nodes=flat.max_nodes,
            axis="n")
        return (lambda: fwd(*args)), flat

    for key, (alias, pool_kw, state, graph) in cases["forward"].items():
        model = _topk_model(alias, pool_kw, state, graph[0].shape[1])
        run, flat = forward_of(model, graph)
        with torch.no_grad():
            C.COMM_LOG.clear()
            logits = run()
            log = [(op, shape) for op, shape, _, _ in C.COMM_LOG]
            again = run()
            ref = model(flat)[0]
        out[key] = dict(logits=_np(logits), ref=_np(ref), comm=log,
                        repeat_equal=bool(torch.equal(logits, again)))

    # gradients of CE on label 1: seeded 1/D, summed over the ranks
    alias, pool_kw, state, graph = cases["grads"]
    y = torch.tensor([1])

    def grads(sharded):
        model = _topk_model(alias, pool_kw, state, graph[0].shape[1])
        run, flat = forward_of(model, graph)
        if sharded:
            loss = F.cross_entropy(run()[None], y)
            C.backward_replicated(loss, group)
            C.psum_grads_(model.parameters(), [group])
        else:
            F.cross_entropy(model(flat), y).backward()
        return {k: _np(v.grad) for k, v in model.named_parameters()
                if v.grad is not None}

    first, second = grads(True), grads(True)
    out["grads"] = dict(grads=first, ref_grads=grads(False),
                        repeat_equal=all(np.array_equal(first[k], second[k])
                                         for k in first))
    return out
