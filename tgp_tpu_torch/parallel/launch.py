"""Run a function on every rank of a fresh ``torch.distributed`` world, or
make this process a world of one rank (:func:`single_rank_world`).

:func:`spawn_world` starts ``world_size`` processes (the ``spawn`` start
method: fresh interpreters that import only the rank function's module),
joins them through a ``file://`` rendezvous in a new temporary directory
(never a fixed TCP port, so concurrent worlds cannot collide), and
returns each rank's result.  A rank that raises, or a world that
outlives ``timeout_s``, ends every rank and raises in the caller.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch

__all__ = ["spawn_world", "single_rank_world"]


def _rank_main(fn, rank, world_size, backend, init_file, timeout_s, args,
               results):
    import torch.distributed as dist

    try:
        # ranks share the host's cores: one thread each keeps a world of
        # four from oversubscribing them
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        # plain pickling: tensors travel by value, not as shared memory
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the caller
        results.put((rank, False, traceback.format_exc()))


def _failures(fn, results, rank, payload, grace_s=2.0):
    """Every failed rank's traceback: the first to report and those that
    report within ``grace_s`` (a rank's failure often shows first as its
    peers' broken connections)."""
    failed = {rank: payload}
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            r, ok, text = results.get(timeout=max(deadline - time.monotonic(),
                                                  0.01))
        except queue.Empty:
            break
        if not ok:
            failed[r] = text
    return "\n".join(f"spawn_world: rank {r} of {fn.__name__} failed:\n{t}"
                     for r, t in sorted(failed.items()))


def spawn_world(fn: Callable[..., Any], world_size: int,
                backend: str = "gloo", timeout_s: float = 120.0, *,
                args: tuple = ()) -> List[Any]:
    """``[fn(rank, world_size, *args) for rank in range(world_size)]``, each
    call in its own process of one process group (``backend``: ``"gloo"``
    on the CPU, ``"nccl"`` on cards, rank ``r`` on card ``r``).  ``fn``
    must be importable (a module-level function); each rank runs one
    thread (``torch.set_num_threads(1)``).  Raises ``RuntimeError`` with
    the rank's traceback if a rank fails and ``TimeoutError`` past
    ``timeout_s`` seconds; no process outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tgp_world_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init_file,
                               timeout_s, args, results),
                         daemon=True)
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_world: {world_size - len(got)} of {world_size} "
                    f"ranks of {fn.__name__} still running after "
                    f"{timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"spawn_world: a rank of {fn.__name__} exited with "
                        f"code {dead[0].exitcode} before reporting")
                continue
            if not ok:
                raise RuntimeError(_failures(fn, results, rank, payload))
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def single_rank_world(backend: str = "nccl", timeout_s: float = 120.0):
    """This process as rank 0 of a world of one (``backend``: ``"nccl"``
    on the current card, ``"gloo"`` on the CPU), joined through a
    ``file://`` rendezvous in a new temporary directory; the process
    group is destroyed on exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if backend == "nccl":  # the communicator's card, before any mesh
        torch.cuda.set_device(torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="tgp_world_")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
