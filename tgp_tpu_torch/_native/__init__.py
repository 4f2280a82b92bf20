"""ctypes loader for the host-side C++ of the precoarsening path (port of
``tgp_tpu/_native/__init__.py``), built on demand.

``native.cpp`` compiles with the C++ compiler on ``PATH`` (``$CXX``, else
``g++``) into ``build/`` at the checkout root, as one shared library named
by a hash of the source and the flags, so an edited source never loads a
stale build.  The flags keep floating-point contraction off: SEP's merge
breaks exact ties on its entropy deltas, and an FMA would round them
differently from the Python twin.

The level functions fall back to their numpy twins only where no compiler
is found (:func:`available`); a build that fails raises with the
compiler's output.  :data:`engine_runs` counts the calls each engine
served (``"native"``, ``"numpy"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["available", "load", "library_path", "native_graclus_matching",
           "native_maximal_matching", "native_propagate_assignments",
           "native_sep_merge", "engine_runs", "note_engine"]

SOURCE = Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")

#: calls served by each engine
engine_runs: Dict[str, int] = {"native": 0, "numpy": 0}
_lib = None


def note_engine(engine: str) -> None:
    """Count one call served by ``engine`` (``"native"`` or ``"numpy"``)."""
    engine_runs[engine] += 1


def compiler() -> Optional[str]:
    """The C++ compiler on ``PATH`` (``$CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def available() -> bool:
    """Whether the native library can be used: a compiler is on ``PATH``
    (or the library is loaded already)."""
    return _lib is not None or compiler() is not None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libtgp_native-{digest}.so"


def _build(path: Path) -> None:
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH: the native host "
                           "library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none


def load() -> ctypes.CDLL:
    """The native library, built first if it is missing."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.graclus_matching.argtypes = [i64, i64, i64p, i64p, f64p,
                                     ctypes.c_uint64, i64p]
    lib.maximal_matching_ranked.argtypes = [i64, i64, i64p, i64p, i64p, u8p]
    lib.propagate_assignments.argtypes = [i64, i64, i64p, i64p, i64, i64,
                                          i64p]
    lib.sep_merge_tree.argtypes = [i64, i64, i64p, i64p, f64p, i64p, f64p,
                                   f64p, ctypes.POINTER(i64)]
    for fn in (lib.graclus_matching, lib.maximal_matching_ranked,
               lib.propagate_assignments, lib.sep_merge_tree):
        fn.restype = None
    _lib = lib
    return lib


def _edges(edge_index, num_nodes):
    """``(E, senders, receivers)`` as contiguous int64; ids outside
    ``[0, num_nodes)`` raise (the C++ indexes by them unchecked)."""
    ei = np.ascontiguousarray(np.asarray(edge_index), np.int64).reshape(2, -1)
    if ei.size and (ei.min() < 0 or ei.max() >= num_nodes):
        raise ValueError(f"edge ids must lie in [0, {num_nodes}), got "
                         f"[{ei.min()}, {ei.max()}]")
    return ei.shape[1], np.ascontiguousarray(ei[0]), np.ascontiguousarray(ei[1])


def _weights(edge_weight, e):
    return np.ascontiguousarray(
        np.ones(e) if edge_weight is None else np.asarray(edge_weight),
        np.float64)


def native_graclus_matching(edge_index, num_nodes, edge_weight=None,
                            seed: int = 0) -> np.ndarray:
    """Heaviest-first greedy matching: ``cluster [n]``, matched pairs
    first (in match order), then singletons."""
    lib = load()
    e, src, dst = _edges(edge_index, num_nodes)
    out = np.empty(num_nodes, np.int64)
    lib.graclus_matching(num_nodes, e, src, dst, _weights(edge_weight, e),
                         seed, out)
    return out


def native_maximal_matching(edge_index, num_nodes, rank) -> np.ndarray:
    """``[E]`` bool: the edges of the greedy maximal matching by rank."""
    lib = load()
    e, src, dst = _edges(edge_index, num_nodes)
    rank = np.ascontiguousarray(np.asarray(rank), np.int64)
    if rank.shape != (e,):
        raise ValueError(f"rank must be [{e}], got {rank.shape}")
    out = np.zeros(e, np.uint8)
    lib.maximal_matching_ranked(num_nodes, e, src, dst, rank, out)
    return out.astype(bool)


def native_propagate_assignments(edge_index, assignments, max_iter: int,
                                 num_clusters: int) -> np.ndarray:
    """Majority-vote rounds filling the unassigned (−1) nodes."""
    lib = load()
    a = np.ascontiguousarray(np.asarray(assignments), np.int64).copy()
    e, src, dst = _edges(edge_index, a.shape[0])
    lib.propagate_assignments(a.shape[0], e, src, dst, max_iter,
                              num_clusters, a)
    return a


def native_sep_merge(edge_index, num_nodes, edge_weight=None):
    """SEP's greedy structural-entropy merge phase.  Returns ``(parent
    [n_total], vol [n_total], cut [n_total], n_total)``: leaves are
    ``0..n-1``, internal nodes appended, ``parent == -1`` marks roots."""
    lib = load()
    e, src, dst = _edges(edge_index, num_nodes)
    cap = max(2 * num_nodes, 1)
    parent = np.full(cap, -1, np.int64)
    vol = np.zeros(cap, np.float64)
    cut = np.zeros(cap, np.float64)
    n_total = ctypes.c_int64(0)
    lib.sep_merge_tree(num_nodes, e, src, dst, _weights(edge_weight, e),
                       parent, vol, cut, ctypes.byref(n_total))
    nt = n_total.value
    return parent[:nt], vol[:nt], cut[:nt], nt
