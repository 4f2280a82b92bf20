#!/usr/bin/env python3
"""Time build variants of K4's long-segment kernel or K5's ring kernel
against each other on one card, in turns.

    python3 scripts/ab_k4_k5.py k4 VARIANT [VARIANT ...]
    python3 scripts/ab_k4_k5.py k5 VARIANT [VARIANT ...]
    python3 scripts/ab_k4_k5.py routes

A variant is ``""`` (the committed source:
``tgp_tpu_torch/csrc/segment_reduce.cu`` for k4, ``banded_spmm.cu`` for
k5), a copy of it with the same C interface (``VARIANT.cu``), or either
with extra ``nvcc`` flags after an ``@`` (``VARIANT.cu@FLAGS``,
``@FLAGS``).  Every
variant is built with the port's flags (its registers and spills are
printed), held to the plain version within 1e-5 of Σ|terms| (plus one
bf16 rounding) and required to give the same bits twice, then timed with
the L2 flushed (``chip_smoke.median_ms``), two turns (forward, then
reversed order).

k4 shapes: the serving readout (one segment of 65,536 f32 rows of 128,
half of them masked: the plain sum of the masked rows zeroed, and the
readout's gathered call with the mask and an identity order), the same
in bf16, 64 segments of 256 rows (the dense cell as one sparse batch)
and 512 of 32 (a batch of small graphs).  k5: ``chip_smoke.py``'s banded
graph (N = 65,536, E = 1,048,576, F = 128, |s − r| ≤ 448, window 1152)
in bf16 and f32.  Builds go to the kernels' build directory
(``build/``).

``routes`` times the readout's gathered sum (``gather_segment_sum``'s
kernel call) on K4's two routes, ``"long"`` and ``"wide"``, on f32 rows
of 128 (a tenth masked): 16,384 rows cut into segments of 8 to 1,024,
then 1,024 segments of 18, 64 and 256 rows and 4,096 of 64: where the
shape rule ``segment_route`` should send the readout.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tgp_tpu_torch.ops.kernels import _build  # noqa: E402
from tgp_tpu_torch.ops.kernels import segment_spmm as K  # noqa: E402

SOURCES = {"k4": "segment_reduce", "k5": "banded_spmm"}


def build(kernel: str, spec: str, i: int) -> ctypes.CDLL:
    src, _, flags = spec.partition("@")
    src = src or str(_build.CSRC / f"{SOURCES[kernel]}.cu")
    out = _build.BUILD_DIR / f"ab_{kernel}_{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags.split(),
                        "-o", str(out), src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {spec!r}:\n{r.stdout}{r.stderr}")
    regs = [(k["kernel"], k["registers"], k["spill_stores"],
             k["spill_loads"])
            for k in cs.ptxas_kernels(r.stdout + r.stderr)]
    print(f"[ab build] {kernel} {spec!r} {time.perf_counter() - t0:.1f} s "
          f"{regs}", flush=True)
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if kernel == "k4":
        lib.tgp_segment_reduce.argtypes = [vp] * 7 + [i32] * 6 + [vp]
        lib.tgp_segment_reduce_chunks.argtypes = [vp] * 2 + [i32] * 3
        lib.tgp_segment_reduce_chunks.restype = i32
    else:
        lib.tgp_banded_spmm.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    return lib


def k4_cases():
    """(name, x, perm, keep, row_ptr, num_rows, plain result, scale)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for name, rows, segs, dtype in (
            ("readout 1 x 65,536 f32", 65_536, 1, torch.float32),
            ("readout 1 x 65,536 bf16", 65_536, 1, torch.bfloat16),
            ("readout 64 x 256 f32", 16_384, 64, torch.float32),
            ("readout 512 x 32 f32", 16_384, 512, torch.float32)):
        x = torch.randn(rows, cs.FEATURES, generator=gen,
                        device="cuda").to(dtype)
        keep = torch.rand(rows, generator=gen, device="cuda") < 0.5
        rp = (torch.arange(segs + 1, device="cuda") * (rows // segs)).to(
            torch.int32)
        perm = torch.arange(rows, dtype=torch.int32, device="cuda")
        masked = torch.where(keep[:, None], x, 0.0).contiguous()
        ref = K.sorted_segment_sum_plain(masked, None, rp, segs)
        scale = K.sorted_segment_sum_plain(masked.float().abs(), None, rp,
                                           segs)
        cases.append((name, masked, None, None, rp, segs, ref, scale))
        cases.append((name + " gathered", x, perm, keep, rp, segs, ref,
                      scale))
    return cases


def run_k4(lib, x, perm, keep, rp, segs):
    n = x.shape[0]
    out = torch.empty(segs, x.shape[1], dtype=x.dtype, device="cuda")
    code = K._DTYPE_CODE[x.dtype]
    chunks = lib.tgp_segment_reduce_chunks(x.data_ptr(), out.data_ptr(), n,
                                           x.shape[1], code)
    key = (id(lib), chunks, x.shape[1])
    if key not in run_k4.scratch:
        run_k4.scratch[key] = (
            torch.zeros(3 * chunks, dtype=torch.int32, device="cuda"),
            torch.empty(2 * chunks * x.shape[1], device="cuda"))
    counters, part = run_k4.scratch[key]
    err = lib.tgp_segment_reduce(
        x.data_ptr(), None if perm is None else perm.data_ptr(),
        None if keep is None else keep.data_ptr(), rp.data_ptr(),
        part.data_ptr(), counters.data_ptr(), out.data_ptr(), n, n, segs,
        x.shape[1], chunks, code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


run_k4.scratch = {}


def k5_cases():
    from tgp_tpu_torch.ops.ordering import choose_banded_window

    s, r, w, rp, x = (torch.tensor(v, device="cuda")
                      for v in cs.banded_graph())
    window = choose_banded_window(cs.BAND_BW)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        ref = K.banded_sorted_spmm_plain(xd, s, rp, w, cs.BAND_NODES,
                                         window=window)
        scale = K.banded_sorted_spmm_plain(xd.float().abs(), s, rp, w.abs(),
                                           cs.BAND_NODES, window=window)
        cases.append((f"banded F=128 {str(dtype)[6:]}", xd, s, w, rp,
                      window, ref, scale))
    return cases


def run_k5(lib, x, s, w, rp, window):
    N = x.shape[0]
    out = torch.empty_like(x)
    err = lib.tgp_banded_spmm(x.data_ptr(), s.data_ptr(), w.data_ptr(),
                              rp.data_ptr(), out.data_ptr(), N, s.shape[0],
                              N, x.shape[1], window, 128,
                              K._DTYPE_CODE[x.dtype], 1,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def routes() -> int:
    """Both routes of the gathered sum over segment lengths, in turns."""
    print(cs.card_line(), flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    shapes = [(16_384 // seg, seg) for seg in (8, 16, 32, 64, 128, 256,
                                                 512, 1024)]
    for B, seg in shapes + [(1024, 18), (1024, 64), (1024, 256),
                            (4096, 64)]:
        n = B * seg
        x = torch.randn(n, cs.FEATURES, generator=gen, device="cuda")
        keep = torch.rand(n, generator=gen, device="cuda") >= 0.1
        perm = torch.arange(n, dtype=torch.int32, device="cuda")
        rp = (torch.arange(B + 1, device="cuda") * seg).to(torch.int32)
        ref = K.gather_segment_sum_plain(x, perm, keep, rp, B)
        scale = K.gather_segment_sum_plain(x.abs(), perm, keep, rp, B)
        ms = {}
        for turn in range(2):
            for route in (K.SEGMENT_ROUTES if turn == 0
                          else K.SEGMENT_ROUTES[::-1]):
                def fn(route=route):
                    return K._k4_sum(x, perm, keep, rp, B, route)
                cs._worst(f"{route} {B} x {seg}", fn(), ref, scale,
                          cs.REL_TOL)
                ms.setdefault(route, []).append(cs.median_ms(fn, flush))
        print(f"[ab routes] {B} x {seg} rows: rule "
              f"{K.segment_route(B, n, cs.FEATURES)}, ms "
              + ", ".join(f"{r} {[round(t, 5) for t in v]}"
                          for r, v in ms.items()), flush=True)
    print(cs.card_line(), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["routes"] and torch.cuda.is_available():
        return routes()
    if len(argv) < 2 or argv[0] not in SOURCES or \
            not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    kernel, specs = argv[0], argv[1:]
    print(cs.card_line(), flush=True)
    libs = {spec: build(kernel, spec, i) for i, spec in enumerate(specs)}
    if kernel == "k4":
        cases = [(c[0], lambda lib, c=c: run_k4(lib, *c[1:6]), c[6], c[7])
                 for c in k4_cases()]
    else:
        cases = [(c[0], lambda lib, c=c: run_k5(lib, *c[1:6]), c[6], c[7])
                 for c in k5_cases()]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = {(spec, c[0]): [] for spec in specs for c in cases}
    for turn in range(2):
        for spec in (specs if turn == 0 else specs[::-1]):
            lib = libs[spec]
            for name, fn, ref, scale in cases:
                got = fn(lib)
                again = fn(lib)
                torch.cuda.synchronize()
                cs._worst(f"{spec!r} {name}", got, ref, scale, cs.REL_TOL,
                          cs.BF16_ULP if got.dtype == torch.bfloat16 else 0.0)
                if not torch.equal(got, again):
                    raise AssertionError(f"{spec!r} {name}: two runs differ")
                times[(spec, name)].append(
                    cs.median_ms(lambda: fn(lib), flush))
    for (spec, name), v in times.items():
        print(f"[ab {kernel}] {spec!r} {name}: ms "
              f"{[round(t, 5) for t in v]}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
