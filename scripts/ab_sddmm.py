#!/usr/bin/env python3
"""Time variants of the windowed SDDMM kernel (K6) against each other on
one card, in turns.

    python3 scripts/ab_sddmm.py SOURCE.cu [SOURCE.cu@-DFLAG ...]

Each argument is a CUDA source with ``tgp_tpu_torch/csrc/sddmm.cu``'s C
interface (``tgp_sddmm``), optionally followed by ``@`` and extra ``nvcc``
flags.  Every source is built with the port's flags (``-Xptxas -v``; its
registers and spills are printed), held to ``banded_sddmm_plain`` within
1e-5 of Σ|terms|, and timed on ``chip_smoke.py``'s banded graph (N =
65,536, E = 1,048,576, F = 128, |s − r| ≤ 448, window 1152): f32 and bf16
with the L2 flushed, f32 with a warm L2, two turns (forward, then reversed
order).  A source that exports ``tgp_sddmm_profile`` (per block, thread
0's clock64 counts) has them printed as block means.  Builds go to the
kernels' build directory (``build/``).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tgp_tpu_torch.ops.kernels import _build  # noqa: E402
from tgp_tpu_torch.ops.kernels import sddmm as SD  # noqa: E402

WINDOW = 1152
PROFILE = ["set-up", "wait+sync", "plan+early copies", "products",
           "late copies", "steps", "early steps", "total"]


def build(spec: str, i: int) -> ctypes.CDLL:
    src, *flags = spec.split("@")
    out = _build.BUILD_DIR / f"ab_sddmm_{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                        str(out), src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {spec}:\n{r.stdout}{r.stderr}")
    regs = [(k["kernel"], k["registers"], k["spill_stores"])
            for k in cs.ptxas_kernels(r.stdout + r.stderr)]
    print(f"[ab build] {spec} {time.perf_counter() - t0:.1f} s {regs}",
          flush=True)
    lib = ctypes.CDLL(str(out))
    lib.tgp_sddmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.tgp_sddmm.restype = ctypes.c_int
    return lib


def main(specs) -> int:
    if not torch.cuda.is_available() or not specs:
        print(__doc__, file=sys.stderr)
        return 2
    libs = {spec: build(spec, i) for i, spec in enumerate(specs)}
    s, r, _, _, x = (torch.tensor(v, device="cuda")
                     for v in cs.banded_graph())
    N, E, F = cs.BAND_NODES, cs.BAND_EDGES, cs.FEATURES
    b = torch.randn(N, F, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    ref = SD.banded_sddmm_plain(x, b, s, r, window=WINDOW)
    scale = SD.banded_sddmm_plain(x.abs(), b.abs(), s, r, window=WINDOW)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def run(lib, a_, b_):
        out = torch.empty(E, device="cuda")
        err = lib.tgp_sddmm(a_.data_ptr(), b_.data_ptr(), s.data_ptr(),
                            r.data_ptr(), out.data_ptr(), E, N, N, F, WINDOW,
                            SD.CHUNK_EDGES, SD._DTYPE_CODE[a_.dtype],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    xb, bb = x.to(torch.bfloat16), b.to(torch.bfloat16)
    rows = {spec: [] for spec in specs}
    for turn in range(2):
        for spec in (specs if turn == 0 else specs[::-1]):
            lib = libs[spec]
            got = run(lib, x, b)
            torch.cuda.synchronize()
            err = float(((got - ref).abs() / (scale + 1e-30)).max())
            if not err <= 1e-5:
                raise AssertionError(f"{spec}: max err/scale {err}")
            rows[spec].append((cs.median_ms(lambda: run(lib, x, b), flush),
                               cs.median_ms(lambda: run(lib, xb, bb), flush),
                               cs.median_ms(lambda: run(lib, x, b), None)))
    for spec, lib in libs.items():
        if not hasattr(lib, "tgp_sddmm_profile"):
            continue
        lib.tgp_sddmm_profile.argtypes = [ctypes.c_void_p]
        for dt in (torch.float32, torch.bfloat16):
            run(lib, x.to(dt), b.to(dt))
            torch.cuda.synchronize()
            buf = np.zeros((4096, 8), np.uint64)
            if lib.tgp_sddmm_profile(buf.ctypes.data):
                raise RuntimeError("tgp_sddmm_profile failed")
            used = buf[buf[:, 7] > 0].astype(np.float64)
            print(f"[ab profile {dt}] {spec}, {len(used)} blocks: " + ", ".join(
                f"{n} {v:.0f}" for n, v in zip(PROFILE, used.mean(0))),
                flush=True)
    for spec, v in rows.items():
        print(f"[ab sddmm] {spec}: f32 ms {[round(t[0], 5) for t in v]} "
              f"bf16 ms {[round(t[1], 5) for t in v]} warm-L2 f32 ms "
              f"{[round(t[2], 5) for t in v]}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
