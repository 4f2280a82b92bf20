"""The statistics and the trace's reduction, on made-up numbers."""

import pytest

from portbench.harness import spec, trace


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_latency_statistics_cover_all_requests():
    lat = [i / 1000 for i in range(1, 101)]  # 1 ms ... 100 ms
    ctx = dict(latencies_s=lat)
    assert read("serve_p50_ms", ctx) == pytest.approx(50.5)
    assert read("serve_p95_ms", ctx) == pytest.approx(95.05)
    assert read("serve_p50_ms", dict(latencies_s=[])) is None


def test_step_time_is_window_over_steps():
    assert read("train_step_ms", dict(window_s=2.0, steps=400)) == 5.0
    assert read("train_step_ms", dict(window_s=2.0, steps=0)) is None
    assert read("setup_s", dict(setup_s=12.5)) == 12.5


def ev(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def requests_trace():
    """Two requests of 100 µs: the first launches at +40 µs, the device
    busy 30 µs of its span; the second launches at +10 µs, busy 55, 5 of
    them in a kernel of the same name but another template (K4's)."""
    return [
        ev("user_annotation", trace.ITER, 0, 100),
        ev("cpu_op", "aten::to", 0, 60),
        ev("cuda_runtime", "cudaMemcpyAsync", 6, 2),
        ev("gpu_memcpy", "Memcpy HtoD", 8, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 3),
        ev("kernel", "void csr_wide_kernel<bf16, 8, false>(...)", 50, 20),
        ev("user_annotation", trace.ITER, 200, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 3),
        ev("kernel", "other_kernel", 220, 30),
        ev("kernel", "void csr_narrow_kernel<float, 1, false>(...)", 260,
           20),
        ev("kernel", "void csr_wide_kernel<float, 4, true>(...)", 290, 5),
    ]


def test_reduce_requests():
    red = trace.reduce(requests_trace(), {"spmm_csr": [
        ["csr_wide_kernel<", ", false>("], ["csr_narrow_kernel<", "false>("]]})
    assert [it["prep_s"] for it in red["iters"]] == pytest.approx(
        [40e-6, 10e-6])
    assert [it["busy_s"] for it in red["iters"]] == pytest.approx(
        [30e-6, 55e-6])
    assert red["kernels"] == 4
    assert red["op_device_s"]["spmm_csr"] == pytest.approx(40e-6)
    assert red["window_s"] == pytest.approx(300e-6)
    assert red["busy_s"] == pytest.approx(85e-6)
    names = dict(red["idle_gaps"])
    assert "aten::to" in names  # the gap beneath the copy's host op
    ctx = dict(loop="serve", trace=red)
    assert read("serve.prep_ms", ctx) == pytest.approx(0.025)
    assert read("serve.device_busy_ms", ctx) == pytest.approx(0.0425)
    assert read("serve.idle_share", ctx) == pytest.approx(57.5)


def test_reduce_steps_window_ends_at_the_sync():
    evs = [ev("user_annotation", trace.ITER, 0, 10),
           ev("user_annotation", trace.ITER, 10, 10),
           ev("cuda_runtime", "cudaLaunchKernel", 2, 1),
           ev("kernel", "k", 5, 40),
           ev("user_annotation", trace.SYNC, 20, 30)]
    red = trace.reduce(evs, {})
    assert red["window_s"] == pytest.approx(50e-6)
    assert red["busy_s"] == pytest.approx(40e-6)
    ctx = dict(loop="train", trace=red, work=[{}, {}])
    assert read("train.device_busy_ms", ctx) == pytest.approx(0.020)
    assert read("train.idle_share", ctx) == pytest.approx(20.0)
    assert read("train.launches_per_step", ctx) == pytest.approx(0.5)


def test_nothing_to_read_gives_nothing():
    assert trace.reduce([ev("kernel", "k", 0, 5)], {}) == {}
    for name in ("serve.prep_ms", "serve.mfu", "k1_roofline.serve",
                 "train.idle_share", "k3_roofline.train"):
        assert read(name, dict(loop="serve", trace={}, work=[])) is None
    # a kernel table whose kernels never ran: no roofline share, not 0
    red = trace.reduce(requests_trace(), {"dense_bmm": [["bmm_tma_kernel<"]]})
    ctx = dict(loop="train", trace=red, peaks=spec.peaks(),
               work=[dict(ops=[dict(name="dense_bmm", flops=1e9, bytes=1e6,
                                    peak="bf16_tensor_flops")])] * 2)
    assert read("k3_roofline.train", ctx) is None
