"""The operation and byte counts against a hand count, and the trace
readers on a trace made by hand."""

import importlib.util

import pytest

import cellkit
import devtrace
import harness


def metric(name):
    path = cellkit.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_least_ops_by_hand():
    roof = metric("sweep_roofline")
    # a pass: closures 12 + 10 + 21 + 8, fluxes 2, differences 12,
    # source 16, update 12 = 93, plus the EOS; two passes and the average
    assert sum(roof.PASS_OPS.values()) == 93
    dh = {"EOS": "DH", "shear": 0.0794, "bulk": 0.}
    bwr = {"EOS": "BWR", "shear": 2.15, "bulk": 0.}
    assert roof.least_ops(dh) == 2 * (93 + 7) + 6 == 206
    assert roof.least_ops(bwr) == 2 * (93 + 34) + 6 == 260
    with pytest.raises(NotImplementedError):
        roof.least_ops(dict(dh, bulk=1.))
    with pytest.raises(NotImplementedError):
        roof.least_ops(dict(dh, thinning={"name": "Eyring"}))


def test_least_time_by_hand():
    roof = metric("sweep_roofline")
    peak = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    cells = 2048 * 2048
    t, by = roof.least_seconds_per_step({"EOS": "DH", "bulk": 0.}, cells,
                                        1024, peak)
    assert by == "operations"
    assert t == pytest.approx(206 * cells / 67e12)
    # one step a chunk: 36 bytes a cell against 206 operations
    t, by = roof.least_seconds_per_step({"EOS": "DH", "bulk": 0.}, cells,
                                        1, peak)
    assert by == "bytes" and t == pytest.approx(36 * cells / 3.35e12)


def ev(name, ts, dur, cat="kernel", corr=None):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


class HandTrace:
    """Events of a trace made by hand: host ranges named ``chunk``, and
    kernels with the host call that launched each."""

    def __init__(self):
        self.events, self.corr = [], 0

    def launch(self, name, host_ts, ts, dur, cat="kernel"):
        self.corr += 1
        self.events.append(ev("cudaLaunchKernel", host_ts, 2.,
                              "cuda_runtime", self.corr))
        self.events.append(ev(name, ts, dur, cat, self.corr))

    def trace(self, chunks):
        trace = devtrace.Trace({"traceEvents": self.events})
        trace.chunk_steps = [1024] * chunks
        return trace


SWEEP = "void sweep_kernel<3>(float*)"


def hand_trace():
    """Three chunks of two port kernels (100 us each, back to back),
    between chunks a reduction (10 us) and 30 us of idle, a memcpy, and a
    host op; padding idle before and after."""
    h, t = HandTrace(), 1000.
    for c in range(3):
        h.events.append(ev("chunk", t - 50., 30., "user_annotation"))
        for k in range(2):
            h.launch(SWEEP, t - 45. + 10. * k, t + 100. * k, 100.)
        t += 200.
        if c < 2:
            h.launch("void at::native::reduce_kernel<512>(x)", t - 10.,
                     t + 5., 10.)
            h.launch("Memcpy DtoH", t, t + 15., 5., "gpu_memcpy")
            h.events.append(ev("aten::item", t + 20., 20., "cpu_op"))
            t += 50.
    return h.trace(3)


def test_chunks_follow_the_host_ranges():
    """Chunks with nothing launched between them, and a PyTorch kernel
    launched inside a chunk call, are told apart by the chunk ranges."""
    h, t = HandTrace(), 1000.
    for c in range(3):
        h.events.append(ev("chunk", t - 50., 40., "user_annotation"))
        h.launch("void at::native::elementwise_kernel<4>(x)", t - 45., t,
                 10.)
        for k in range(2):
            h.launch(SWEEP, t - 40. + 10. * k, t + 10. + 100. * k, 100.)
        t += 210. + 20.
    # a port kernel launched outside every chunk range is no chunk's
    h.launch(SWEEP, t + 100., t + 200., 100.)
    trace = h.trace(3)
    groups = trace.chunks()
    assert [len(g) for g in groups] == [2, 2, 2]
    assert all(op["name"] == SWEEP for g in groups for op in g)
    assert trace.complete()
    assert trace.gaps() == [(1210., 1240.), (1440., 1470.)]
    assert trace.window() == (1010., 1670.)
    # the host inside a chunk call, between its launches
    assert trace.host_label(1210., 1240.) == "chunk"
    h.events.append(ev("aten::item", 1215., 5., "cpu_op"))
    assert devtrace.Trace({"traceEvents": h.events}).host_label(
        1210., 1240.) == "aten::item"
    # without the ranges no kernel belongs to a chunk
    bare = devtrace.Trace({"traceEvents": [
        e for e in h.events if e["cat"] != "user_annotation"]})
    bare.chunk_steps = [1024] * 3
    assert bare.chunks() == [] and not bare.complete()
    assert bare.window() is None


def test_trace_readers_by_hand(tmp_path):
    root = cellkit.make_root(tmp_path)
    cell = harness.Cell("journal-dh.t32", root)
    run = harness.Run(cell)
    run.trace = hand_trace()
    run.counters["cells"] = 2048 * 2048
    run.device_kind = "NVIDIA H100 80GB HBM3"
    assert run.trace.complete()
    assert run.trace.window() == (1000., 1000. + 600. + 100.)
    # per boundary: 50 us between chunks, 15 of it busy
    assert metric("driver_gap_ms_per_chunk").read(run) == \
        pytest.approx(0.035)
    assert metric("sweep_us_per_step").read(run) == \
        pytest.approx(600. / 3072)
    assert metric("device_idle_share").read(run) == \
        pytest.approx(100. * 70. / 700.)
    least = 206 * 2048 * 2048 / 67e12
    assert metric("sweep_roofline").read(run) == \
        pytest.approx(100. * least / (600e-6 / 3072))
    bd = run.trace.breakdown()
    assert bd["device_ops"][0] == [SWEEP, 600e-6]
    # after each chunk: 5 us, the reduction and the copy, 30 us
    assert len(bd["idle_gaps"]) == 4
    assert bd["idle_gaps"][0] == ["aten::item", pytest.approx(30e-6)]


def test_lost_chunk_leaves_metrics_out(tmp_path):
    root = cellkit.make_root(tmp_path)
    run = harness.Run(harness.Cell("journal-dh.t32", root))
    run.trace = hand_trace()
    run.trace.chunk_steps = [1024, 1024, 1024, 1024]
    for name in ("driver_gap_ms_per_chunk", "sweep_us_per_step",
                 "device_idle_share", "sweep_roofline"):
        assert metric(name).read(run) is None


def test_library_kernels_are_not_the_ports():
    assert devtrace.is_port_kernel({"cat": "kernel",
                                    "name": "void multi_step_kernel<1>()"})
    for name in ("void at::native::reduce_kernel<512, 1>()",
                 "void cub::DeviceReduceKernel()",
                 "void at::native::vectorized_elementwise_kernel<4>()"):
        assert not devtrace.is_port_kernel({"cat": "kernel", "name": name})
    assert not devtrace.is_port_kernel({"cat": "gpu_memcpy",
                                        "name": "Memcpy DtoH"})


def test_host_clock_readers_by_hand(tmp_path):
    root = cellkit.make_root(tmp_path)
    run = harness.Run(harness.Cell("journal-dh.t32", root))
    run.calls = [0.1, 0.3, 0.5, 0.8, 1.0]
    run.spans["window"] = 1.9
    assert metric("chunk_ms").read(run) == pytest.approx(200.)
    # 0.9 s after the last call, less the last chunk's own 0.2 s
    assert metric("finish_s").read(run) == pytest.approx(0.7)
    run.calls = [0.1, 0.3]
    assert metric("chunk_ms").read(run) is None
    assert metric("finish_s").read(run) is None
