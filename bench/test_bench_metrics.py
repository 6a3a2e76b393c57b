"""The metric arithmetic: time per transform over the window, and the
trace reductions."""
import pytest

from bench import counts, devtrace
from bench.conftest import small_cell
from bench.drivers import roundtrip


def test_time_per_transform_is_summed_over_the_window():
    d = roundtrip.Driver(small_cell("soft-b128-f64.roundtrip"), 1, "cpu")
    d.steps, d.time = 5, {"inverse": 0.8, "forward": 1.2}
    e2e = d.end_to_end()
    assert e2e["inverse_ms"] == pytest.approx(1e3 * 0.8 / (5 * d.n))
    assert e2e["forward_ms"] == pytest.approx(1e3 * 1.2 / (5 * d.n))
    assert d.host()["forward"] == {"seconds": 1.2, "transforms": 5 * d.n}


def _trace():
    ev = []

    def X(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    X("user_annotation", "bench.window", 0, 1000)
    X("user_annotation", "bench.forward", 100, 300)       # 100..400
    X("user_annotation", "bench.forward", 500, 300)       # 500..800
    X("kernel", "void dwt_fused_fwd<double, 8>", 110, 100)
    X("kernel", "vector_fft<256u>", 220, 50)
    X("kernel", "void dwt_fused_fwd<double, 8>", 510, 100)
    X("gpu_memcpy", "Memcpy DtoD", 650, 50)
    X("kernel", "outside any call", 900, 20)
    X("cpu_op", "aten::argmax", 350, 100)
    return devtrace.Trace(ev)


def test_trace_reductions():
    cell = small_cell("soft-b128-f64.roundtrip", B=128)
    view = devtrace.View(_trace(), cell,
                         host={"forward": {"seconds": 4e-4,
                                           "transforms": 2}},
                         device_kind="NVIDIA H100 80GB HBM3")
    # 100 us of non-DWT device time over 2 transforms
    assert devtrace.glue_ms(view, "forward") == pytest.approx(0.05)
    bound = 2 * counts.dwt_bytes(128) / 3.35e12
    assert devtrace.dwt_roofline(view, "forward") == pytest.approx(
        100 * bound / 200e-6)
    # busy in the calls: 100 + 50 + 100 + 50 of 600 us
    assert devtrace.idle(view, "forward") == pytest.approx(
        100 * (1 - 300 / 600))
    assert devtrace.busy_s(view.trace) == pytest.approx((320e-6, 1e-3))
    mfu = devtrace.transform_mfu(view, "forward")
    assert mfu == pytest.approx(100 * 2 * 4.2e9 / 4e-4 / 67e12, rel=0.01)
    assert devtrace.glue_ms(view, "inverse") is None
    br = devtrace.breakdown(view.trace)
    assert br["device_ops"][0] == ["void dwt_fused_fwd<double, 8>",
                                   pytest.approx(200e-6)]
    labels = dict(br["idle_gaps"])
    assert labels["aten::argmax"] == pytest.approx(240e-6)   # gap 270..510
    assert labels["no host range"] == pytest.approx(110e-6)  # 0..110
    assert labels["after bench.forward"] == pytest.approx(80e-6)
    assert sum(labels.values()) == pytest.approx(680e-6)


def test_readers_find_nothing_without_a_trace():
    cell = small_cell("soft-b128-f64.roundtrip")
    view = devtrace.View(None, cell, host={}, device_kind="cpu")
    assert devtrace.glue_ms(view, "forward") is None
    assert devtrace.dwt_roofline(view, "forward") is None
    assert devtrace.idle(view, "forward") is None
    assert devtrace.transform_mfu(view, "forward") is None
