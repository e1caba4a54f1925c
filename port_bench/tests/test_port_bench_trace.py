"""The reduction of a device trace: busy time as the union of intervals,
kernels attributed to the span whose host range holds their launch, idle
gaps labelled by the innermost span, and the readers built on them."""

import pytest

from port_bench import counts, harness, kernels
from port_bench.trace import CLOCK_SPAN, WINDOW_SPAN, Trace


def _events():
    ann = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation", "name": name,  # noqa: E731
                                 "ts": ts, "dur": dur, "tid": 1}
    launch = lambda corr, ts: {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",  # noqa: E731
                               "ts": ts, "dur": 1, "args": {"correlation": corr}}
    kernel = lambda name, corr, ts, dur: {"ph": "X", "cat": "kernel", "name": name,  # noqa: E731
                                          "ts": ts, "dur": dur, "args": {"correlation": corr}}
    return [
        ann(WINDOW_SPAN, 0, 1000), ann("forward", 10, 100), ann("postprocess", 120, 50),
        ann("readback", 175, 300),
        launch(1, 20), kernel("void elementwise_kernel<float>", 1, 100, 200),
        launch(2, 30), kernel("sm90_xmma_gemm_s8", 2, 250, 150),  # overlaps the first
        launch(3, 130), kernel("nms_rows_kernel(float const*)", 3, 500, 100),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 700, "dur": 50, "args": {}},
        kernel("outside the window", 9, 2000, 10),
    ]


def test_device_clock_is_held_to_the_events():
    """A trace whose device timestamps run at half speed: the markers 450 µs
    apart on the device and 900 µs apart by the events rescale it."""
    ann = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation", "name": name,  # noqa: E731
                                 "ts": ts, "dur": dur, "tid": 1}
    launch = lambda corr, ts: {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",  # noqa: E731
                               "ts": ts, "dur": 1, "args": {"correlation": corr}}
    kernel = lambda name, corr, ts, dur: {"ph": "X", "cat": "kernel", "name": name,  # noqa: E731
                                          "ts": ts, "dur": dur, "args": {"correlation": corr}}
    events = [ann(WINDOW_SPAN, 0, 1000), ann(CLOCK_SPAN, 2, 4), ann("forward", 10, 50),
              ann(CLOCK_SPAN, 940, 4),
              launch(1, 3), kernel("fill", 1, 24, 1), launch(2, 20), kernel("gemm", 2, 50, 100),
              launch(3, 941), kernel("fill", 3, 474, 1)]
    t = Trace(events, clock=[0.0, 900.0])
    assert t.clock_ratio == pytest.approx(0.5)
    assert t.kernels("forward") == [("gemm", pytest.approx(200.0))]
    assert t.busy_intervals()[1] == (pytest.approx(75.0), pytest.approx(275.0))
    assert Trace(events).kernels("forward") == [("gemm", 100.0)]  # no clock: as recorded
    # A third marker 100 µs on at the right speed: each piece keeps its own.
    later = [ann(CLOCK_SPAN, 960, 4), ann("postprocess", 965, 10), launch(4, 961),
             kernel("fill", 4, 574, 1), launch(5, 966), kernel("nms_rows_kernel", 5, 520, 40)]
    t = Trace(events + later, clock=[0.0, 900.0, 1000.0])
    assert t.clock_pieces == [pytest.approx(0.5), pytest.approx(1.0)]
    assert t.kernels("forward") == [("gemm", pytest.approx(200.0))]
    assert t.kernels("postprocess") == [("nms_rows_kernel", pytest.approx(40.0))]


def test_busy_is_the_union_of_device_intervals():
    t = Trace(_events())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_intervals() == [(100.0, 400.0), (500.0, 600.0), (700.0, 750.0)]
    assert t.busy_s == pytest.approx(450e-6)


def test_kernels_belong_to_the_span_that_launched_them():
    t = Trace(_events())
    assert [n for n, _ in t.kernels("forward")] == ["void elementwise_kernel<float>",
                                                     "sm90_xmma_gemm_s8"]
    assert t.kernels("postprocess") == [("nms_rows_kernel(float const*)", 100.0)]
    assert kernels.time_of(t.kernels(), "nms") == (1, 100.0)
    assert kernels.is_library("sm90_xmma_gemm_s8") and not kernels.is_hand("sm90_xmma_gemm_s8")
    assert not kernels.is_library("nms_rows_kernel(float const*)")


def test_idle_gaps_name_the_innermost_span():
    gaps = dict(Trace(_events()).idle_gaps())
    # 0-100 in forward (10-110), 400-500 in readback (175-475), 600-700 and
    # 750-1000 in no span.
    assert gaps["forward"] == pytest.approx(100e-6)
    assert gaps["readback"] == pytest.approx(100e-6)
    assert gaps["host"] == pytest.approx(350e-6)


def test_readers_on_a_trace():
    t = Trace(_events())
    r = harness.Run("ssd300_int8_batch64", 1, 1.0, True, "program", 0.0, {}, {
        "resolved": harness.load_json(harness.BENCH / "configs" / "ssd300_vgg16_voc.json")
        ["resolved"]}, {}, {}, trace=t, host={"batch": 64, "nms_calls": [(1000, 1280, 512, 100, 4)]})
    read = lambda name: harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(r)  # noqa: E731
    assert read("forward_device_ms.serve") == pytest.approx(0.35)
    assert read("eager_device_ms.serve") == pytest.approx(0.2)
    assert read("postprocess_device_ms.serve") == pytest.approx(0.1)
    assert read("idle_pct.serve") == pytest.approx(55.0)
    assert read("nms_roofline.serve") == pytest.approx(
        100 * counts.nms_bound_ms(1000, 1280, 512, 100)[0] * 1e3 / 100.0)
    assert read("stem_fp_roofline.serve") is None  # not in this trace: nothing to read
