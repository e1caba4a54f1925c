"""The readers of the program's own spans and counter (``odt.*``) on a
synthetic trace of two predict calls: device time a call under each int8
engine step, the epilogue's share of its bound scaled by the ranges whose
kernels the trace holds, the upload's host time, and an idle gap inside
the upload named after it. On a trace of a program without these spans,
or without the counter, each reads None."""

import pytest

from port_bench import counts, harness
from port_bench.trace import WINDOW_SPAN, Trace

NEW = ("im2col_device_ms.serve", "gemm_device_ms.serve", "epilogue_device_ms.serve",
       "epilogue_roofline.serve", "upload_host_ms.serve")
MOVED = 6.7e6  # epilogue bytes the counter read over both calls


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    """Two calls. The first's upload copy ends at 25 and its first kernel
    starts at 45: the device idles inside ``odt.upload`` (15 to 50). The
    first call's first epilogue kernel (correlation 3) is missing from the
    trace, as the first records of a window can be."""
    events = [_ann(WINDOW_SPAN, 0, 1000)]
    for t0, upload in ((10, 35), (450, 25)):
        events += [_ann("odt.predict", t0, 390), _ann("odt.upload", t0 + 5, upload),
                   _ann("odt.forward", t0 + 45, 335)]
        for i, step in enumerate(("im2col", "gemm", "epilogue", "epilogue")):
            events.append(_ann(f"odt.int8.{step}", t0 + 50 + 10 * i, 10))
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 0, "dur": 25,
                "args": {}}]
    launches = [(1, 62), (2, 72), (3, 82), (4, 92), (5, 502), (6, 512), (7, 522), (8, 532)]
    events += [_launch(corr, ts) for corr, ts in launches]
    events += [_kernel("im2col_copy", 1, 45, 30), _kernel("s8_gemm", 2, 75, 100),
               _kernel("mul_add", 4, 175, 50),
               _kernel("im2col_copy", 5, 600, 30), _kernel("s8_gemm", 6, 630, 100),
               _kernel("mul_add", 7, 730, 50), _kernel("requant", 8, 780, 50)]
    return events


def _run(events):
    return harness.Run("ssd300_int8_batch64", 1, 1.0, True, "program", 0.0, {}, {}, {}, {},
                       trace=Trace(events), host={"batch": 64})


def _read(name, r):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(r)


@pytest.fixture
def counted(monkeypatch):
    from object_detector_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"odt.int8.epilogue_bytes": MOVED,
                                                        "odt.predict.calls": 2})


def test_readers_on_a_trace_of_the_programs_spans(counted):
    r = _run(_events())
    assert _read("im2col_device_ms.serve", r) == pytest.approx(0.03)
    assert _read("gemm_device_ms.serve", r) == pytest.approx(0.1)
    assert _read("epilogue_device_ms.serve", r) == pytest.approx(0.075)
    assert _read("upload_host_ms.serve", r) == pytest.approx(0.03)
    # Three of the four epilogue ranges hold their kernels: three quarters
    # of the bytes, over the 150 µs the trace holds.
    least_us = MOVED * 0.75 / counts.HBM_BYTES_PER_S * 1e6
    assert _read("epilogue_roofline.serve", r) == pytest.approx(100 * least_us / 150)


def test_an_idle_gap_inside_the_upload_is_named_after_it():
    gaps = dict(Trace(_events()).idle_gaps())
    assert gaps["odt.upload"] == pytest.approx(20e-6)


def test_without_the_programs_spans_or_counter_the_readers_read_none(monkeypatch):
    from object_detector_tpu_torch.utils import profiling

    harness_only = [e for e in _events() if not e["name"].startswith("odt.")]
    for name in NEW:
        assert _read(name, _run(harness_only)) is None, name
        assert _read(name, _run([_ann(WINDOW_SPAN, 0, 10)])) is None, name
    monkeypatch.delattr(profiling, "counters")
    assert _read("epilogue_roofline.serve", _run(_events())) is None
