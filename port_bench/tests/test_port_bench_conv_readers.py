"""The readers of the int8 engine's one-kernel 3x3 convs (``odt.int8.conv``
and its two counters) on a synthetic trace of two predict calls: device time
a call under the conv spans, and the convs' share of their bound scaled by
the ranges whose kernels the trace holds. On a trace of a program without
these spans, or without the counters, each reads None."""

import pytest

from port_bench import counts, harness
from port_bench.trace import WINDOW_SPAN, Trace

NEW = ("conv_device_ms.serve", "conv_roofline.serve")


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    """Two calls of two ``odt.int8.conv`` ranges each; the first range's
    kernel (correlation 1) is missing from the trace."""
    events = [_ann(WINDOW_SPAN, 0, 1000)]
    for t0 in (10, 450):
        events += [_ann("odt.predict", t0, 390), _ann("odt.forward", t0 + 45, 335)]
        events += [_ann("odt.int8.conv", t0 + 50 + 10 * i, 10) for i in range(2)]
    events += [_launch(corr, ts) for corr, ts in ((1, 62), (2, 72), (3, 502), (4, 512))]
    events += [_kernel("conv3x3_requant_kernel<128>", corr, ts, dur)
               for corr, ts, dur in ((2, 100, 200), (3, 600, 100), (4, 700, 100))]
    return events


def _run(events):
    return harness.Run("ssd300_int8_batch64", 1, 1.0, True, "program", 0.0, {}, {}, {}, {},
                       trace=Trace(events), host={"batch": 64})


def _read(name, r):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(r)


def _count(monkeypatch, ops, moved):
    from object_detector_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"odt.int8.conv_ops": ops,
                                                        "odt.int8.conv_bytes": moved})


def test_conv_device_ms_is_the_kernels_under_the_spans_a_call(monkeypatch):
    _count(monkeypatch, 2.0e9, 1.0e6)
    assert _read("conv_device_ms.serve", _run(_events())) == pytest.approx(0.2)


@pytest.mark.parametrize("ops, moved", [(2.0e9, 1.0e6), (1.0, 4.0e9)],
                         ids=["ops_bound", "bytes_bound"])
def test_conv_roofline_is_the_larger_bound_over_the_held_kernels(monkeypatch, ops, moved):
    _count(monkeypatch, ops, moved)
    # Three of the four ranges hold their kernels, 400 µs in all.
    least_us = max(ops / counts.INT8_OPS_PER_S, moved / counts.HBM_BYTES_PER_S) * 1e6
    assert _read("conv_roofline.serve", _run(_events())) == pytest.approx(
        100 * least_us * 0.75 / 400)


def test_without_the_spans_or_counters_the_readers_read_none(monkeypatch):
    from object_detector_tpu_torch.utils import profiling

    _count(monkeypatch, 2.0e9, 1.0e6)
    harness_only = [e for e in _events() if not e["name"].startswith("odt.")]
    for name in NEW:
        assert _read(name, _run(harness_only)) is None, name
        assert _read(name, _run([_ann(WINDOW_SPAN, 0, 10)])) is None, name
    monkeypatch.delattr(profiling, "counters")
    assert _read("conv_roofline.serve", _run(_events())) is None
