"""The reader of the entry layer's staged upload (``upload_gbps.serve``) on a
synthetic trace of two predict calls: the staged bytes over the device time
of the copies launched under ``odt.upload``, a copy outside the spans left
out, the bytes scaled by the share of chunks whose copy the trace holds; on
a trace without the spans, or a program without the counters, None."""

import pytest

from port_bench import harness
from port_bench.trace import WINDOW_SPAN, Trace

NAME = "upload_gbps.serve"


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _copy(corr, ts, dur):
    return {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _events(first_copy=True):
    """Two calls, each with an ``odt.upload`` range that launches two
    copies of 100 µs and a readback copy of 300 µs after it."""
    events = [_ann(WINDOW_SPAN, 0, 2000)]
    copies = []
    for call, t0 in enumerate((10, 1010)):
        events += [_ann("odt.predict", t0, 900), _ann("odt.upload", t0 + 5, 30)]
        corr = 10 * call
        events += [_launch(corr + 1, t0 + 10), _launch(corr + 2, t0 + 20),
                   _launch(corr + 3, t0 + 600)]
        copies += [_copy(corr + 1, t0 + 15, 100), _copy(corr + 2, t0 + 120, 100),
                   _copy(corr + 3, t0 + 610, 300)]
    return events + (copies if first_copy else copies[1:])


def _run(events):
    return harness.Run("retinanet_int8_batch64", 1, 1.0, True, "program", 0.0, {}, {}, {}, {},
                       trace=Trace(events), host={"batch": 64})


def _read(r):
    return harness.load_module(harness.BENCH / "metrics" / f"{NAME}.py").read(r)


def _count(monkeypatch, staged, chunks):
    from object_detector_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"odt.upload.staged_bytes": staged,
                                                        "odt.upload.chunks": chunks})


def test_the_rate_is_the_staged_bytes_over_the_copies_under_the_spans(monkeypatch):
    _count(monkeypatch, 8_000_000, 4)
    # 8 MB over the four 100 µs copies under the spans; the readbacks are out.
    assert _read(_run(_events())) == pytest.approx(20.0)


def test_the_bytes_are_scaled_by_the_chunks_the_trace_holds(monkeypatch):
    _count(monkeypatch, 8_000_000, 4)
    # Three of the four chunks' copies are held: 6 MB over 300 µs.
    assert _read(_run(_events(first_copy=False))) == pytest.approx(20.0)


def test_without_the_spans_or_the_counters_the_reader_reads_none(monkeypatch):
    from object_detector_tpu_torch.utils import profiling

    _count(monkeypatch, 8_000_000, 4)
    assert _read(_run([e for e in _events() if e["name"] != "odt.upload"])) is None
    assert _read(_run([_ann(WINDOW_SPAN, 0, 10)])) is None
    _count(monkeypatch, 0, 0)
    assert _read(_run(_events())) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read(_run(_events())) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read(_run(_events())) is None
