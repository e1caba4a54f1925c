"""Shared arithmetic of the readers of the program's own spans (``odt.*``,
``object_detector_tpu_torch/utils/profiling.py``): device time a call under
one of the int8 engine's steps, and the share of that step's ranges whose
kernels the trace holds. A program without these spans gives None."""

from __future__ import annotations

from port_bench.metrics._device import span_ms
from port_bench.trace import DEVICE_CATS

PREDICT = "odt.predict"


def step_ms(r, step: str):
    """Device ms a predict call of the kernels launched under ``step``."""
    ms = span_ms(r, step)
    calls = r.trace.span_count(PREDICT) if r.trace is not None else 0
    if ms is None or not calls:
        return None
    return ms * r.trace.span_count(step) / calls


def held_share(r, step: str) -> float:
    """The share of ``step``'s ranges that launched a kernel the trace holds
    (a trace can miss the first kernel records of its window)."""
    t = r.trace
    held = {t._span_of(step, corr, ts) for ts, _, name, corr in t.device
            if name not in DEVICE_CATS}
    held.discard(None)
    return len(held) / t.span_count(step)
