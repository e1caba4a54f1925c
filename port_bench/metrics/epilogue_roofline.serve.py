"""The int8 engine's epilogues, in % of their bound: the least bytes the
traced calls' epilogues must move (the program's ``odt.int8.epilogue_bytes``
counter: each accumulator, addend and output moved once) at the HBM rate,
over the device time of the kernels under ``odt.int8.epilogue``. The bytes
are scaled by the share of epilogue ranges whose kernels the trace holds.

The counter adds up only while a profiler records; in a run the traced
window is the only such session that calls the program."""

from port_bench import counts
from port_bench.metrics._program import held_share

SPAN = "odt.int8.epilogue"
BYTES = "odt.int8.epilogue_bytes"


def read(r):
    from object_detector_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if r.trace is None or counters is None or not r.trace.span_count(SPAN):
        return None
    moved = counters().get(BYTES)
    us = sum(d for _, d in r.trace.kernels(SPAN))
    if not moved or us <= 0:
        return None
    least_us = moved * held_share(r, SPAN) / counts.HBM_BYTES_PER_S * 1e6
    return 100.0 * least_us / us
