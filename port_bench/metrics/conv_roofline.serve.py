"""The int8 engine's one-kernel 3x3 convs, in % of their bound: the larger
of their operations (the program's ``odt.int8.conv_ops`` counter, 2 a
multiply-add) at the int8 tensor-core rate and their least bytes
(``odt.int8.conv_bytes``: the codes in, the kernel and the output each
moved once) at the HBM rate, over the device time of the kernels under
``odt.int8.conv``. Both totals are scaled by the share of conv ranges whose
kernels the trace holds. The larger of the two totals' times is never above
the sum of the steps' own bounds, so the share never reads above theirs.

The counters add up only while a profiler records; in a run the traced
window is the only such session that calls the program."""

from port_bench import counts
from port_bench.metrics._program import held_share

SPAN = "odt.int8.conv"
OPS = "odt.int8.conv_ops"
BYTES = "odt.int8.conv_bytes"


def read(r):
    from object_detector_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if r.trace is None or counters is None or not r.trace.span_count(SPAN):
        return None
    counted = counters()
    ops, moved = counted.get(OPS), counted.get(BYTES)
    us = sum(d for _, d in r.trace.kernels(SPAN))
    if not ops or not moved or us <= 0:
        return None
    least_s = max(ops / counts.INT8_OPS_PER_S, moved / counts.HBM_BYTES_PER_S)
    return 100.0 * least_s * held_share(r, SPAN) * 1e6 / us
