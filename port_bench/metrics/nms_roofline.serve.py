"""The NMS scan (B1, ``csrc/nms.cu``): least time of the rows the traced
calls really got (their emit steps counted from the scan's outputs) over its
device time, in % of the H100 SXM peaks. The bound is the calls' mean a
launch, times the launches the trace holds (a trace can miss the first
kernel records of its window)."""

from port_bench import counts, kernels


def read(r):
    calls = r.host.get("nms_calls")
    if r.trace is None or not calls:
        return None
    launches, us = kernels.time_of(r.trace.kernels(), "nms")
    if not launches or us <= 0:
        return None
    bound = sum(counts.nms_bound_ms(*call)[0] for call in calls) / len(calls)
    return 100.0 * launches * bound * 1e3 / us
