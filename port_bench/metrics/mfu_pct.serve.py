"""The whole int8 forward's share of the int8 tensor-core peak: conv
operations of the images served over the seconds, in %."""

from port_bench import counts
from port_bench.metrics._device import mfu_pct


def read(r):
    return mfu_pct(r, "images_untraced", counts.INT8_OPS_PER_S)
