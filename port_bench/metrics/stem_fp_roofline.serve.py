"""VGG block 1 in one kernel (B4, ``csrc/stem_fp.cu``), in % of its bound."""

from port_bench import counts
from port_bench.metrics._device import roofline_pct


def read(r):
    s = r.arch["model"]["image_size"]
    return roofline_pct(r, "stem_fp", counts.stem_fp_bound_ms(r.host["batch"], s, s)[0])
