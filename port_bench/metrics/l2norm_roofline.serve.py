"""The L2Norm kernel (B3, ``csrc/l2norm.cu``) on the conv4_3 tap, in % of its
bound."""

from port_bench import counts
from port_bench.metrics._device import roofline_pct


def read(r):
    f = r.arch["anchors"]["feature_sizes"][0]
    return roofline_pct(r, "l2norm", counts.l2norm_bound_ms(r.host["batch"], f, f, 512)[0])
