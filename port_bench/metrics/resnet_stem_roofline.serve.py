"""The ResNet stem kernel (B6, ``csrc/resnet_stem.cu``), in % of its bound."""

from port_bench import counts
from port_bench.metrics._device import roofline_pct


def read(r):
    s = r.arch["model"]["image_size"]
    return roofline_pct(r, "resnet_stem", counts.resnet_stem_bound_ms(r.host["batch"], s, s)[0])
