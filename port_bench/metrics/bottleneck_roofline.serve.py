"""The bottleneck kernel (B7, ``csrc/bottleneck.cu``, 12 launches a
forward): the bound of the forwards its launches make up over its device
time, in %."""

from port_bench import counts, kernels

LAUNCHES_A_FORWARD = sum(n for *_, n in counts.RESNET_BLOCKS)


def read(r):
    if r.trace is None:
        return None
    launches, us = kernels.time_of(r.trace.kernels(), "bottleneck")
    if not launches or us <= 0:
        return None
    bound = counts.bottleneck_forward_bound_ms(r.host["batch"], r.arch["model"]["image_size"])
    return 100.0 * launches / LAUNCHES_A_FORWARD * bound * 1e3 / us
