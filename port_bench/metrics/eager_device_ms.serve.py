"""Device ms a batch, under the forward, of the kernels that are neither the
program's hand kernels nor library GEMM or convolution kernels: the int8
engine's eager requant epilogues, im2col copies, pools and casts."""

from port_bench import kernels
from port_bench.metrics._device import span_ms


def read(r):
    return span_ms(r, "forward", lambda n: not kernels.is_hand(n) and not kernels.is_library(n))
