"""Device ms a batch of the kernels launched under the int8 engine's
``odt.int8.im2col`` spans: the SAME pads, the window copies and the row and
width pads before each int8 GEMM."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.int8.im2col")
