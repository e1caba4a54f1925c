"""Device ms a batch of the kernels launched under the int8 engine's
``odt.int8.gemm`` spans: ``torch._int_mm`` and the slice of its result."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.int8.gemm")
