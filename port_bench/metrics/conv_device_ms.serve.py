"""Device ms a batch of the kernels launched under the int8 engine's
``odt.int8.conv`` spans: its 3x3 stride-1 convs, each with its requant
epilogue in one kernel."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.int8.conv")
