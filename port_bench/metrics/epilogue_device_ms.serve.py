"""Device ms a batch of the kernels launched under the int8 engine's
``odt.int8.epilogue`` spans: every pass from a GEMM's int32 accumulator to
the next layer's codes or to the logits (dequant, bias, residual,
upsample-adds, requant, casts)."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.int8.epilogue")
