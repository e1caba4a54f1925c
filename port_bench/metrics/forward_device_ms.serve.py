"""Device ms a batch of the kernels launched under the model's forward (the
int8 engine's ``int8_forward`` / ``retinanet_int8_forward``)."""

from port_bench.metrics._device import span_ms


def read(r):
    return span_ms(r, "forward")
