"""Device ms a batch under ``postprocess`` (decode, prefilter, the NMS scan,
the merge)."""

from port_bench.metrics._device import span_ms


def read(r):
    return span_ms(r, "postprocess")
