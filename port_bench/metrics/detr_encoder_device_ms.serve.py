"""Device ms a predict call of the kernels launched under DETR's
``odt.detr.encoder`` span (``object_detector_tpu_torch/models/detr.py``,
``quant/engine.py`` `detr_int8_forward`)."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.detr.encoder")
