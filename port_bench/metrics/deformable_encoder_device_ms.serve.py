"""Device ms a predict call of the kernels launched under Deformable DETR's
``odt.deformable.encoder`` span
(``object_detector_tpu_torch/models/deformable_detr.py``, ``quant/engine.py``
`deformable_detr_int8_forward`)."""

from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, "odt.deformable.encoder")
