"""Device ms a predict call of the sampling core of multi-scale deformable
attention: the kernels launched under ``odt.deformable.sampling``
(``object_detector_tpu_torch/kernels/msda.py``, 12 launches a forward)."""

from port_bench.deformable_counts import SAMPLING
from port_bench.metrics._program import step_ms


def read(r):
    return step_ms(r, SAMPLING)
