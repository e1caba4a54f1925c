"""Kernel names in a device trace: the program's hand-written kernels (the
``__global__`` functions of ``object_detector_tpu_torch/csrc``) and the
library GEMM and convolution kernels, by name fragments; every other kernel
is an eager PyTorch pass (elementwise, reductions, copies, layout)."""

from __future__ import annotations

from typing import Iterable, Tuple

HAND = {
    "nms": "nms_rows_",
    "stem_fp": "stem_fp_kernel",
    "stem": "stem_conv12_pool_kernel",
    "l2norm": "l2norm_requant_kernel",
    "pool_bwd": "pool_bwd_kernel",
    "resnet_stem": "resnet_stem_kernel",
    "bottleneck": "bottleneck_kernel",
}
LIBRARY = ("gemm", "cutlass", "xmma", "cublas", "cudnn", "conv", "implicit", "wgrad",
           "dgrad", "imma", "sm90_", "winograd")


def is_hand(name: str, kernel: str = "") -> bool:
    fragments = [HAND[kernel]] if kernel else HAND.values()
    return any(f in name for f in fragments)


def is_library(name: str) -> bool:
    low = name.lower()
    return not is_hand(name) and any(f in low for f in LIBRARY)


def time_of(kernels: Iterable[Tuple[str, float]], kernel: str) -> Tuple[int, float]:
    """(launches, device µs) of one hand kernel."""
    hits = [us for name, us in kernels if is_hand(name, kernel)]
    return len(hits), sum(hits)
