"""Frozen work counts: the peaks of the card, each hand kernel's least time
from its shapes, and the model's operations.

The kernels' bound arithmetic is a copy of ``chip_smoke.py``'s (``bound``,
``nms_bound_ms``, ``stem_fp_bound_ms``, ``l2norm_bound_ms``,
``resnet_stem_bound_ms``, ``bottleneck_bound_ms``, ``pool_bwd_bound_ms``),
frozen here so that a change to the program cannot move the yardstick. Each
input byte is counted as read once and each output byte as written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM (data sheet, dense, at 700 W): HBM bytes/s, int8
# tensor-core operations/s, bf16 tensor-core FLOP/s, and float32 operations/s
# outside the tensor cores. The sheet's 67 TFLOP/s counts an FMA as two
# operations; the NMS scan and the L2Norm build with -fmad=false, so each of
# their operations is one instruction at half that rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12 / 2

# float32 operations per column per emit step of the NMS scan: 2 argmax
# compares, 4 for iw, 3 for ih, 1 multiply, 1 add, 1 suppress compare.
NMS_OPS_PER_COLUMN_STEP = 2 + 4 + 3 + 1 + 1 + 1
# Per column once per row: 2 subtracts, 2 clamps, the area and its scaling.
NMS_OPS_PER_COLUMN_HOISTED = 6
# Per element of the L2Norm: square and add, two products, divide, round,
# two clamps.
L2NORM_OPS_PER_ELEMENT = 2 + 2 + 1 + 1 + 2
# Per channel of a pool window in the pool backward: 3 compares for the
# maximum of four and 4 equalities.
POOL_BWD_OPS_PER_WINDOW = 3 + 4
# (C, Cm, H = W at 512 px, blocks) of the bottleneck kernel's launches: the
# second and later blocks of ResNet-50's four stages.
RESNET_BLOCKS = ((256, 64, 128, 2), (512, 128, 64, 3), (1024, 256, 32, 5), (2048, 512, 16, 2))
# The four VGG pools of an SSD-300 training step, (H, W, C); pool3's 75 x 75
# is padded to 76 x 76.
POOL_SHAPES = ((300, 300, 64), (150, 150, 128), (76, 76, 256), (38, 38, 512))


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") for work of these sizes."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_bound_ms(steps: int, rows: int, k: int, max_out: int, coord_bytes: int = 4):
    """The NMS scan on rows that ran ``steps`` emit steps in all (each row its
    valid emits plus the one that finds nothing, at most max_out): four
    coordinate planes and the scores read once, two outputs written once,
    against the float32 operations over the float32 rate."""
    bytes_moved = 4 * rows * k * coord_bytes + rows * k * 4 + rows * max_out * 8
    ops = NMS_OPS_PER_COLUMN_STEP * k * steps + NMS_OPS_PER_COLUMN_HOISTED * rows * k
    return bound(bytes_moved, ops, F32_OPS_PER_S)


def stem_fp_bound_ms(b: int, h: int, w: int):
    """VGG block 1 in one kernel (B4) on (b, h, w, 3) codes: both convs'
    multiply-adds (27 and 576 a pixel and channel) as 2 int8 operations,
    against the input codes, the two kernels, four vectors and the pooled
    (b, h/2, w/2, 64) codes."""
    ops = 2 * b * h * w * 64 * (27 + 576)
    out = b * (h // 2) * (w // 2) * 64
    bytes_moved = b * h * w * 3 + (27 + 576) * 64 + 4 * 4 * 64 + out
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def l2norm_bound_ms(b: int, h: int, w: int, c: int):
    """The L2Norm kernel (B3): the (b, h, w, c) tap read and written once,
    and gamma, against its float32 operations."""
    n = b * h * w * c
    return bound(2 * n + 4 * c, L2NORM_OPS_PER_ELEMENT * n, F32_OPS_PER_S)


def resnet_stem_bound_ms(b: int, h: int, w: int):
    """The ResNet stem kernel (B6): the float32 (b, h, w, 3) image read once
    and the pooled (b, h/4, w/4, 64) codes written once, against the 7x7/s2
    conv's multiply-adds as 2 int8 operations."""
    ops = 2 * b * (h // 2) * (w // 2) * 64 * 147
    out = b * (h // 4) * (w // 4) * 64
    bytes_moved = b * h * w * 3 * 4 + out + 147 * 64 + 2 * 4 * 64
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def bottleneck_bound_ms(pixels: int, c: int, cm: int):
    """One bottleneck kernel launch (B7): x read and the output written once
    (and three kernels, six vectors), against three convs' multiply-adds as
    2 int8 operations."""
    ops = 2 * pixels * (2 * c * cm + 9 * cm * cm)
    bytes_moved = 2 * pixels * c + 2 * c * cm + 9 * cm * cm + 4 * (4 * cm + 2 * c)
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def bottleneck_forward_bound_ms(b: int, image_size: int,
                                blocks: Sequence[tuple] = RESNET_BLOCKS) -> float:
    """The twelve bottleneck launches of one forward, summed; the spatial
    sizes scale with the image (``RESNET_BLOCKS`` is at 512 px)."""
    total = 0.0
    for c, cm, hw, n in blocks:
        side = hw * image_size // 512
        total += n * bottleneck_bound_ms(b * side * side, c, cm)[0]
    return total


def pool_bwd_bound_ms(b: int, h: int, w: int, c: int, element_size: int = 2):
    """The pool backward (B5) on one (b, c, h, w) input: x and g read once,
    dx written once, against the compares over the float32 rate."""
    x = b * h * w * c
    windows = x // 4
    return bound((2 * x + windows) * element_size, POOL_BWD_OPS_PER_WINDOW * windows,
                 F32_OPS_PER_S)


def pool_bwd_step_bound_ms(b: int, element_size: int = 2) -> float:
    """The four pools of an SSD-300 step at batch b."""
    return sum(pool_bwd_bound_ms(b, h, w, c, element_size)[0] for h, w, c in POOL_SHAPES)
