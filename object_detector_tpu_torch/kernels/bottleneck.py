"""A stride-1 ResNet bottleneck in int8, fused: 1x1 -> 3x3 SAME -> 1x1 plus
the residual, each conv with its dequant, bias, ReLU and requant, as one
hand-written CUDA kernel (``csrc/bottleneck.cu``) that runs the three
products on the int8 tensor cores and keeps both intermediates out of device
memory.

The port of ``object_detector_tpu/kernels/bottleneck_pallas.py``'s
``_bottleneck_kernel`` (entry ``fused_bottleneck``). The TPU kernel walks row
bands with one-row halos and holds all three kernels in its fast memory; the
port's kernel walks 8 x 16 spatial tiles and streams the weights, packed
for ``mma.sync`` (`int8_pack.pack_b_operand`). The contract
is the function, on NHWC codes:

    fused_bottleneck(x, w1, deq1, bias1, w2, deq2, bias2, w3, deq3, bias3,
                     s1=, s2=, s3=, resid_scale=)
      x      (B, H, W, C) int8 codes at scale ``resid_scale``
      w1     (C, Cm) int8; w2 (3, 3, Cm, Cm) int8 HWIO; w3 (Cm, C) int8
      deq*, bias*  float32 per output channel of each conv
      s1, s2, s3   float32 scalars, the three activation scales
    -> (B, H, W, C) int8 codes at scale s3:
      mid1 = rq(relu(x . w1 * deq1 + bias1), s1)
      mid2 = rq(relu(conv3x3_same(mid1, w2) * deq2 + bias2), s2)
      out  = rq(relu(mid2 . w3 * deq3 + bias3 + x.f32 * resid_scale), s3)
      rq(y, s) = clip(round(y / s), -127, 127)               (a true divide)

The 3x3's SAME padding is zero codes of mid1 (not ``rq(relu(bias1))``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from object_detector_tpu_torch.kernels import build, int8_pack
from object_detector_tpu_torch.kernels.requant_epilogue import epilogue_reference
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor

# The kernel computes passes of 64 output channels and stages input channels
# in chunks of 64 or more, so both widths are multiples of 64 (all of
# ResNet-50's are); its shared memory holds both intermediates of an 8 x 16
# tile (308 rows of Cm + 16 bytes) beside the staging buffers, which bounds
# Cm at 576 within the 227 KB a block may use.
CHANNEL_MULTIPLE = 64
MAX_MID_CHANNELS = 576


def fused_bottleneck_reference(
    x: Tensor, w1: Tensor, deq1: Tensor, bias1: Tensor, w2: Tensor, deq2: Tensor, bias2: Tensor,
    w3: Tensor, deq3: Tensor, bias3: Tensor, *, s1: float, s2: float, s3: float,
    resid_scale: float, packed: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tensor:
    """Plain PyTorch version: the engine's unfused chain (three int8 convs,
    each with the requant epilogue's plain version; the residual joins the
    third), on either device. ``packed`` is the wrapper's argument, unused
    here."""
    del packed
    c, cm = w1.shape
    mid1 = epilogue_reference(int8_ops.conv_int8(x, w1.reshape(1, 1, c, cm)), deq1, bias1,
                              float(s1), relu=True).codes
    mid2 = epilogue_reference(int8_ops.conv_int8(mid1, w2), deq2, bias2, float(s2),
                              relu=True).codes
    return epilogue_reference(int8_ops.conv_int8(mid2, w3.reshape(1, 1, cm, c)), deq3, bias3,
                              float(s3), relu=True, resid=x,
                              resid_scale=float(resid_scale)).codes


def pack_weights(w1: Tensor, w2: Tensor, w3: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The three kernels as the CUDA kernel reads them: the (C, Cm), (9 Cm,
    Cm) (tap-major) and (Cm, C) matrices in the packed B layout of
    `int8_pack.pack_b_operand`, int8."""
    c, cm = w1.shape
    return (int8_pack.pack_b_operand(w1), int8_pack.pack_b_operand(w2.reshape(9 * cm, cm)),
            int8_pack.pack_b_operand(w3))


def _check(x, w1, deq1, bias1, w2, deq2, bias2, w3, deq3, bias3) -> None:
    if x.dim() != 4 or w1.dim() != 2:
        raise ValueError(f"x must be (B, H, W, C) and w1 (C, Cm), got {tuple(x.shape)} and "
                         f"{tuple(w1.shape)}")
    c, cm = w1.shape
    if x.shape[-1] != c or tuple(w2.shape) != (3, 3, cm, cm) or tuple(w3.shape) != (cm, c):
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
                         f"w3 {tuple(w3.shape)} are not a bottleneck's (B, H, W, C), (C, Cm), "
                         f"(3, 3, Cm, Cm), (Cm, C)")
    for name, t, n in (("deq1", deq1, cm), ("bias1", bias1, cm), ("deq2", deq2, cm),
                       ("bias2", bias2, cm), ("deq3", deq3, c), ("bias3", bias3, c)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("w3", w3)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
    for t in (w1, deq1, bias1, w2, deq2, bias2, w3, deq3, bias3):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got one on {t.device}")


@spanned("odt.kernel.bottleneck")
def fused_bottleneck(
    x: Tensor, w1: Tensor, deq1: Tensor, bias1: Tensor, w2: Tensor, deq2: Tensor, bias2: Tensor,
    w3: Tensor, deq3: Tensor, bias3: Tensor, *, s1: float, s2: float, s3: float,
    resid_scale: float, packed: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `fused_bottleneck_reference` for CPU tensors. ``packed`` is
    ``pack_weights(w1, w2, w3)`` where the caller keeps it (it is made here
    otherwise). ``fused_bottleneck.launches`` counts kernel launches."""
    _check(x, w1, deq1, bias1, w2, deq2, bias2, w3, deq3, bias3)
    if build.runs_plain("fused_bottleneck", x.device):
        return fused_bottleneck_reference(x, w1, deq1, bias1, w2, deq2, bias2, w3, deq3, bias3,
                                          s1=s1, s2=s2, s3=s3, resid_scale=resid_scale)
    c, cm = w1.shape
    if c % CHANNEL_MULTIPLE or cm % CHANNEL_MULTIPLE or cm > MAX_MID_CHANNELS:
        raise ValueError(f"the kernel takes C and Cm multiples of {CHANNEL_MULTIPLE} and Cm up to "
                         f"{MAX_MID_CHANNELS}, got C={c}, Cm={cm}")
    vectors = (deq1, bias1, deq2, bias2, deq3, bias3)
    if not x.is_contiguous() or not all(t.is_contiguous() for t in vectors) or x.data_ptr() % 16:
        raise ValueError("fused_bottleneck takes contiguous, 16-byte aligned x and contiguous "
                         "deq and bias vectors")
    if packed is None:
        packed = pack_weights(w1, w2, w3)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, h, w, _ = x.shape
    build.launch(
        "fused_bottleneck", x.device,
        x.data_ptr(), *(p.data_ptr() for p in packed), *(t.data_ptr() for t in vectors),
        float(s1), float(s2), float(s3), float(resid_scale), b, h, w, c, cm, out.data_ptr(),
    )
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
