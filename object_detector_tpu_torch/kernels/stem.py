"""VGG block 1's tail in int8: conv1_2 + dequant + bias + ReLU + requant +
2x2/s2 max pool, with the fused form as a hand-written CUDA kernel
(``csrc/stem.cu``).

The port of ``object_detector_tpu/kernels/stem_pallas.py``'s
``_stem_kernel`` (launched by ``conv12_pool_pair``). The TPU kernel reads an
odd-pair-packed, halo'd, batch-in-sublanes layout of the conv1_1 codes; that
layout exists for the TPU's (8, 128) tiles and is not ported. The port's
contract is the function itself, on NHWC codes:

    stem_conv12_pool(q1, w2, deq, bias, out_scale, packed=None)
      q1    (B, H, W, 64) int8 conv1_1 codes, H and W even
      w2    (3, 3, 64, 64) int8 HWIO conv1_2 kernel
      deq   (64,) float32, conv1_1's activation scale * conv1_2's weight scale
      bias  (64,) float32
      out_scale  conv1_2's activation scale (a float32 scalar)
      packed  `pack_weights(w2)`, where the caller keeps it
    -> (B, H/2, W/2, 64) int8: maxpool2x2(clip(round(relu(
           conv3x3_same(q1, w2).f32 * deq + bias) / out_scale), -127, 127))

The kernel runs conv1_2 on the int8 tensor cores, as the second half of
all of VGG block 1 (``kernels/stem_fp.py``) does: both include the stage
of ``csrc/conv12_pool.cuh``, and both read conv1_2's kernel as
`pack_weights` lays it out.
"""

from __future__ import annotations

from typing import Optional

import torch

from object_detector_tpu_torch.kernels import build, int8_pack
from object_detector_tpu_torch.kernels.requant_epilogue import epilogue_reference
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor

CHANNELS = 64


# The packed conv1_2 operand: one pass of 64 output channels, 18 k-steps.
PACKED_SHAPE = (1, 9 * CHANNELS // int8_pack.STEP_K, 4, 32, 16)


def stem_conv12_pool_reference(
    q1: Tensor, w2: Tensor, deq: Tensor, bias: Tensor, out_scale: float,
    packed: Optional[Tensor] = None,
) -> Tensor:
    """Plain PyTorch version: the reference's unfused chain (int8 conv,
    the requant epilogue's plain version, then the int8 max pool), on either
    device. ``packed`` is the wrapper's argument, unused here."""
    del packed
    acc = int8_ops.conv_int8(q1, w2, 1, "SAME", 1)
    q2 = epilogue_reference(acc, deq, bias, float(out_scale), relu=True).codes
    return int8_ops.max_pool(q2, 2, 2)


def pack_weights(w2: Tensor) -> Tensor:
    """conv1_2's (3, 3, 64, 64) kernel as the (576, 64) matrix of row 64 *
    tap + cin in the packed B layout of `int8_pack.pack_b_operand`: the
    operand of this kernel and the second of `stem_fp.pack_weights`."""
    return int8_pack.pack_b_operand(w2.reshape(9 * CHANNELS, CHANNELS))


def _check(q1: Tensor, w2: Tensor, deq: Tensor, bias: Tensor,
           packed: Optional[Tensor] = None) -> None:
    if q1.dim() != 4 or q1.shape[-1] != CHANNELS or q1.shape[1] % 2 or q1.shape[2] % 2:
        raise ValueError(f"q1 must be (B, H, W, {CHANNELS}) with H, W even, got {tuple(q1.shape)}")
    if tuple(w2.shape) != (3, 3, CHANNELS, CHANNELS):
        raise ValueError(f"w2 must be (3, 3, {CHANNELS}, {CHANNELS}), got {tuple(w2.shape)}")
    if tuple(deq.shape) != (CHANNELS,) or tuple(bias.shape) != (CHANNELS,):
        raise ValueError(f"deq and bias must be ({CHANNELS},), got {tuple(deq.shape)}, "
                         f"{tuple(bias.shape)}")
    if q1.dtype != torch.int8 or w2.dtype != torch.int8:
        raise TypeError(f"q1 and w2 must be int8, got {q1.dtype} and {w2.dtype}")
    if deq.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"deq and bias must be float32, got {deq.dtype} and {bias.dtype}")
    if packed is not None:
        if tuple(packed.shape) != PACKED_SHAPE or packed.dtype != torch.int8:
            raise ValueError(f"packed must be pack_weights(w2), int8 {PACKED_SHAPE}, got "
                             f"{packed.dtype} {tuple(packed.shape)}")
        if not packed.is_contiguous():
            raise ValueError("packed must be contiguous")
    for t in (w2, deq, bias) + (() if packed is None else (packed,)):
        if t.device != q1.device:
            raise ValueError(f"all operands must be on {q1.device}, got one on {t.device}")


@spanned("odt.kernel.stem")
def stem_conv12_pool(q1: Tensor, w2: Tensor, deq: Tensor, bias: Tensor, out_scale: float,
                     packed: Optional[Tensor] = None) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `stem_conv12_pool_reference` for CPU tensors. ``packed`` is
    ``pack_weights(w2)`` where the caller keeps it (it is made here
    otherwise). ``stem_conv12_pool.launches`` counts kernel launches."""
    _check(q1, w2, deq, bias, packed)
    if build.runs_plain("stem_conv12_pool", q1.device):
        return stem_conv12_pool_reference(q1, w2, deq, bias, out_scale)
    if not (q1.is_contiguous() and deq.is_contiguous() and bias.is_contiguous()) \
            or q1.data_ptr() % 16:
        raise ValueError("stem_conv12_pool takes contiguous, 16-byte aligned q1, deq and bias")
    if packed is None:
        packed = pack_weights(w2)
    b, h, w, _ = q1.shape
    out = torch.empty((b, h // 2, w // 2, CHANNELS), dtype=torch.int8, device=q1.device)
    if out.numel() == 0:
        return out
    build.launch("stem_conv12_pool", q1.device, q1.data_ptr(), packed.data_ptr(),
                 deq.data_ptr(), bias.data_ptr(), float(out_scale), b, h, w, out.data_ptr())
    stem_conv12_pool.launches += 1
    return out


stem_conv12_pool.launches = 0
