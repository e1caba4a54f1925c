"""The ResNet stem in int8, fused: input quantize + 7x7/s2 pad-3 conv (3 ->
64, BatchNorm folded) + bias + ReLU + requant + 3x3/s2 pad-1 max pool, as a
hand-written CUDA kernel (``csrc/resnet_stem.cu``) whose conv runs on the
int8 tensor cores.

The port of ``object_detector_tpu/kernels/resnet_stem_pallas.py``'s
``_stem_kernel`` (entry ``resnet_stem_int8``). The TPU kernel reads a staged
(16, W/4) layout of the quantized image, three lane-rolled copies of it and
weights packed into (3, 128, 128) matrices; those serve the TPU's tiles and
matrix unit and are not ported. The port's kernel reads the float image
itself, so the quantized image never reaches device memory. The contract is
the function, on NHWC tensors:

    resnet_stem(images, w_q, deq, bias, in_scale, out_scale)
      images  (B, H, W, 3) float32 normalized images, H and W multiples of 4
      w_q     (7, 7, 3, 64) int8 HWIO kernel (BatchNorm folded before quantizing)
      deq     (64,) float32, in_scale * the kernel's per-channel weight scale
      bias    (64,) float32 (the folded BatchNorm's)
      in_scale, out_scale  float32 scalars: the input's and the stem's
                           activation scales
    -> (B, H/4, W/4, 64) int8:
      x   = clip(round(images / in_scale), -127, 127)            (a true divide)
      y   = relu(conv7x7_s2_pad3(x, w_q).f32 * deq + bias)
      q   = clip(round(y * (f32(1) / f32(out_scale))), -127, 127)
      out = maxpool3x3_s2_pad1(q)                                (pads with -128)

The requant multiplies by the float32 reciprocal of ``out_scale``, as the TPU
kernel does, where every other requant of the engine divides: against the
unfused chain one code in about a million may differ by one.

The kernel runs the conv in space-to-depth form (`s2d_matrix`): a 4x4/s1
conv over the 12 channels of the image's 2x2 phases with the kernel
zero-padded to 8x8, K = 192, the same integer sums as the 7x7/s2 conv.
"""

from __future__ import annotations

from typing import Optional

import torch

from object_detector_tpu_torch.kernels import build, int8_pack
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor

CHANNELS = 64
KERNEL = 7
# Rows of the space-to-depth matrix: 4 x 4 taps of the 12 phase channels.
K_S2D = 192
# Column n = 8 nt + 2 t + i of the packed matrix holds output channel
# 16 t + 2 nt + i, so that a thread's accumulators (n-tiles nt < 8, columns
# 2 t and 2 t + 1) are 16 consecutive channels.
COLUMN_CHANNELS = tuple(16 * ((n % 8) // 2) + 2 * (n // 8) + n % 2 for n in range(CHANNELS))


def resnet_stem_reference(
    images: Tensor, w_q: Tensor, deq: Tensor, bias: Tensor, in_scale: float, out_scale: float,
    packed: Optional[Tensor] = None,
) -> Tensor:
    """Plain PyTorch version, operation for operation the kernel's, on
    either device. ``packed`` is the wrapper's argument, unused here."""
    del packed
    dev = images.device
    x = int8_ops.quantize(images.to(torch.float32, copy=True), int8_ops.scale_tensor(in_scale, dev))
    acc = int8_ops.conv_int8(x, w_q, stride=2, padding=3)
    y = torch.mul(acc, deq).add_(bias).clamp_min_(0.0)
    inv = torch.reciprocal(int8_ops.scale_tensor(out_scale, dev))  # float32(1) / float32(s)
    q = y.mul_(inv).round_().clamp_(-127.0, 127.0).to(torch.int8)
    return int8_ops.max_pool(q, 3, 2, explicit_pad=1)


def s2d_matrix(w_q: Tensor) -> Tensor:
    """(7, 7, 3, 64) HWIO int8 -> the (192, 64) space-to-depth matrix: row
    48 dy + 12 dx + 6 py + 3 px + c holds kernel tap (2 dy + py, 2 dx + px)
    of input channel c, zero where a tap index is 7. Against phase pixel
    (Y, X)'s 12 bytes, input (2 Y + py - 3, 2 X + px - 3, c), the 4 x 4 taps
    from conv pixel (oy, ox) give the 7x7/s2 pad-3 conv's sum."""
    w8 = torch.nn.functional.pad(w_q, (0, 0, 0, 0, 0, 1, 0, 1))  # (8, 8, 3, 64)
    w8 = w8.reshape(4, 2, 4, 2, 3, CHANNELS)  # [dy][py][dx][px][c][n]
    return w8.permute(0, 2, 1, 3, 4, 5).reshape(K_S2D, CHANNELS)


def pack_weights(w_q: Tensor) -> Tensor:
    """(7, 7, 3, 64) HWIO int8 -> the kernel's B operand: `s2d_matrix` with
    its columns in `COLUMN_CHANNELS` order, in the packed layout of
    `int8_pack.pack_b_operand`, (1, 6, 4, 32, 16) int8."""
    order = torch.tensor(COLUMN_CHANNELS, device=w_q.device)
    return int8_pack.pack_b_operand(s2d_matrix(w_q).index_select(1, order))


def _check(images: Tensor, w_q: Tensor, deq: Tensor, bias: Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != 3 or images.shape[1] % 4 or images.shape[2] % 4:
        raise ValueError(
            f"images must be (B, H, W, 3) with H, W multiples of 4, got {tuple(images.shape)}")
    if tuple(w_q.shape) != (KERNEL, KERNEL, 3, CHANNELS):
        raise ValueError(f"w_q must be (7, 7, 3, {CHANNELS}), got {tuple(w_q.shape)}")
    if tuple(deq.shape) != (CHANNELS,) or tuple(bias.shape) != (CHANNELS,):
        raise ValueError(f"deq and bias must be ({CHANNELS},), got {tuple(deq.shape)}, "
                         f"{tuple(bias.shape)}")
    if images.dtype != torch.float32 or deq.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"images, deq and bias must be float32, got {images.dtype}, {deq.dtype}, "
                        f"{bias.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    for t in (w_q, deq, bias):
        if t.device != images.device:
            raise ValueError(f"all operands must be on {images.device}, got one on {t.device}")


@spanned("odt.kernel.resnet_stem")
def resnet_stem(
    images: Tensor, w_q: Tensor, deq: Tensor, bias: Tensor, in_scale: float, out_scale: float,
    packed: Optional[Tensor] = None,
) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `resnet_stem_reference` for CPU tensors. ``packed`` is
    ``pack_weights(w_q)`` where the caller keeps it (it is made here
    otherwise). ``resnet_stem.launches`` counts kernel launches."""
    _check(images, w_q, deq, bias)
    if build.runs_plain("resnet_stem", images.device):
        return resnet_stem_reference(images, w_q, deq, bias, in_scale, out_scale)
    if not (images.is_contiguous() and deq.is_contiguous() and bias.is_contiguous()):
        raise ValueError("resnet_stem takes contiguous images, deq and bias")
    if images.data_ptr() % 16:
        raise ValueError("resnet_stem copies the images 16 bytes at a time: they must start "
                         "on a 16-byte boundary")
    if packed is None:
        packed = pack_weights(w_q)
    b, h, w, _ = images.shape
    out = torch.empty((b, h // 4, w // 4, CHANNELS), dtype=torch.int8, device=images.device)
    if out.numel() == 0:
        return out
    build.launch(
        "resnet_stem", images.device,
        images.data_ptr(), packed.data_ptr(), deq.data_ptr(), bias.data_ptr(),
        float(in_scale), float(out_scale), b, h, w, out.data_ptr(),
    )
    resnet_stem.launches += 1
    return out


resnet_stem.launches = 0


def smem_bytes() -> int:
    """The dynamic shared memory a block of the kernel takes (builds it)."""
    return int(build.entry("resnet_stem_smem_bytes")())
