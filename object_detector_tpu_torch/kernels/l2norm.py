"""Int8 L2Norm + learned scale + requant for the int8 SSD heads, with the
fused form as a hand-written CUDA kernel (``csrc/l2norm.cu``).

The port of ``object_detector_tpu/kernels/l2norm_pallas.py``'s
``_l2norm_kernel`` (launched by ``l2norm_requant``). L2Norm is
scale-invariant in its input, so it runs on the tap's int8 codes directly:

    l2norm_requant(q0, gamma, out_scale)
      q0     (B, H, W, C) int8 codes (the conv4_3 tap, C = 512)
      gamma  (C,) float32 learned scale
      out_scale  the calibrated "__l2norm__" activation scale
    -> (B, H, W, C) int8:
       clip(round(q0 * (1 / sqrt(sum_c q0^2 + 1e-12)) * gamma / out_scale), +-127)

This is the reference's serving default, the unfolded jnp form of
``quant/engine.py:1242-1248``; the TPU kernel folds gamma / out_scale and is
held to it within one code on < 1e-3 of the elements.
"""

from __future__ import annotations

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor

# The kernel's lanes hold up to 4 chunks of 16 channels per 32 lanes; the
# sum of squares stays exact in float32 while C * 127^2 < 2^24.
MAX_CHANNELS = 2048


def l2norm_requant_reference(q0: Tensor, gamma: Tensor, out_scale: float) -> Tensor:
    """Plain PyTorch version, operation for operation the kernel's."""
    qf = q0.to(torch.float32)
    ss = (qf * qf).sum(dim=-1, keepdim=True)  # integers < 2^24: exact
    inv = torch.reciprocal(torch.sqrt(ss + 1e-12))
    y = (qf * inv).mul_(gamma)
    return int8_ops.quantize(y, int8_ops.scale_tensor(float(out_scale), q0.device))


def _check(q0: Tensor, gamma: Tensor) -> None:
    if q0.dim() != 4:
        raise ValueError(f"q0 must be (B, H, W, C), got {tuple(q0.shape)}")
    c = q0.shape[-1]
    if tuple(gamma.shape) != (c,):
        raise ValueError(f"gamma must be ({c},), got {tuple(gamma.shape)}")
    if q0.dtype != torch.int8 or gamma.dtype != torch.float32:
        raise TypeError(f"q0 must be int8 and gamma float32, got {q0.dtype} and {gamma.dtype}")
    if gamma.device != q0.device:
        raise ValueError(f"q0 on {q0.device}, gamma on {gamma.device}")


@spanned("odt.kernel.l2norm")
def l2norm_requant(q0: Tensor, gamma: Tensor, out_scale: float) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `l2norm_requant_reference` for CPU tensors. ``l2norm_requant.launches``
    counts kernel launches."""
    _check(q0, gamma)
    if build.runs_plain("l2norm_requant", q0.device):
        return l2norm_requant_reference(q0, gamma, out_scale)
    c = q0.shape[-1]
    if c % 16 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 16 up to {MAX_CHANNELS}, got {c}")
    if not (q0.is_contiguous() and gamma.is_contiguous()) or q0.data_ptr() % 16:
        raise ValueError("l2norm_requant takes contiguous, 16-byte aligned q0 and gamma")
    out = torch.empty_like(q0)
    pixels = q0.numel() // c
    if pixels == 0:
        return out
    build.launch("l2norm_requant", q0.device, q0.data_ptr(), gamma.data_ptr(),
                 float(out_scale), pixels, c, out.data_ptr())
    l2norm_requant.launches += 1
    return out


l2norm_requant.launches = 0
