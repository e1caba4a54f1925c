"""Backward of the 2x2 / stride-2 max pool with first-max ties, as a
hand-written CUDA kernel (``csrc/pool_bwd.cu``).

The port of ``object_detector_tpu/ops/pooling.py``'s ``_pool_bwd_kernel``
(launched by ``_max_pool_bwd_pallas`` from the VJP of
``max_pool_2x2_fastgrad``):

    max_pool_bwd(x, y, g)
      x  (B, C, H, W) the pool's input, H and W even
      y  (B, C, H/2, W/2) = maxpool2x2(x)
      g  (B, C, H/2, W/2) the cotangent of y
    -> dx (B, C, H, W) of x's dtype: in each window g goes whole to the first
       position equal to y in the order (0,0), (0,1), (1,0), (1,1); the other
       three get 0. Compares are made after an exact upcast to float32.

Memory format. Tensors are NCHW in shape, as everywhere inside the port's
model, and channels-last in memory (channel fastest, the reference's NHWC):
that is how the activations lie on the card, because the model's input is a
permuted (B, H, W, 3) image and cuDNN's convs and the pools keep the format.
The kernel reads x and g and writes dx in that format. The wrapper raises on
an x that is not dense channels-last, so no launch hides a copy of x;
`ops.pooling.max_pool_2x2_fastgrad` lays x out once in its forward. g is made
channels-last here, explicitly, since autograd may hand it over in another
format; that copy, where it happens, is part of the call.

The kernel recomputes each window's maximum from x and does not read y.
"""

from __future__ import annotations

import torch

from object_detector_tpu_torch.kernels import build

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)


def max_pool_bwd_reference(x: Tensor, y: Tensor, g: Tensor) -> Tensor:
    """Plain PyTorch version: four equality planes with first-match
    exclusion. dx keeps x's memory format."""
    _check(x, y, g)
    yf = y.to(torch.float32)
    g = g.to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    taken = torch.zeros_like(yf, dtype=torch.bool)
    for dy, dw in ((0, 0), (0, 1), (1, 0), (1, 1)):
        equal = (x[:, :, dy::2, dw::2].to(torch.float32) == yf) & ~taken
        dx[:, :, dy::2, dw::2] = torch.where(equal, g, zero)
        taken = taken | equal
    return dx


def _check(x: Tensor, y: Tensor, g: Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_bwd needs even H, W; got {(h, w)}")
    pooled = (b, c, h // 2, w // 2)
    if tuple(y.shape) != pooled or tuple(g.shape) != pooled:
        raise ValueError(
            f"y and g must be {pooled}, got {tuple(y.shape)} and {tuple(g.shape)}"
        )
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x and y must both be float32 or bfloat16, got {x.dtype} and {y.dtype}")
    if y.device != x.device or g.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}, g on {g.device}")


def max_pool_bwd(x: Tensor, y: Tensor, g: Tensor) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `max_pool_bwd_reference` for CPU tensors. ``max_pool_bwd.launches``
    counts kernel launches."""
    _check(x, y, g)
    if build.runs_plain("max_pool_bwd", x.device):
        return max_pool_bwd_reference(x, y, g)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "max_pool_bwd takes x dense in channels-last memory format "
            f"(shape {tuple(x.shape)}, strides {x.stride()})"
        )
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    b, c, h, w = x.shape
    if x.numel() == 0:
        return dx
    build.launch("pool_bwd", x.device, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 b * (h // 2), w // 2, c, int(x.dtype == torch.bfloat16))
    max_pool_bwd.launches += 1
    return dx


max_pool_bwd.launches = 0
