"""2x2 / stride-2 max pool whose backward is the port's own kernel.

The port of ``object_detector_tpu/ops/pooling.py``'s
``max_pool_2x2_fastgrad``: the forward is the library's max pool (the
reference's forward is XLA's ``reduce_window``, outside its Pallas kernel);
the backward is `kernels.pool_bwd.max_pool_bwd`, which on the card launches
``csrc/pool_bwd.cu``. The gradient sends each window's cotangent whole to
the first maximum in the order (0,0), (0,1), (1,0), (1,1).

Tensors are (B, C, H, W). The forward lays x out channels-last (a no-op for
the model's activations, which already are), so the saved x is what the
kernel reads and the pooled output has the same format.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_detector_tpu_torch.kernels.pool_bwd import max_pool_bwd

Tensor = torch.Tensor


class _MaxPool2x2FastGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        x, y = ctx.saved_tensors
        return max_pool_bwd(x, y, g)


def max_pool_2x2_fastgrad(x: Tensor) -> Tensor:
    """2x2/s2 VALID max pool of (B, C, H, W), even H and W. Forward equal to
    ``F.max_pool2d(x, 2, 2)``; backward by the first-max kernel."""
    if x.dim() != 4:
        raise ValueError(f"max_pool_2x2_fastgrad needs (B, C, H, W), got {tuple(x.shape)}")
    h, w = x.shape[2], x.shape[3]
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_2x2_fastgrad needs even H, W; got {(h, w)}")
    return _MaxPool2x2FastGrad.apply(x)
