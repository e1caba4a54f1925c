"""VGG16 backbone with SSD modifications, as ``nn.Module``s (NCHW inside).

The port of ``object_detector_tpu/models/vgg.py``: VGG16 through conv5_3,
pool5 as 3x3/stride-1, fc6/fc7 as a dilated 3x3x1024 and a 1x1x1024 conv.
Taps: conv4_3 and fc7. Module and parameter names follow the flax param
tree (``backbone/conv1_1/kernel`` is ``backbone.conv1_1.weight``), so
`object_detector_tpu_torch.convert.params_from_jax` maps one onto the other.

Parameters stay float32; every conv casts them to the activation's dtype
(the model's compute dtype), as flax's ``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from object_detector_tpu_torch.ops.pooling import max_pool_2x2_fastgrad

Tensor = torch.Tensor


def same_pads(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (before, after) for one spatial axis. With
    stride 2 it can be asymmetric: 10 -> 5 pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with flax-style "SAME" / "VALID" padding, or an int
    for explicit symmetric padding."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int,
        stride: int = 1, padding: str | int = "SAME", dilation: int = 1, bias: bool = True,
    ):
        super().__init__()
        if padding not in ("SAME", "VALID") and not isinstance(padding, int):
            raise ValueError(f"padding must be SAME, VALID or an int, got {padding!r}")
        # Weights are set by convert.init_params or load_state_dict.
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        # ``bias=False``: a conv that feeds a BatchNorm (flax's use_bias=False).
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dilation = dilation

    def forward(self, x: Tensor) -> Tensor:
        k = self.weight.shape[-1]
        pad = (0, 0)
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], k, self.stride, self.dilation)
            pw = same_pads(x.shape[3], k, self.stride, self.dilation)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        elif isinstance(self.padding, int):  # explicit, symmetric
            pad = (self.padding, self.padding)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(
            x, self.weight.to(x.dtype), bias,
            stride=self.stride, padding=pad, dilation=self.dilation,
        )


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned per-channel scale."""

    def __init__(self, channels: int, init_scale: float = 20.0, epsilon: float = 1e-12):
        super().__init__()
        self.init_scale = float(init_scale)
        self.scale = nn.Parameter(torch.full((channels,), self.init_scale))
        self.epsilon = epsilon

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        # Square in the compute dtype, sum over channels in float32.
        sq = torch.sum(x * x, dim=1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(sq + self.epsilon).to(x.dtype)
        return x * inv * self.scale.to(x.dtype)[None, :, None, None]


# (name, in, out) per conv; "pool" marks a 2x2/s2 max pool. The first three
# entries are block 1 (`VGG16Backbone._block1`).
_VGG_LAYERS: Sequence = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), "pool",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), "pool",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
)


class VGG16Backbone(nn.Module):
    """VGG16 (SSD-modified). Returns [conv4_3, fc7] feature maps, NCHW.

    With ``pool_grad_kernel`` the four 2x2/s2 pools go through
    `ops.pooling.max_pool_2x2_fastgrad`, whose backward is the port's
    first-max pool kernel; the forward, and so serving, is the same either
    way. With ``remat_block1`` block 1 (conv1_1, conv1_2, pool1), whose
    activations are a training step's largest, runs under
    `torch.utils.checkpoint`: its activations are not kept for the backward
    but recomputed there (reference ``nn.remat``, ``models/vgg.py:141``).
    ``pack_block1`` is the reference's TPU lane layout; the math is the same
    without it, so it is accepted and ignored.
    """

    def __init__(
        self, pack_block1: bool = False, pool_grad_kernel: bool = False,
        remat_block1: bool = False,
    ):
        super().__init__()
        del pack_block1
        self.pool_grad_kernel = pool_grad_kernel
        self.remat_block1 = remat_block1
        for layer in _VGG_LAYERS:
            if layer != "pool":
                name, cin, cout = layer
                self.add_module(name, Conv(cin, cout, 3))
        self.fc6 = Conv(512, 1024, 3, dilation=6)
        self.fc7 = Conv(1024, 1024, 1)

    def _pool(self, x: Tensor, ceil_mode: bool) -> Tensor:
        if not self.pool_grad_kernel:
            return F.max_pool2d(x, 2, 2, ceil_mode=ceil_mode)
        # The kernel takes even sizes: for ceil mode pad to even with the
        # dtype's minimum, as the reference does. The pad never ties with a
        # post-ReLU value and its gradient is sliced away.
        ph, pw = x.shape[2] % 2, x.shape[3] % 2
        if ceil_mode and (ph or pw):
            x = F.pad(x, (0, pw, 0, ph), value=torch.finfo(x.dtype).min)
        return max_pool_2x2_fastgrad(x)

    def _block1(self, x: Tensor, *params: Tensor) -> Tensor:
        """conv1_1, conv1_2 and pool1 on the convs' (weight, bias, weight,
        bias) ``params``. They are handed in, not read from the modules: a
        recompute under checkpoint runs in the backward, after a
        `torch.func.functional_call` that lent the forward its parameters
        has put the module's own back."""
        for i, name in enumerate(("conv1_1", "conv1_2")):
            conv_params = {"weight": params[2 * i], "bias": params[2 * i + 1]}
            x = F.relu(torch.func.functional_call(getattr(self, name), conv_params, (x,)))
        return self._pool(x, ceil_mode=False)

    def forward(self, x: Tensor) -> List[Tensor]:
        if self.remat_block1 and torch.is_grad_enabled():
            params = [t for conv in (self.conv1_1, self.conv1_2) for t in (conv.weight, conv.bias)]
            x = checkpoint(self._block1, x, *params, use_reentrant=False)
        else:
            x = F.relu(self.conv1_1(x))
            x = F.relu(self.conv1_2(x))
            x = self._pool(x, ceil_mode=False)
        pools = 1
        conv4_3 = x
        for layer in _VGG_LAYERS[3:]:
            if layer == "pool":
                pools += 1
                # pool3 is ceil-mode (75 -> 38 at input 300).
                x = self._pool(x, ceil_mode=pools == 3)
                continue
            x = F.relu(getattr(self, layer[0])(x))
            if layer[0] == "conv4_3":
                conv4_3 = x
        x = F.max_pool2d(x, 3, 1, padding=1)  # pool5: 3x3/s1 SAME
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return [conv4_3, x]


class SSDExtraLayers(nn.Module):
    """Stride-2 pyramid after fc7: conv8..conv11 at 300 px. Each block is a
    1x1 bottleneck then a 3x3 conv with its stride and padding."""

    def __init__(
        self,
        in_channels: int,
        blocks: Sequence[Tuple[int, int, int, str]] = (
            (256, 512, 2, "SAME"),
            (128, 256, 2, "SAME"),
            (128, 256, 1, "VALID"),
            (128, 256, 1, "VALID"),
        ),
    ):
        super().__init__()
        self.num_blocks = len(blocks)
        cin = in_channels
        for i, (mid, out, stride, pad) in enumerate(blocks):
            self.add_module(f"conv{8 + i}_1", Conv(cin, mid, 1))
            self.add_module(f"conv{8 + i}_2", Conv(mid, out, 3, stride=stride, padding=pad))
            cin = out

    def forward(self, x: Tensor) -> List[Tensor]:
        feats: List[Tensor] = []
        for i in range(self.num_blocks):
            x = F.relu(getattr(self, f"conv{8 + i}_1")(x))
            x = F.relu(getattr(self, f"conv{8 + i}_2")(x))
            feats.append(x)
        return feats
