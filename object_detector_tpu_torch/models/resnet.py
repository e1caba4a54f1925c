"""ResNet-50 backbone, bottleneck v1.5 (stride on the 3x3), NCHW inside.

The port of ``object_detector_tpu/models/resnet.py``. Returns the C3, C4, C5
pyramid (strides 8, 16, 32) that the SSD-512 heads tap. Module and parameter
names follow the flax trees (``backbone/stage1_block1/bn1/scale`` is
``backbone.stage1_block1.bn1.weight``; the ``batch_stats`` collection's
``mean`` and ``var`` are ``running_mean`` and ``running_var`` of the same
module), so `object_detector_tpu_torch.convert.variables_from_jax` maps one
onto the other.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: in
eval mode on its running statistics, in training mode on the batch's (and
then it moves its running statistics, in place). Either way it is computed
in float32 on float32 parameters and rounded once to the activation's dtype.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detector_tpu_torch.models.vgg import Conv

Tensor = torch.Tensor

STAGE_SIZES = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
# flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch.
MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of an NCHW tensor:
    ``(x - mean) * weight / sqrt(var + eps) + bias``, eps 1e-5.

    In eval mode mean and var are the running statistics. In training mode
    they are the batch's, over N, H and W in float32 (float64 for a float64
    input), as flax computes them (``use_fast_variance``): ``mean = E[x]``, ``var = max(E[x^2] - mean^2,
    0)``, the biased variance, differentiated through; and the running
    statistics move in place by `MOMENTUM`. ``torch.nn.BatchNorm2d`` would
    keep the unbiased variance."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.epsilon = epsilon

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.epsilon)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = torch.clamp_min(xf.square().mean((0, 2, 3)) - mean.square(), 0.0)
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                running.mul_(MOMENTUM).add_(batch, alpha=1.0 - MOMENTUM)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (carries the stride) -> 1x1, each with BatchNorm, plus the
    shortcut: a projection where the shape changes, else the input."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv(in_channels, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.has_proj = in_channels != out or stride != 1
        if self.has_proj:
            self.proj = Conv(in_channels, out, 1, stride=stride, bias=False)
            self.bn_proj = BatchNorm(out)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = self.bn_proj(self.proj(x)) if self.has_proj else x
        return F.relu(out + shortcut)


class ResNet50Backbone(nn.Module):
    """ResNet-50. Returns [C3, C4, C5] feature maps, NCHW."""

    def __init__(self, stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__()
        self.stem_conv = Conv(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.block_names: List[List[str]] = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, STAGE_WIDTHS), start=1):
            names = []
            for block in range(1, n_blocks + 1):
                stride = 2 if (block == 1 and stage > 1) else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BottleneckBlock(cin, width, stride))
                names.append(name)
                cin = width * 4
            self.block_names.append(names)

    def forward(self, x: Tensor) -> List[Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        feats: List[Tensor] = []
        for stage, names in enumerate(self.block_names, start=1):
            for name in names:
                x = getattr(self, name)(x)
            if stage >= 2:  # C3, C4, C5
                feats.append(x)
        return feats
