"""FPN + RetinaNet detector: ResNet-50 C3/C4/C5 -> FPN P3..P7 -> shared heads.

The port of ``object_detector_tpu/models/retinanet.py``: a top-down feature
pyramid (arXiv:1612.03144) and one classification and one regression subnet
shared by all five levels, 9 anchors a location (arXiv:1708.02002). The
output contract is `SSDModel`'s: images (B, H, W, 3) in,

  cls_logits:  (B, num_anchors, num_classes) float32, sigmoid one-vs-all
  box_offsets: (B, num_anchors, 4) float32

concatenated over levels in stride order (8 to 128) and, within a level, in
the anchor order (y, x, slot) of ``anchors/priors.py`` `retinanet_anchors`.
Submodules carry the flax scopes' names (``fpn.lateral3``,
``cls_head.conv0``, ``box_head.out``, ``backbone....``), so
`convert.params_from_jax` maps one tree onto the other.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.models.resnet import ResNet50Backbone
from object_detector_tpu_torch.models.ssd import SSDModel, _dtype
from object_detector_tpu_torch.models.vgg import Conv

Tensor = torch.Tensor

ANCHORS_PER_LOCATION = 9
# ResNet-50's C3, C4, C5 widths.
TRUNK_CHANNELS = (512, 1024, 2048)


def upsample2x(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor, as a broadcast and a
    reshape (the reference's ``_upsample2x``)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


class FPN(nn.Module):
    """Top-down feature pyramid: [C3, C4, C5] -> [P3, P4, P5, P6, P7].
    P6 is a 3x3/s2 SAME conv on C5, P7 one on relu(P6)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        for level, cin in zip((3, 4, 5), TRUNK_CHANNELS):
            self.add_module(f"lateral{level}", Conv(cin, channels, 1))
        for level in (3, 4, 5):
            self.add_module(f"smooth{level}", Conv(channels, channels, 3))
        self.p6 = Conv(TRUNK_CHANNELS[-1], channels, 3, stride=2)
        self.p7 = Conv(channels, channels, 3, stride=2)

    def forward(self, feats: List[Tensor]) -> List[Tensor]:
        c3, c4, c5 = feats
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + upsample2x(p5)
        p3 = self.lateral3(c3) + upsample2x(p4)
        p3, p4, p5 = self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]


class RetinaNetHead(nn.Module):
    """``depth`` 3x3 convs with ReLU, then the out conv with ``num_anchors *
    num_outputs`` channels, flattened to (B, H*W*num_anchors, num_outputs).
    ``use_class_bias`` marks the classification subnet, whose out conv
    `convert.init_params` starts at the class bias."""

    def __init__(self, num_anchors: int, num_outputs: int, depth: int = 4, channels: int = 256,
                 use_class_bias: bool = False):
        super().__init__()
        self.num_anchors = num_anchors
        self.num_outputs = num_outputs
        self.depth = depth
        self.use_class_bias = use_class_bias
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(channels, channels, 3))
        self.out = Conv(channels, num_anchors * num_outputs, 3)

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
        out = self.out(x)
        b, _, h, w = out.shape
        # NCHW -> NHWC before the reshape: anchors are ordered (y, x, slot).
        return out.permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, self.num_outputs)


class RetinaNetModel(nn.Module):
    """ResNet-50 + FPN + shared heads: (B, H, W, 3) normalized images ->
    (logits, offsets)."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.compute_dtype = _dtype(cfg.model.compute_dtype)
        channels, depth = cfg.model.fpn_channels, cfg.model.head_depth
        self.backbone = ResNet50Backbone()
        self.fpn = FPN(channels)
        self.cls_head = RetinaNetHead(ANCHORS_PER_LOCATION, cfg.model.num_classes, depth,
                                      channels, use_class_bias=True)
        self.box_head = RetinaNetHead(ANCHORS_PER_LOCATION, 4, depth, channels)

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        pyramid = self.fpn(self.backbone(x))
        cls_out = [self.cls_head(p).float() for p in pyramid]
        box_out = [self.box_head(p).float() for p in pyramid]
        return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)


def build_model(cfg: DetectorConfig) -> nn.Module:
    """Config -> the model of its family (RetinaNet, DETR, Deformable DETR or
    SSD)."""
    if cfg.model.family == "retinanet":
        return RetinaNetModel(cfg)
    if cfg.model.family == "detr":
        from object_detector_tpu_torch.models.detr import DETRModel

        return DETRModel(cfg)
    if cfg.model.family == "deformable_detr":
        from object_detector_tpu_torch.models.deformable_detr import DeformableDETRModel

        return DeformableDETRModel(cfg)
    return SSDModel(cfg)
