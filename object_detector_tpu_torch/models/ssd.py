"""SSD detector assembly: backbone + extra layers + multi-scale heads.

The port of ``object_detector_tpu/models/ssd.py``: SSD-300/VGG16 (taps
conv4_3, L2Norm'd, and fc7, plus 4 extra blocks: 6 levels) and
SSD-512/ResNet-50 (taps C3, C4, C5 plus 4 extra blocks: 7 levels). The public
layout is the reference's: images (B, H, W, 3) in, and concatenated over
levels, in the anchor order of ``anchors/priors.py``,

  cls_logits:  (B, num_anchors, num_classes) float32, sigmoid one-vs-all
  box_offsets: (B, num_anchors, 4) float32, SSD-encoded

The convs run NCHW in ``cfg.model.compute_dtype``; head outputs are cast to
float32.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.models.resnet import ResNet50Backbone
from object_detector_tpu_torch.models.vgg import Conv, L2Norm, SSDExtraLayers, VGG16Backbone

Tensor = torch.Tensor

_PRIOR_P = 0.01
# Class-bias init -log((1-p)/p), p = 0.01 (RetinaNet §4.1).
CLASS_BIAS_INIT = -math.log((1.0 - _PRIOR_P) / _PRIOR_P)

_SSD300_EXTRA_BLOCKS = (
    (256, 512, 2, "SAME"),
    (128, 256, 2, "SAME"),
    (128, 256, 1, "VALID"),
    (128, 256, 1, "VALID"),
)


class PredictionHead(nn.Module):
    """Per-level 3x3 conv heads -> flattened (B, H*W*a, C) / (B, H*W*a, 4)."""

    def __init__(self, in_channels: int, num_anchors: int, num_classes: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        self.cls = Conv(in_channels, num_anchors * num_classes, 3)
        self.box = Conv(in_channels, num_anchors * 4, 3)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        b, _, h, w = x.shape
        # NCHW -> NHWC before the reshape: anchors are ordered (y, x, slot).
        cls = self.cls(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, self.num_classes)
        box = self.box(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, 4)
        return cls.float(), box.float()


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


class SSDModel(nn.Module):
    """Full SSD forward: (B, H, W, 3) normalized images -> (logits, offsets)."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        if cfg.model.family != "ssd":
            raise NotImplementedError(f"model family {cfg.model.family!r} is not ported yet")
        self.config = cfg
        self.compute_dtype = _dtype(cfg.model.compute_dtype)
        self.l2norm = None
        if cfg.model.backbone == "vgg16":
            self.backbone = VGG16Backbone(
                pack_block1=cfg.model.pack_block1,
                pool_grad_kernel=cfg.model.pool_grad_kernel,
                remat_block1=cfg.model.remat_block1,
            )
            self.l2norm = L2Norm(512, init_scale=cfg.model.l2norm_scale)
            channels = [512, 1024]
        elif cfg.model.backbone == "resnet50":
            self.backbone = ResNet50Backbone()
            channels = [512, 1024, 2048]
        else:
            raise ValueError(f"unknown backbone {cfg.model.backbone!r}")
        n_extra = len(cfg.anchors.feature_sizes) - len(channels)
        self.extras = None
        if n_extra > 0:
            if cfg.model.image_size >= 512:
                blocks = ((256, 512, 2, "SAME"),) + ((128, 256, 2, "SAME"),) * (n_extra - 1)
            else:
                blocks = _SSD300_EXTRA_BLOCKS[:n_extra]
            self.extras = SSDExtraLayers(channels[-1], blocks)
            channels += [out for _, out, _, _ in blocks]
        self.num_levels = len(channels)
        for level, (cin, a) in enumerate(zip(channels, cfg.anchors.anchors_per_level)):
            self.add_module(f"head{level}", PredictionHead(cin, a, cfg.model.num_classes))

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        cfg = self.config
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        taps = self.backbone(x)
        if self.l2norm is not None:
            taps[0] = self.l2norm(taps[0])
        if self.extras is not None:
            taps = taps + self.extras(taps[-1])

        expected = tuple(cfg.anchors.feature_sizes)
        got = tuple(t.shape[2] for t in taps)
        if got != expected:
            raise ValueError(
                f"feature pyramid mismatch: model produced {got}, anchors expect {expected}"
            )

        cls_out: List[Tensor] = []
        box_out: List[Tensor] = []
        for level, feat in enumerate(taps):
            c, bx = getattr(self, f"head{level}")(feat)
            cls_out.append(c)
            box_out.append(bx)
        return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)
