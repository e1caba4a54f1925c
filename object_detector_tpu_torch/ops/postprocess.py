"""Raw head outputs -> final detections (decode + score + per-class NMS).

The port of ``object_detector_tpu/ops/postprocess.py``. With ``use_pallas``
(the config default ``eval.use_pallas_nms``) the NMS runs through the
hand-written kernel path (`kernels.nms.decode_nms`); without it, through
the plain per-class NMS of `ops.nms`. `postprocess_levels` takes the int8
heads' native per-level tensors (``eval.per_level_heads``) to the same
kernel path through `kernels.nms.decode_nms_levels`. `detr_postprocess` is
DETR's own and `deformable_detr_postprocess` Deformable DETR's (no anchors,
no NMS).
"""

from __future__ import annotations

from typing import Sequence

import torch

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.kernels.nms import decode_nms, decode_nms_levels
from object_detector_tpu_torch.ops import boxes as box_ops
from object_detector_tpu_torch.ops import nms as nms_ops
from object_detector_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def scores_from_logits(cls_logits: Tensor, family: str) -> Tensor:
    """(B, A, C) logits -> (B, A, C) foreground probabilities.

    Both families use sigmoid (one-vs-all) heads.
    """
    del family
    return torch.sigmoid(cls_logits)


def postprocess(
    cls_logits: Tensor,  # (B, A, C)
    box_offsets: Tensor,  # (B, A, 4)
    anchors_center: Tensor,  # (A, 4)
    cfg: DetectorConfig,
    use_pallas: bool | None = None,
) -> nms_ops.Detections:
    """Batched decode -> per-class NMS. Returns batch-stacked Detections."""
    if use_pallas is None:
        use_pallas = cfg.eval.use_pallas_nms
    with span("odt.postprocess"):
        if use_pallas:
            # The logits keep their dtype (bf16 from the int8 heads with
            # eval.int8_logits_bf16): the prefilter selects on them as they are.
            return decode_nms(cls_logits, box_offsets.float(), anchors_center, **nms_kwargs(cfg))

        scores = scores_from_logits(cls_logits.float(), cfg.model.family)
        decoded = box_ops.decode(
            box_offsets.float(),
            anchors_center,
            cfg.anchors.center_variance,
            cfg.anchors.size_variance,
            clip=True,
        )  # (B, A, 4)
        return nms_ops.per_class_nms(
            decoded,
            scores,
            score_threshold=cfg.eval.score_threshold,
            iou_threshold=cfg.eval.nms_iou_threshold,
            pre_nms_top_k=cfg.eval.pre_nms_top_k,
            max_detections=cfg.eval.max_detections,
        )


def nms_kwargs(cfg: DetectorConfig) -> dict:
    """The kernel path's settings from ``cfg``."""
    return dict(
        score_threshold=cfg.eval.score_threshold,
        iou_threshold=cfg.eval.nms_iou_threshold,
        pre_nms_top_k=cfg.eval.pre_nms_top_k,
        max_detections=cfg.eval.max_detections,
        max_per_class=cfg.eval.nms_max_per_class,
        center_variance=cfg.anchors.center_variance,
        size_variance=cfg.anchors.size_variance,
        exact_prefilter=cfg.eval.nms_exact_prefilter,
        packed_sort=cfg.eval.nms_packed_sort,
        class_top_k=cfg.eval.nms_class_top_k,
        coord_bf16=cfg.eval.nms_coord_bf16,
    )


def postprocess_levels(
    level_logits: Sequence[Tensor],  # per level: (B, H, W, a*C) head-native raw logits
    level_offsets: Sequence[Tensor],  # per level: (B, H, W, a*4) box offsets
    anchors_center: Tensor,  # (A, 4) the full level-major anchor set
    cfg: DetectorConfig,
) -> nms_ops.Detections:
    """Per-level decode -> NMS over the heads' native per-level tensors: the
    concatenated (B, A, C) logits are never built. The same candidate set
    as `postprocess` with use_pallas=True (the two-stage exact prefilter of
    `decode_nms_levels`). Kernel path only; pair with
    ``eval.per_level_heads``."""
    with span("odt.postprocess"):
        return decode_nms_levels(
            tuple(level_logits),
            tuple(t.float() for t in level_offsets),
            anchors_center,
            tuple(cfg.anchors.anchors_per_level),
            **nms_kwargs(cfg),
        )


def detr_postprocess(logits: Tensor, boxes: Tensor, extents: Tensor) -> nms_ops.Detections:
    """DETR's ``PostProcess``: (B, Q, C + 1) logits (the last "no object")
    and (B, Q, 4) cx, cy, w, h boxes in [0, 1] of each image's (B, 2) extent
    (h, w) -> one detection a query: the softmax's best class but the last
    (its probability the score, its index the class), the box in corner
    form and pixels of the image. Every query's detection is valid."""
    with span("odt.detr.postprocess"):
        scores, labels = torch.softmax(logits.float(), dim=-1)[..., :-1].max(dim=-1)
        cx, cy, w, h = boxes.float().unbind(-1)
        corners = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
        size = extents.to(device=corners.device, dtype=torch.float32)
        scale = torch.stack([size[:, 1], size[:, 0], size[:, 1], size[:, 0]], dim=-1)
        return nms_ops.Detections(corners * scale[:, None], scores, labels.to(torch.int32),
                                  torch.ones_like(scores, dtype=torch.bool))


def deformable_detr_postprocess(logits: Tensor, boxes: Tensor, extents: Tensor,
                                top_k: int) -> nms_ops.Detections:
    """Deformable DETR's ``PostProcess``: (B, Q, C) logits (sigmoid scores,
    no "no object") and (B, Q, 4) cx, cy, w, h boxes in [0, 1] of each
    image's (B, 2) extent (h, w) -> the ``top_k`` best of the Q * C
    (query, class) scores of each image, best first: index i is query i // C
    and class i % C, its box in corner form and pixels of the image. Every
    detection is valid."""
    with span("odt.deformable.postprocess"):
        b, _, c = logits.shape
        scores, index = torch.sigmoid(logits.float()).reshape(b, -1).topk(top_k, dim=1)
        query, labels = index // c, index % c
        cx, cy, w, h = boxes.float().unbind(-1)
        corners = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
        corners = corners.gather(1, query[..., None].expand(-1, -1, 4))
        size = extents.to(device=corners.device, dtype=torch.float32)
        scale = torch.stack([size[:, 1], size[:, 0], size[:, 1], size[:, 0]], dim=-1)
        return nms_ops.Detections(corners * scale[:, None], scores, labels.to(torch.int32),
                                  torch.ones_like(scores, dtype=torch.bool))
