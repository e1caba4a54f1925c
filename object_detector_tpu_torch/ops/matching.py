"""GT-to-anchor matching and target encoding, batched.

The port of ``object_detector_tpu/ops/matching.py``: the SSD paper's
bipartite + threshold matching with a RetinaNet-style ignore band, all
knobs in `MatcherConfig`:

  1. every valid GT force-matches its best-IoU anchor (bipartite step),
  2. every anchor whose best GT IoU >= positive_iou is positive,
  3. anchors in [negative_iou, positive_iou) are ignored (class target -1),
  4. the rest are background (class target 0).

Class targets: int32 in {-1 (ignore), 0 (background), 1..C (foreground)}.
Box targets: SSD-encoded offsets against the anchor set.

GT tensors carry any leading batch dimensions, (..., M, 4), (..., M) and
(..., M), padded to a static M with a validity mask; the reference maps one
image at a time with ``vmap``, here the batch is written out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_detector_tpu_torch.core.config import MatcherConfig
from object_detector_tpu_torch.ops import boxes as box_ops

Tensor = torch.Tensor


class MatchTargets(NamedTuple):
    cls: Tensor  # (..., A) int32: -1 ignore / 0 background / 1..C foreground
    box: Tensor  # (..., A, 4) float32 encoded offsets (zeros for non-positive)
    matched_gt: Tensor  # (..., A) int32 index of matched GT (0 if none)


def first_argmax(x: Tensor, dim: int) -> Tensor:
    """Index of the first maximum along ``dim``, as ``jnp.argmax`` gives it.
    Written as a min over the positions that hold the maximum, so the answer
    does not depend on how a device's argmax breaks ties (an all -1 padded
    column or row is all ties)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    positions = torch.arange(n, device=x.device).view(shape)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, positions, n).amin(dim=dim)


def match(
    gt_boxes: Tensor,  # (..., M, 4) corner, padded
    gt_labels: Tensor,  # (..., M) int in 1..C (0 pad ok)
    gt_valid: Tensor,  # (..., M) bool
    anchors_center: Tensor,  # (A, 4)
    cfg: MatcherConfig,
    center_variance: float = 0.1,
    size_variance: float = 0.2,
) -> MatchTargets:
    anchors_corner = box_ops.center_to_corner(anchors_center)
    num_anchors = anchors_center.shape[0]
    m = gt_boxes.shape[-2]
    # (..., A, M) IoU; invalid GT columns forced to -1 so they never win.
    iou = box_ops.iou(anchors_corner, gt_boxes)
    iou = torch.where(gt_valid[..., None, :], iou, -1.0)

    # Threshold step: best GT per anchor.
    best_gt_iou = iou.amax(dim=-1)  # (..., A)
    best_gt_idx = first_argmax(iou, dim=-1)

    if cfg.force_match_best:
        # Bipartite step: each valid GT claims its best anchor. Where several
        # GTs claim one anchor the reference's scatter lets the last write
        # win, which is the largest GT index; a max-reduction says the same
        # and does not depend on the order a device scatters in.
        best_anchor_per_gt = first_argmax(iou, dim=-2)  # (..., M)
        gt_ids = torch.arange(m, device=iou.device).expand(gt_valid.shape)
        slot = torch.where(gt_valid, best_anchor_per_gt, num_anchors)  # pads go to a spare slot
        forced = torch.full((*gt_valid.shape[:-1], num_anchors + 1), -1, device=iou.device,
                            dtype=torch.int64)
        forced = forced.scatter_reduce(
            -1, slot, torch.where(gt_valid, gt_ids, -1), "amax", include_self=True
        )[..., :num_anchors]
        is_forced = forced >= 0
        matched_gt = torch.where(is_forced, forced, best_gt_idx)
        # Forced anchors count as positives regardless of IoU.
        positive = is_forced | (best_gt_iou >= cfg.positive_iou)
    else:
        matched_gt = best_gt_idx
        positive = best_gt_iou >= cfg.positive_iou

    ignore = (~positive) & (best_gt_iou >= cfg.negative_iou)

    # Plain gathers: the reference's one-hot matmuls select the same values.
    matched_labels = torch.gather(gt_labels.to(torch.int32), -1, matched_gt)
    cls = torch.where(positive, matched_labels, 0)
    cls = torch.where(ignore, -1, cls).to(torch.int32)

    matched_boxes = torch.gather(
        gt_boxes.to(torch.float32), -2, matched_gt[..., None].expand(*matched_gt.shape, 4)
    )
    encoded = box_ops.encode(matched_boxes, anchors_center, center_variance, size_variance)
    box = torch.where(positive[..., None], encoded, 0.0)
    return MatchTargets(cls=cls, box=box, matched_gt=matched_gt.to(torch.int32))
