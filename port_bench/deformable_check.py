"""The comparison that decides ``correct`` for Deformable DETR's served
detections.

Deformable DETR serves the best ``top_k`` (query, class) scores of an image,
so its served detections are held as a set, as `port_bench.check` holds
SSD's: against every candidate the reference model gives for the same canvas
and extent (each query's sigmoid score of a class, and the query's box in
pixels of the image), and against the reference's own top ``top_k``. Each
number but the last two is the worst over the images compared:

- ``det_gap``: every served detection has to be a candidate the reference
  produces. For each one, the nearest reference query of its class, at the
  distance max(|score - reference score|, largest corner difference of the
  boxes over the image's longer side); the worst of those. A score or box
  altered, a label served with another's score, or a detection of another
  image shows here.
- ``box_gap``: the largest corner difference, in pixels, of a served box
  from its nearest candidate's (the one ``det_gap`` picked).
- ``top_gap``: the served top score against the reference's best; the best
  is always served, so they differ by rounding alone. ``top_logit_gap`` is
  the same on the logit scale (`check._logit`).
- ``miss_gap``: every reference top-``top_k`` detection has to be served,
  or fall near the served list's cut. For each, the least of: its distance
  (as ``det_gap``'s) to a served detection of its class, and its score less
  the least served score. A program that serves the wrong ones shows here.
- ``slot_breaks``: served slots that break the output's form, counted: not
  valid, a label outside the classes, a score or box not finite, a score
  above the one served before it.
- ``box_median_gap``: the median of ``box_gap``'s differences over every
  served detection. The worst gaps of a sound program are set by the few
  detections the bfloat16 transformer moves most; the median follows the
  error every one carries.
- ``box_median_ratio``: ``box_median_gap`` over the same median of the
  yardstick's own detections on the same canvases
  (`reference.deformable_detr.yardstick`: the reference at the
  configuration's precision, its trunk fake-quantized to 8 bits, every
  product of its transformer on bfloat16 inputs). A seeded model's
  sensitivity to rounding varies from seed to seed by more than a fault of
  the sampling moves its boxes; the yardstick's gap carries that
  sensitivity, so the ratio holds a sound program near a constant and a
  fault above it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from port_bench.check import _logit
from port_bench.reference import deformable_detr


def _corners(boxes: torch.Tensor, extents: torch.Tensor) -> torch.Tensor:
    """(B, Q, 4) cx, cy, w, h in [0, 1] -> corners in pixels of each extent."""
    cx, cy, w, h = boxes.unbind(-1)
    corners = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    img_h, img_w = extents.to(corners.dtype).unbind(1)
    return corners * torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None]


def image_gaps(served, ref_logits: torch.Tensor, ref_boxes: torch.Tensor,
               extents: torch.Tensor, top_k: int) -> Dict[str, torch.Tensor]:
    """Gaps of each image of a batch, (B,) (``box_slots`` (B, K)): the served
    (boxes, scores, classes, valid), each (B, K, ...), against the
    reference's (B, Q, C) logits and (B, Q, 4) boxes for the same (B, 2)
    extents, all on one device."""
    boxes, scores, classes, valid = (t.to(ref_logits.device) for t in served)
    boxes, scores = boxes.float(), scores.float()
    b, q, c = ref_logits.shape
    k = scores.shape[1]
    prob = torch.sigmoid(ref_logits)
    ref_corners = _corners(ref_boxes, extents)
    side = extents.float().amax(1)[:, None, None]
    labels = classes.long()
    at_class = prob.gather(2, labels.clamp(0, c - 1)[:, None, :].expand(b, q, k)).transpose(1, 2)
    box_px = (boxes[:, :, None, :] - ref_corners[:, None, :, :]).abs().amax(-1)  # (B, K, Q)
    dist = torch.maximum((scores[..., None] - at_class).abs(), box_px / side)
    det, nearest = dist.min(-1)
    box_slots = box_px.gather(-1, nearest[..., None])[..., 0]

    r_corners, r_scores, r_labels, _ = deformable_detr.postprocess(ref_logits, ref_boxes,
                                                                   extents, top_k)
    same = r_labels[:, :, None] == labels[:, None, :]  # (B, Kr, K)
    m_dist = torch.maximum((r_scores[..., None] - scores[:, None, :]).abs(),
                           (r_corners[:, :, None, :] - boxes[:, None, :, :]).abs().amax(-1)
                           / side)
    m_dist = torch.where(same, m_dist, torch.full_like(m_dist, float("inf"))).amin(-1)
    miss = torch.minimum(m_dist, (r_scores - scores.amin(1, keepdim=True)).clamp_min(0))

    breaks = (~valid | (labels < 0) | (labels >= c) | ~torch.isfinite(scores)
              | ~torch.isfinite(boxes).all(-1))
    breaks[:, 1:] |= scores[:, 1:] > scores[:, :-1]
    top, ref_top = scores.amax(1), prob.flatten(1).amax(1)
    return {"det": det.amax(1), "box": box_slots.amax(1), "box_slots": box_slots,
            "miss": miss.amax(1), "top": (top - ref_top).abs(),
            "top_logit": (_logit(top) - _logit(ref_top)).abs().float(),
            "breaks": breaks.sum(1)}


def _cat(gaps: Sequence[Dict[str, torch.Tensor]], key: str) -> torch.Tensor:
    return torch.cat([g[key].flatten() for g in gaps]).float().cpu()


def worst(gaps: Sequence[Dict[str, torch.Tensor]],
          yardstick: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The check's numbers (module docstring) over `image_gaps` of the
    compared batches' served detections and of the yardstick's."""
    median = float(_cat(gaps, "box_slots").median())
    return {"det_gap": float(_cat(gaps, "det").max()), "top_gap": float(_cat(gaps, "top").max()),
            "top_logit_gap": float(_cat(gaps, "top_logit").max()),
            "miss_gap": float(_cat(gaps, "miss").max()), "box_gap": float(_cat(gaps, "box").max()),
            "slot_breaks": int(_cat(gaps, "breaks").sum()), "box_median_gap": median,
            "box_median_ratio": median / max(float(_cat(yardstick, "box_slots").median()), 1e-6)}


def spread(gaps: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, list]:
    """Quantiles 0.5, 0.9 and the maximum of each gap over the images, for
    the earlier lines of a run's output."""
    out = {}
    for key in ("det", "top", "top_logit", "miss", "box"):
        v = torch.cat([g[key] for g in gaps]).float().cpu()
        out[key] = [float(x) for x in torch.quantile(v, torch.tensor([0.5, 0.9]))] \
            + [float(v.max())]
    return out
