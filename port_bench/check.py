"""The comparison that decides ``correct`` for served detections.

Served detections of one image (boxes normalized to [0, 1], scores, class
ids) are held against the reference's per-anchor scores and decoded boxes
for the same image, and against the reference's own detections of them
(`reference.detector.detect`: decode, per-class NMS, the image's best).
Each number is the worst over the images compared:

- ``det_gap``: every served detection has to be a candidate the reference
  model produces. For each one, the nearest reference candidate of its
  class, at the distance max(|score - reference score|, largest coordinate
  difference of the boxes); the worst of those. An altered score or box, or
  a detection of another image, shows here.
- ``top_gap``: every image's strongest detection has to be served. The
  best candidate always survives NMS, so the served top score and the
  reference's best score differ by rounding alone; an image left out or
  served empty reads the reference's best score less the threshold that
  the served list was cut at. ``top_logit_gap`` is the same in logits.
- ``miss_gap``: every reference detection has to be served, or have a
  reason not to be. For each, its score less the best of: a served
  detection of its class that overlaps it by more than the NMS threshold
  less ``COVER_SLACK`` (itself, or the box that suppressed it where
  rounding flipped the order), or whose box lies within ``MATCH_SLACK`` of
  its box (a box clipped to zero width or height overlaps nothing, itself
  included), counted at the reference's score of its anchor; the score
  that cut the list (the threshold, or the least of a full image or class,
  served or the reference's own); or its anchor's best score less the
  anchor that cut the pre-NMS list. A served
  detection's anchor is the one whose reference box lies nearest, or
  within ``MATCH_SLACK`` of that and nearest in score: near the image's
  edges, clipping leaves the boxes of neighbouring large anchors closer
  than the int8 boxes' error. An NMS that keeps too little, or the wrong
  ones, shows here, and so does a model that serves the wrong ones with
  any scores.
- ``nms_overlap``: the largest IoU of two served detections of one class,
  which NMS holds at ``nms_iou_threshold``. An NMS that suppresses too
  little shows here.
- ``nms_rule_breaks``: served detections that break a rule the
  configuration states, counted: a score not above ``score_threshold``,
  more than ``nms_max_per_class`` in a class or ``max_detections`` in an
  image, a score above the one served before it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# A served box covers a reference detection of its class above this IoU
# less the NMS threshold: the int8 boxes move a little against the
# reference's, and so does the IoU of a box and the one it suppressed.
COVER_SLACK = 0.15
# Box coordinates (normalized) within which the anchors' reference boxes
# are taken as equally near a served box; ten times the int8 boxes' median
# error.
MATCH_SLACK = 0.03
# Served detections compared against all anchors at once, in chunks of rows.
_CHUNK = 64


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def image_gaps(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
               ref_scores: torch.Tensor, ref_boxes: torch.Tensor,
               threshold: float) -> Dict[str, torch.Tensor]:
    """Gaps of one image: served (D, 4), (D,), (D,) against the reference's
    (A, C) scores and (A, 4) boxes, all on one device. ``det`` holds each
    served detection's distance to its nearest reference candidate,
    ``ref_score`` the reference's score of its class at its anchor (see
    ``miss_gap``)."""
    ref_top = ref_scores.max()
    if scores.numel() == 0:
        miss = (ref_top - threshold).clamp_min(0)
        return {"det": scores.new_zeros(0), "ref_score": scores.new_zeros(0),
                "top": miss.reshape(1),
                "top_logit": (_logit(ref_top) - _logit(torch.tensor(threshold))).clamp_min(0)
                .reshape(1).float()}
    det, ref_score = [], []
    for i in range(0, scores.numel(), _CHUNK):
        b, s, c = boxes[i:i + _CHUNK], scores[i:i + _CHUNK], classes[i:i + _CHUNK].long()
        box_d = (ref_boxes[None] - b[:, None]).abs().amax(-1)  # (d, A)
        at_class = ref_scores[:, c].T  # (d, A)
        det.append(torch.maximum(box_d, (at_class - s[:, None]).abs()).amin(1))
        near = box_d <= box_d.amin(1, keepdim=True) + MATCH_SLACK
        pick = torch.where(near, (at_class - s[:, None]).abs(), float("inf")).argmin(1)
        ref_score.append(at_class.gather(1, pick[:, None])[:, 0])
    top = scores.max()
    return {"det": torch.cat(det), "ref_score": torch.cat(ref_score),
            "top": (top - ref_top).abs().reshape(1),
            "top_logit": (_logit(top) - _logit(ref_top)).abs().reshape(1).float()}


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, n, 4) and (B, m, 4) corner boxes -> (B, n, m) IoU in float64."""
    a, b = a.double(), b.double()
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[..., 2:] - t[..., :2]).clamp_min(0).prod(-1)  # noqa: E731
    union = area(a)[:, :, None] + area(b)[:, None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-300), torch.zeros_like(inter))


def nms_gaps(served, served_ref: torch.Tensor, reference, ref_scores: torch.Tensor,
             e: dict) -> Dict[str, torch.Tensor]:
    """``miss``, ``overlap`` and ``rules`` of each image of a batch: the
    served (boxes, scores, classes, valid), each (B, D, ...), with their
    reference scores ``served_ref`` (B, D) (`image_gaps`' ``ref_score``),
    against the reference's `detect` with its anchors, (B, N, ...), and
    its (B, A, C) scores, all on one device. ``e`` is the configuration's
    ``eval``."""
    boxes, scores, classes, valid = served
    b, d = scores.shape
    a, c = ref_scores.shape[1:]
    scores, classes = scores.double(), classes.long()
    thr = float(torch.tensor(e["score_threshold"], dtype=torch.float32))
    n_out = min(e["nms_max_per_class"], e["max_detections"], 2 * e["pre_nms_top_k"], a)

    later = torch.ones(d, d, dtype=torch.bool, device=scores.device).triu(1)
    pair = valid[:, :, None] & valid[:, None, :] & later
    same = pair & (classes[:, :, None] == classes[:, None, :])
    overlap = torch.where(same, _iou(boxes, boxes), 0.0).amax((1, 2))

    count = torch.zeros(b, c, dtype=torch.long, device=scores.device).scatter_add_(
        1, classes.clamp(0, c - 1), valid.long())
    rules = ((valid & (scores <= thr)).sum(1)
             + (pair & (scores[:, :, None] < scores[:, None, :])).sum((1, 2))
             + (count - n_out).clamp_min(0).sum(1)
             + (valid.sum(1) - e["max_detections"]).clamp_min(0))

    miss = torch.where(reference[3], _misses(served, served_ref, reference, ref_scores, e, count),
                       0.0).amax(1)
    return {"miss": miss.float(), "overlap": overlap.float(), "rules": rules}


def _misses(served, served_ref, reference, ref_scores, e, count) -> torch.Tensor:
    """``miss_gap`` of each reference detection, (B, N), as `nms_gaps`
    takes its arguments; ``count`` holds the served detections a class."""
    boxes, scores, classes, valid = served
    r_boxes, r_scores, r_classes, r_valid, r_anchors = reference
    b, a, c = ref_scores.shape
    scores, served_ref, r_scores = scores.double(), served_ref.double(), r_scores.double()
    classes, r_classes = classes.long(), r_classes.long()
    thr = float(torch.tensor(e["score_threshold"], dtype=torch.float32))
    m = min(2 * e["pre_nms_top_k"], a)
    n_out = min(e["nms_max_per_class"], e["max_detections"], m)
    # The least score of each image and class, served or the reference's
    # own: where either list is cut there.
    least = torch.where(valid, scores, float("inf")).amin(1)
    least = torch.minimum(least, torch.where(r_valid, r_scores, float("inf")).amin(1))
    floor = torch.where(valid.sum(1) >= e["max_detections"], least,
                        torch.full_like(least, thr)).clamp_min(thr)
    inf = torch.full((b, c), float("inf"), dtype=scores.dtype, device=scores.device)
    class_least = torch.minimum(
        inf.scatter_reduce(1, classes.clamp(0, c - 1),
                           torch.where(valid, scores, float("inf")), "amin"),
        inf.scatter_reduce(1, r_classes.clamp(0, c - 1),
                           torch.where(r_valid, r_scores, float("inf")), "amin"))
    class_floor = torch.where(count >= n_out, class_least, torch.full_like(class_least, thr))
    floor = torch.maximum(floor[:, None], torch.gather(class_floor, 1, r_classes))
    near = _iou(r_boxes, boxes) > e["nms_iou_threshold"] - COVER_SLACK
    near |= (r_boxes[:, :, None] - boxes[:, None]).abs().amax(-1) <= MATCH_SLACK
    near &= (r_classes[:, :, None] == classes[:, None, :]) & valid[:, None, :]
    cover = torch.where(near, served_ref[:, None, :], 0.0).amax(2)
    gap = r_scores - torch.maximum(cover, floor)
    best = ref_scores.amax(-1).double()  # (B, A)
    if m < a:
        cut = best.topk(m, dim=1).values[:, -1:]
        gap = torch.minimum(gap, torch.gather(best, 1, r_anchors.long()) - cut)
    return gap.clamp_min(0)


def worst(gaps: Sequence[Dict[str, torch.Tensor]],
          nms: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    det = torch.cat([g["det"] for g in gaps]).float().cpu()
    top = torch.cat([g["top"] for g in gaps]).float().cpu()
    top_logit = torch.cat([g["top_logit"] for g in gaps]).float().cpu()
    cat = lambda key: torch.cat([g[key] for g in nms]).cpu()  # noqa: E731
    return {"det_gap": float(det.max()) if det.numel() else 0.0,
            "top_gap": float(top.max()), "top_logit_gap": float(top_logit.max()),
            "miss_gap": float(cat("miss").max()), "nms_overlap": float(cat("overlap").max()),
            "nms_rule_breaks": int(cat("rules").sum())}


def spread(gaps: Sequence[Dict[str, torch.Tensor]],
           nms: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, list]:
    """Quantiles 0.5, 0.9, 0.99 and the maximum of each gap, for the
    earlier lines of a run's output."""
    gaps = list(gaps) + [{"miss": g["miss"]} for g in nms]
    out = {}
    for key in ("det", "top", "top_logit", "miss"):
        v = torch.cat([g[key] for g in gaps if key in g]).float().cpu()
        if v.numel():
            out[key] = [float(x) for x in torch.quantile(v, torch.tensor([0.5, 0.9, 0.99]))] \
                + [float(v.max())]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())
