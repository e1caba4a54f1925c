"""The comparison that decides ``correct`` for DETR's served detections.

DETR serves one detection an object query, in the order of the queries, so
the served detections of an image are held slot by slot against the
reference's logits and boxes for the same canvas and extent. Each number but
the last is the worst over the images and queries compared:

- ``score_gap``: the served score against the reference's probability of
  the served label. A score altered, or a label served with another's
  score, shows here.
- ``top_gap``: the served score against the reference's best probability
  (the served label is the best, or within rounding of it); ``top_logit_gap``
  the same on the logit scale, as `check._logit` reads it, which opens up
  the scores near 0 and 1.
- ``box_gap``: the largest difference of a served box's corner from the
  reference's, in pixels of the image.
- ``slot_breaks``: served slots that break the output's form, counted: not
  valid, a label outside the classes, a score or box not finite.
- ``box_median_gap``: the median over every compared slot of its largest
  corner difference. The worst gaps of a sound program are set by the few
  queries whose outputs the bfloat16 transformer moves most; the median
  follows the error every query carries, which a coarser trunk raises.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from port_bench.check import _logit
from port_bench.reference import detr


def image_gaps(served, ref_logits: torch.Tensor, ref_boxes: torch.Tensor,
               extents: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gaps of each image of a batch, (B,): the served (boxes, scores,
    classes, valid), each (B, Q, ...), against the reference's (B, Q, C + 1)
    logits and (B, Q, 4) boxes for the same (B, 2) extents, all on one
    device."""
    boxes, scores, classes, valid = served
    ref_corners, ref_best, _ = detr.postprocess(ref_logits, ref_boxes, extents)
    prob = torch.softmax(ref_logits, dim=-1)[..., :-1]
    n_classes = prob.shape[-1]
    labels = classes.long()
    at_label = prob.gather(-1, labels.clamp(0, n_classes - 1)[..., None])[..., 0]
    breaks = (~valid | (labels < 0) | (labels >= n_classes) | ~torch.isfinite(scores)
              | ~torch.isfinite(boxes).all(-1))
    box_slots = (boxes - ref_corners).abs().amax(2)
    return {"score": (scores - at_label).abs().amax(1),
            "top": (scores - ref_best).abs().amax(1),
            "top_logit": (_logit(scores) - _logit(ref_best)).abs().amax(1).float(),
            "box": box_slots.amax(1),
            "breaks": breaks.sum(1), "box_slots": box_slots}


def worst(gaps: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The check's numbers (module docstring) over `image_gaps` of the
    compared batches."""
    cat = lambda key: torch.cat([g[key].flatten() for g in gaps]).float().cpu()  # noqa: E731
    return {"score_gap": float(cat("score").max()), "top_gap": float(cat("top").max()),
            "top_logit_gap": float(cat("top_logit").max()), "box_gap": float(cat("box").max()),
            "slot_breaks": int(cat("breaks").sum()),
            "box_median_gap": float(cat("box_slots").median())}


def spread(gaps: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, list]:
    """Quantiles 0.5, 0.9 and the maximum of each gap over the images, for
    the earlier lines of a run's output."""
    out = {}
    for key in ("score", "top", "top_logit", "box"):
        v = torch.cat([g[key] for g in gaps]).float().cpu()
        out[key] = [float(x) for x in torch.quantile(v, torch.tensor([0.5, 0.9]))] \
            + [float(v.max())]
    return out
