"""The NMS numbers of the correctness check on hand-made detections."""

import pytest
import torch

from port_bench import check

EVAL = {"score_threshold": 0.01, "nms_iou_threshold": 0.45, "nms_max_per_class": 200,
        "max_detections": 200, "pre_nms_top_k": 400}
# One image, three anchors, two classes; the reference's scores a class.
REF_SCORES = torch.tensor([[[0.77, 0.0], [0.6, 0.0], [0.0, 0.5]]])
# The reference's detections: a box clipped to zero width at the image's
# left edge, a plain box, and one of the other class.
REF = (torch.tensor([[[0.0, 0.24, 0.0, 0.94], [0.3, 0.3, 0.6, 0.6], [0.5, 0.1, 0.9, 0.4]]]),
       torch.tensor([[0.77, 0.6, 0.5]]), torch.tensor([[0, 0, 1]]),
       torch.tensor([[True, True, True]]), torch.tensor([[0, 1, 2]]))


def _miss(rows):
    """``miss`` of the served (box, score, class, reference score) rows."""
    boxes = torch.tensor([[r[0] for r in rows]])
    scores = torch.tensor([[r[1] for r in rows]])
    classes = torch.tensor([[r[2] for r in rows]])
    served_ref = torch.tensor([[r[3] for r in rows]])
    valid = torch.ones_like(scores, dtype=torch.bool)
    gaps = check.nms_gaps((boxes, scores, classes, valid), served_ref, REF, REF_SCORES, EVAL)
    return float(gaps["miss"][0])


SERVED = [([0.0, 0.24, 0.0, 0.948], 0.79, 0, 0.77), ([0.3, 0.31, 0.6, 0.6], 0.59, 0, 0.6),
          ([0.5, 0.1, 0.9, 0.41], 0.52, 1, 0.5)]


def test_a_served_box_clipped_to_zero_width_covers_its_reference_detection():
    assert _miss(SERVED) == 0.0


@pytest.mark.parametrize("left_out, want", [(0, 0.77 - 0.01), (1, 0.6 - 0.01), (2, 0.5 - 0.01)])
def test_a_detection_left_out_is_a_miss(left_out, want):
    assert _miss([r for i, r in enumerate(SERVED) if i != left_out]) == pytest.approx(want, abs=1e-6)


def test_a_zero_width_box_elsewhere_or_of_another_class_covers_nothing():
    moved = ([0.2, 0.24, 0.2, 0.94], 0.79, 0, 0.77)
    other = ([0.0, 0.24, 0.0, 0.948], 0.79, 1, 0.0)
    assert _miss([moved] + SERVED[1:]) == pytest.approx(0.76, abs=1e-6)
    assert _miss([other] + SERVED[1:]) == pytest.approx(0.76, abs=1e-6)
