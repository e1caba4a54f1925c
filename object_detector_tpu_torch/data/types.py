"""Dataset record types shared by the dataset readers (the port's own copy
of ``object_detector_tpu/data/types.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    """One annotated image. Boxes are normalized corner (x1,y1,x2,y2);
    labels are 1-based foreground class ids (0 reserved for background)."""

    image_id: str
    path: str
    width: int
    height: int
    boxes: np.ndarray  # (M, 4) float32
    labels: np.ndarray  # (M,) int32, 1..C
    difficult: np.ndarray  # (M,) bool (VOC); all-False for COCO
    # COCO crowd regions: ignored by training targets and matched as
    # ignore-regions by the COCO evaluator. None == no crowd boxes.
    crowd: Optional[np.ndarray] = None  # (M,) bool

    @property
    def crowd_mask(self) -> np.ndarray:
        if self.crowd is None:
            return np.zeros(len(self.labels), bool)
        return self.crowd


@dataclasses.dataclass
class Dataset:
    name: str
    class_names: Sequence[str]  # foreground classes, index 0 -> label 1
    records: List[ImageRecord]

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.records)


def pad_annotations(
    record: ImageRecord, max_boxes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (boxes, labels, valid) to static max_boxes (truncating overflow).

    Crowd regions never become training targets — they exist only for the
    evaluator's ignore matching."""
    keep = ~record.crowd_mask
    rec_boxes = record.boxes[keep]
    rec_labels = record.labels[keep]
    boxes = np.zeros((max_boxes, 4), np.float32)
    labels = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    m = min(len(rec_boxes), max_boxes)
    if m:
        boxes[:m] = rec_boxes[:m]
        labels[:m] = rec_labels[:m]
        valid[:m] = True
    return boxes, labels, valid
