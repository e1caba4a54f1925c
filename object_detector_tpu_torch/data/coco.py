"""COCO reader: instances_*.json -> ImageRecords (no pycocotools needed).

The port's own copy of ``object_detector_tpu/data/coco.py``.

Handles the 80-class detection set with the standard non-contiguous COCO
category ids remapped to contiguous labels 1..80.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from object_detector_tpu_torch.data.types import Dataset, ImageRecord


def load_coco(
    root: str,
    split: str = "val2017",
    annotation_file: str | None = None,
    include_crowd: bool = True,
) -> Dataset:
    """Crowd annotations are kept by default: pad_annotations filters them
    from training targets, and the COCO evaluator needs them as ignore
    regions (pycocotools protocol)."""
    ann_path = annotation_file or os.path.join(
        root, "annotations", f"instances_{split}.json"
    )
    with open(ann_path) as f:
        blob = json.load(f)

    categories = sorted(blob["categories"], key=lambda c: c["id"])
    cat_to_label: Dict[int, int] = {c["id"]: i + 1 for i, c in enumerate(categories)}
    class_names = [c["name"] for c in categories]

    anns_by_image = defaultdict(list)
    for ann in blob["annotations"]:
        if ann.get("iscrowd", 0) and not include_crowd:
            continue
        anns_by_image[ann["image_id"]].append(ann)

    records: List[ImageRecord] = []
    for img in blob["images"]:
        w, h = float(img["width"]), float(img["height"])
        boxes, labels, crowd = [], [], []
        for ann in anns_by_image.get(img["id"], ()):
            x, y, bw, bh = ann["bbox"]  # COCO xywh in pixels
            if bw <= 1 or bh <= 1:
                continue
            boxes.append(
                [
                    max(x / w, 0.0),
                    max(y / h, 0.0),
                    min((x + bw) / w, 1.0),
                    min((y + bh) / h, 1.0),
                ]
            )
            labels.append(cat_to_label[ann["category_id"]])
            crowd.append(bool(ann.get("iscrowd", 0)))
        records.append(
            ImageRecord(
                image_id=str(img["id"]),
                path=os.path.join(root, split, img["file_name"]),
                width=int(w),
                height=int(h),
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                difficult=np.zeros(len(labels), bool),
                crowd=np.asarray(crowd, bool),
            )
        )
    return Dataset(name=f"coco_{split}", class_names=class_names, records=records)
