"""Synthetic dataset: deterministic, procedurally generated images and boxes.

The port's own copy of ``object_detector_tpu/data/synthetic.py`` (same
records and pixels from the same seed). Stands in for VOC/COCO where no real
dataset is at hand: tests, overfit runs and smoke runs use generated data.
Images contain solid rectangles on noise backgrounds whose positions are the
GT boxes, so a working detector can genuinely learn them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from object_detector_tpu_torch.data.types import Dataset, ImageRecord

SYNTH_CLASSES: Sequence[str] = ("square", "wide", "tall")


def make_synthetic_dataset(
    num_images: int = 64,
    image_size: int = 128,
    max_objects: int = 3,
    seed: int = 0,
    name: str = "synthetic",
) -> Dataset:
    rng = np.random.default_rng(seed)
    records: List[ImageRecord] = []
    for i in range(num_images):
        n = int(rng.integers(1, max_objects + 1))
        boxes, labels = [], []
        for _ in range(n):
            cls = int(rng.integers(0, len(SYNTH_CLASSES)))
            if cls == 0:  # square
                w = h = rng.uniform(0.15, 0.4)
            elif cls == 1:  # wide
                w, h = rng.uniform(0.3, 0.5), rng.uniform(0.1, 0.2)
            else:  # tall
                w, h = rng.uniform(0.1, 0.2), rng.uniform(0.3, 0.5)
            x1 = rng.uniform(0.0, 1.0 - w)
            y1 = rng.uniform(0.0, 1.0 - h)
            boxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(cls + 1)
        records.append(
            ImageRecord(
                image_id=f"synth_{i:05d}",
                path="",  # rendered on demand
                width=image_size,
                height=image_size,
                boxes=np.asarray(boxes, np.float32),
                labels=np.asarray(labels, np.int32),
                difficult=np.zeros(len(labels), bool),
            )
        )
    return Dataset(name=name, class_names=SYNTH_CLASSES, records=records)


def render_synthetic_image(record: ImageRecord, image_size: int | None = None) -> np.ndarray:
    """Render a record to (S, S, 3) uint8. Deterministic per image_id
    (crc32, NOT builtin hash() — that one is salted per process)."""
    import zlib

    s = image_size or record.width
    seed = zlib.crc32(record.image_id.encode()) % (2**32)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, (s, s, 3), dtype=np.uint8)
    palette = np.array(
        [[220, 60, 60], [60, 220, 60], [60, 60, 220]], dtype=np.uint8
    )
    for box, label in zip(record.boxes, record.labels):
        x1, y1, x2, y2 = (box * s).astype(int)
        color = palette[(label - 1) % len(palette)]
        img[max(y1, 0) : max(y2, 1), max(x1, 0) : max(x2, 1)] = color
    return img
