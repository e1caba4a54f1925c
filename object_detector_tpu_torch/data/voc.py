"""PASCAL VOC reader: Annotations/*.xml + ImageSets splits -> ImageRecords.

The port's own copy of ``object_detector_tpu/data/voc.py``. Pure-host
parsing; expects the standard VOCdevkit layout:

    <root>/VOC2007/Annotations/<id>.xml
    <root>/VOC2007/JPEGImages/<id>.jpg
    <root>/VOC2007/ImageSets/Main/<split>.txt
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence

import numpy as np

from object_detector_tpu_torch.data.types import Dataset, ImageRecord

VOC_CLASSES: Sequence[str] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

_CLASS_TO_LABEL = {name: i + 1 for i, name in enumerate(VOC_CLASSES)}


def parse_voc_xml(xml_path: str) -> ImageRecord:
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = int(size.findtext("width"))
    height = int(size.findtext("height"))
    boxes: List[List[float]] = []
    labels: List[int] = []
    difficult: List[bool] = []
    for obj in root.iter("object"):
        name = obj.findtext("name")
        if name not in _CLASS_TO_LABEL:
            continue
        bnd = obj.find("bndbox")
        # VOC pixel coords are 1-based inclusive.
        x1 = (float(bnd.findtext("xmin")) - 1.0) / width
        y1 = (float(bnd.findtext("ymin")) - 1.0) / height
        x2 = (float(bnd.findtext("xmax")) - 1.0) / width
        y2 = (float(bnd.findtext("ymax")) - 1.0) / height
        boxes.append([max(x1, 0.0), max(y1, 0.0), min(x2, 1.0), min(y2, 1.0)])
        labels.append(_CLASS_TO_LABEL[name])
        difficult.append(obj.findtext("difficult", "0") == "1")
    image_id = os.path.splitext(os.path.basename(xml_path))[0]
    return ImageRecord(
        image_id=image_id,
        path="",
        width=width,
        height=height,
        boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
        labels=np.asarray(labels, np.int32),
        difficult=np.asarray(difficult, bool),
    )


def load_voc(
    root: str,
    split: str = "trainval",
    years: Sequence[str] = ("2007",),
    keep_difficult: bool = True,
) -> Dataset:
    records: List[ImageRecord] = []
    for year in years:
        base = os.path.join(root, f"VOC{year}")
        split_file = os.path.join(base, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            ids = [line.strip().split()[0] for line in f if line.strip()]
        for image_id in ids:
            rec = parse_voc_xml(os.path.join(base, "Annotations", f"{image_id}.xml"))
            rec.path = os.path.join(base, "JPEGImages", f"{image_id}.jpg")
            if not keep_difficult and rec.difficult.any():
                keep = ~rec.difficult
                rec.boxes = rec.boxes[keep]
                rec.labels = rec.labels[keep]
                rec.difficult = rec.difficult[keep]
            records.append(rec)
    return Dataset(name=f"voc_{'+'.join(years)}_{split}", class_names=VOC_CLASSES, records=records)
