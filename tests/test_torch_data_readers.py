"""The port's VOC and COCO readers (`data.voc`, `data.coco`) against the
originals, on files written into ``tmp_path``: every record field equal,
boxes bit for bit."""

import json
import os

import numpy as np
import pytest

from object_detector_tpu.data import coco as ref_coco
from object_detector_tpu.data import voc as ref_voc
from object_detector_tpu_torch.data import coco, voc
from object_detector_tpu_torch.data.types import pad_annotations

VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  <object>
    <name>dog</name><difficult>0</difficult>
    <bndbox><xmin>41</xmin><ymin>21</ymin><xmax>201</xmax><ymax>101</ymax></bndbox>
  </object>
  <object>
    <name>person</name><difficult>1</difficult>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>{w}</xmax><ymax>{h}</ymax></bndbox>
  </object>
  <object>
    <name>notaclass</name>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>10</xmax><ymax>10</ymax></bndbox>
  </object>
  <object>
    <name>cat</name>
    <bndbox><xmin>0</xmin><ymin>3</ymin><xmax>{w2}</xmax><ymax>77</ymax></bndbox>
  </object>
</annotation>
"""


def _assert_same_records(got, want):
    assert got.name == want.name and list(got.class_names) == list(want.class_names)
    assert len(got) == len(want)
    for g, w in zip(got.records, want.records):
        assert (g.image_id, g.path, g.width, g.height) == (w.image_id, w.path, w.width, w.height)
        for field in ("boxes", "labels", "difficult"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)
        assert (g.crowd is None) == (w.crowd is None)
        np.testing.assert_array_equal(g.crowd_mask, w.crowd_mask)


def _voc_tree(root, n=4):
    base = root / "VOC2007"
    (base / "Annotations").mkdir(parents=True)
    (base / "ImageSets" / "Main").mkdir(parents=True)
    for i in range(n):
        xml = VOC_XML.format(w=400 + 10 * i, h=200 + 5 * i, w2=450 + 10 * i)  # cat's xmax past the edge
        (base / "Annotations" / f"{i:06d}.xml").write_text(xml)
    (base / "ImageSets" / "Main" / "train.txt").write_text("000000\n000002 1\n\n000003\n")
    return base


def test_parse_voc_xml_matches_the_reference(tmp_path):
    base = _voc_tree(tmp_path, n=1)
    path = str(base / "Annotations" / "000000.xml")
    got, want = voc.parse_voc_xml(path), ref_voc.parse_voc_xml(path)
    _assert_same_records(voc.Dataset("x", voc.VOC_CLASSES, [got]),
                         ref_voc.Dataset("x", ref_voc.VOC_CLASSES, [want]))
    assert len(got.boxes) == 3 and got.difficult.tolist() == [False, True, False]
    assert got.boxes[2, 2] == 1.0  # clipped to the image


@pytest.mark.parametrize("keep_difficult", [True, False])
def test_load_voc_matches_the_reference(tmp_path, keep_difficult):
    _voc_tree(tmp_path)
    got = voc.load_voc(str(tmp_path), "train", keep_difficult=keep_difficult)
    want = ref_voc.load_voc(str(tmp_path), "train", keep_difficult=keep_difficult)
    _assert_same_records(got, want)
    assert [r.image_id for r in got.records] == ["000000", "000002", "000003"]
    assert got.records[0].path.endswith(os.path.join("JPEGImages", "000000.jpg"))
    assert len(got.records[0].boxes) == (3 if keep_difficult else 2)
    assert list(got.class_names) == list(voc.VOC_CLASSES) and got.num_classes == 20


def _coco_blob():
    return {
        "images": [
            {"id": 7, "width": 100, "height": 50, "file_name": "a.jpg"},
            {"id": 8, "width": 100, "height": 50, "file_name": "b.jpg"},
            {"id": 9, "width": 640, "height": 480, "file_name": "c.jpg"},
        ],
        "annotations": [
            {"image_id": 7, "category_id": 18, "bbox": [10, 5, 20, 10], "iscrowd": 0},
            {"image_id": 7, "category_id": 44, "bbox": [0, 0, 50, 25], "iscrowd": 1},
            {"image_id": 8, "category_id": 44, "bbox": [1, 1, 0.5, 10], "iscrowd": 0},
            {"image_id": 9, "category_id": 3, "bbox": [600, 400, 100, 100]},
            {"image_id": 9, "category_id": 18, "bbox": [-5, 2, 30, 40], "iscrowd": 0},
        ],
        "categories": [{"id": 44, "name": "bottle"}, {"id": 18, "name": "dog"},
                       {"id": 3, "name": "car"}],
    }


@pytest.mark.parametrize("include_crowd", [True, False])
@pytest.mark.parametrize("explicit_file", [False, True])
def test_load_coco_matches_the_reference(tmp_path, include_crowd, explicit_file):
    ann_dir = tmp_path / "annotations"
    ann_dir.mkdir()
    ann = ann_dir / "instances_val.json"
    ann.write_text(json.dumps(_coco_blob()))
    kw = {"include_crowd": include_crowd}
    if explicit_file:
        kw["annotation_file"] = str(ann)
    got, want = coco.load_coco(str(tmp_path), "val", **kw), ref_coco.load_coco(str(tmp_path), "val", **kw)
    _assert_same_records(got, want)
    assert got.class_names == ["car", "dog", "bottle"]  # sorted by category id
    rec7 = got.records[0]
    assert rec7.crowd_mask.tolist() == ([False, True] if include_crowd else [False])
    boxes, labels, valid = pad_annotations(rec7, max_boxes=4)
    assert valid.sum() == 1 and labels[0] == 2  # crowd never a training target
    assert len(got.records[1].boxes) == 0  # degenerate bbox dropped
