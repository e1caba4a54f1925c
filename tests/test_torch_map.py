"""The port's copy of the mAP evaluator (`eval.map`) against the original:
every case of tests/test_map.py and seeded random detections in all three
styles, with difficult and crowd boxes. Tolerance: 1e-12 absolute on every
key (the same numpy arithmetic on the same inputs)."""

import numpy as np
import pytest

from object_detector_tpu.eval import map as ref_map
from object_detector_tpu_torch.eval import map as port_map

SIZE = (100.0, 100.0)
GT2 = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.8, 0.8]], np.float32)
SMALL2 = np.array([[0.0, 0.0, 0.1, 0.1], [0.5, 0.5, 0.6, 0.6]], np.float32)
CROWD_GT = np.array([[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 0.8, 0.8]], np.float32)
CROWD_DETS = np.array([[0.1, 0.1, 0.2, 0.2], [0.3, 0.3, 0.45, 0.45], [0.6, 0.6, 0.8, 0.8]],
                      np.float32)


def _one(boxes):
    return np.array(boxes, np.float32)


# (num_classes, style, [add_image positional args + keyword args]) for each
# case of tests/test_map.py, in its order.
CASES = {
    "perfect_voc07": (2, "voc07", [((
        "a", _one([[0.1, 0.1, 0.4, 0.4]]), np.array([0.9]), np.array([0]),
        _one([[0.1, 0.1, 0.4, 0.4]]), np.array([1])), {})]),
    "missed_voc07": (1, "voc07", [((
        "a", _one([[0.6, 0.6, 0.9, 0.9]]), np.array([0.9]), np.array([0]),
        _one([[0.1, 0.1, 0.4, 0.4]]), np.array([1])), {})]),
    "duplicates_voc10": (1, "voc10", [((
        "a", np.tile(_one([[0.1, 0.1, 0.4, 0.4]]), (2, 1)), np.array([0.9, 0.8]),
        np.array([0, 0]), _one([[0.1, 0.1, 0.4, 0.4]]), np.array([1])), {})]),
    "half_recall_voc07": (1, "voc07", [((
        "a", GT2[:1], np.array([0.9]), np.array([0]), GT2, np.array([1, 1])), {})]),
    "difficult_voc07": (1, "voc07", [((
        "a", GT2[:1], np.array([0.9]), np.array([0]), GT2, np.array([1, 1]),
        np.array([False, True])), {})]),
    **{f"crowd_{style}": (1, style, [((
        "a", _one([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]), np.array([0.9, 0.8]),
        np.array([0, 0]), _one([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]),
        np.array([1, 1])), {"gt_crowd": np.array([False, True])})]) for style in ("voc07", "voc10")},
    "coco_runs": (1, "coco", [((
        "a", _one([[0.1, 0.1, 0.4, 0.4]]), np.array([0.9]), np.array([0]),
        _one([[0.1, 0.1, 0.4, 0.4]]), np.array([1])), {})]),
    "coco_graded_thresholds": (1, "coco", [((
        "a", _one([[0.0, 0.0, 0.1, 0.072]]), np.array([0.9]), np.array([0]),
        _one([[0.0, 0.0, 0.1, 0.1]]), np.array([1])), {"image_size": SIZE})]),
    "coco_101_point": (1, "coco", [((
        "a", _one([[0.0, 0.0, 0.1, 0.1], [0.8, 0.8, 0.9, 0.9]]), np.array([0.9, 0.8]),
        np.array([0, 0]), SMALL2, np.array([1, 1])), {"image_size": SIZE})]),
    "coco_ar_tiers": (1, "coco", [((
        "a", SMALL2, np.array([0.9, 0.8]), np.array([0, 0]), SMALL2, np.array([1, 1])),
        {"image_size": SIZE})]),
    "coco_crowd_absorbs": (1, "coco", [((
        "a", CROWD_DETS, np.array([0.95, 0.9, 0.8]), np.array([0, 0, 0]), CROWD_GT,
        np.array([1, 1])), {"gt_crowd": np.array([True, False]), "image_size": SIZE})]),
    "coco_without_crowd": (1, "coco", [((
        "a", CROWD_DETS, np.array([0.95, 0.9, 0.8]), np.array([0, 0, 0]), CROWD_GT,
        np.array([1, 1])), {"image_size": SIZE})]),
    "coco_area_ranges": (1, "coco", [((
        "a", _one([[0.0, 0.0, 0.1, 0.1], [0.01, 0.01, 0.98, 0.98]]), np.array([0.9, 0.8]),
        np.array([0, 0]), _one([[0.0, 0.0, 0.1, 0.1], [0.01, 0.01, 0.98, 0.98]]),
        np.array([1, 1])), {"image_size": SIZE})]),
    "coco_difficult": (1, "coco", [((
        "a", SMALL2[:1], np.array([0.9]), np.array([0]), SMALL2, np.array([1, 1])),
        {"gt_difficult": np.array([False, True]), "image_size": SIZE})]),
}


def _results(num_classes, style, images):
    out = []
    for mod in (port_map, ref_map):
        ev = mod.MeanAPEvaluator(num_classes=num_classes, style=style)
        for args, kwargs in images:
            ev.add_image(*args, **kwargs)
        out.append(ev.result())
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert isinstance(got[key], float)
        assert abs(got[key] - value) <= 1e-12, (key, got[key], value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_of_test_map_match_the_reference(name):
    got, want = _results(*CASES[name])
    _assert_same(got, want)


def test_average_precision_matches_the_reference():
    rng = np.random.default_rng(0)
    recall = np.sort(rng.random(40))
    precision = rng.random(40)
    for style in ("voc07", "voc10", "coco"):
        for r, p in ((np.array([0.5]), np.array([1.0])), (recall, precision)):
            assert port_map._average_precision(r, p, style) == \
                ref_map._average_precision(r, p, style)
    assert abs(port_map._average_precision(np.array([0.5]), np.array([1.0]), "voc07") - 6 / 11) \
        < 1e-9


def _random_images(seed, num_classes, n_images):
    """Per image: GT boxes (some difficult, some crowd), and detections
    jittered from them plus random false positives, with tied scores."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(n_images):
        g = int(rng.integers(0, 6))
        xy = rng.uniform(0, 0.7, (g, 2))
        wh = rng.uniform(0.02, 0.3, (g, 2))
        gt = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
        labels = rng.integers(1, num_classes + 1, g)
        difficult = rng.random(g) < 0.15
        crowd = rng.random(g) < 0.15
        dets = gt + rng.normal(0, 0.02, gt.shape).astype(np.float32)
        extra = int(rng.integers(0, 5))
        fxy = rng.uniform(0, 0.8, (extra, 2))
        fp = np.concatenate([fxy, fxy + rng.uniform(0.02, 0.2, (extra, 2))], axis=1)
        boxes = np.concatenate([dets, fp.astype(np.float32)]).astype(np.float32)
        classes = np.concatenate([labels - 1, rng.integers(0, num_classes, extra)])
        scores = np.round(rng.random(len(boxes)), 1)  # ties
        size = (float(rng.integers(50, 700)), float(rng.integers(50, 700)))
        images.append(((f"img{i}", boxes, scores, classes, gt, labels, difficult),
                       {"gt_crowd": crowd, "image_size": size}))
    return images


@pytest.mark.parametrize("style", ["voc07", "voc10", "coco"])
@pytest.mark.parametrize("seed", [1, 2])
def test_random_detections_match_the_reference(style, seed):
    got, want = _results(4, style, _random_images(seed, 4, 30))
    _assert_same(got, want)
    assert 0.0 < want["mAP"] < 1.0


def test_duplicate_image_id_is_refused():
    ev = port_map.MeanAPEvaluator(num_classes=1)
    args = ("a", SMALL2, np.array([0.9, 0.8]), np.array([0, 0]), SMALL2, np.array([1, 1]))
    ev.add_image(*args)
    with pytest.raises(ValueError, match="duplicate image_id a"):
        ev.add_image(*args)
