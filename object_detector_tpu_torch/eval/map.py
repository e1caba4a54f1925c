"""mAP evaluators — VOC07 (11-point), VOC10 (continuous), COCO protocol.

The port's own copy of ``object_detector_tpu/eval/map.py`` (numpy only; the
port imports nothing of the reference). Host-side numpy reduce over
accumulated detections: the inference sweep is the hot loop; this reduce is
cheap. Detections arrive as normalized corner boxes + scores + 0-based class
ids per image.

The "coco" style implements the pycocotools evaluation protocol (pycocotools
is not a dependency; tests/test_map.py holds hand-computed oracles, and
tests/test_torch_map.py holds this copy equal to the original): 10 IoU
thresholds .5:.05:.95,
101-point recall interpolation, area ranges (all/small/medium/large in
pixel², hence add_image takes the original image size), maxDets tiers
[1, 10, 100], and crowd-region ignore matching (crowd IoU = intersection
over detection area; crowd GT can absorb multiple detections; detections
matched to ignored GT are neither TP nor FP).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Mapping, Tuple

import numpy as np

COCO_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
COCO_RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
COCO_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_single(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    if len(others) == 0:
        return np.zeros((0,), np.float64)
    xx1 = np.maximum(box[0], others[:, 0])
    yy1 = np.maximum(box[1], others[:, 1])
    xx2 = np.minimum(box[2], others[:, 2])
    yy2 = np.minimum(box[3], others[:, 3])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (others[:, 2] - others[:, 0]) * (others[:, 3] - others[:, 1])
    union = a + b - inter
    return np.where(union > 0, inter / union, 0.0)


def _average_precision(recall: np.ndarray, precision: np.ndarray, style: str) -> float:
    if style == "voc07":
        # 11-point interpolation (VOC2007 devkit convention).
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    # Continuous: area under the monotone precision envelope.
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _class_ap(
    detections: List[Tuple[str, float, np.ndarray]],  # (image_id, score, box)
    gts: Mapping[str, np.ndarray],  # image_id -> (G, 4)
    gt_difficult: Mapping[str, np.ndarray],  # image_id -> (G,) bool
    iou_threshold: float,
    style: str,
) -> float | None:
    npos = sum(int((~d).sum()) for d in gt_difficult.values())
    if npos == 0:
        return None  # class absent from this split
    detections = sorted(detections, key=lambda d: -d[1])
    matched: Dict[str, np.ndarray] = {
        k: np.zeros(len(v), bool) for k, v in gts.items()
    }
    tp = np.zeros(len(detections))
    fp = np.zeros(len(detections))
    for i, (img_id, _, box) in enumerate(detections):
        gt_boxes = gts.get(img_id, np.zeros((0, 4)))
        ious = _iou_single(box, gt_boxes)
        j = int(np.argmax(ious)) if len(ious) else -1
        if j >= 0 and ious[j] >= iou_threshold:
            if gt_difficult[img_id][j]:
                continue  # VOC: difficult GT neither TP nor FP
            if not matched[img_id][j]:
                matched[img_id][j] = True
                tp[i] = 1
            else:
                fp[i] = 1  # duplicate detection
        else:
            fp[i] = 1
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / npos
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return _average_precision(recall, precision, style)


# ---------------------------------------------------------------------------
# COCO protocol
# ---------------------------------------------------------------------------

def _coco_iou_matrix(
    det_boxes: np.ndarray,  # (D, 4) pixel corner
    gt_boxes: np.ndarray,  # (G, 4) pixel corner
    gt_crowd: np.ndarray,  # (G,) bool
) -> np.ndarray:
    """(D, G) IoU; for crowd GT, IoU = intersection / detection area
    (pycocotools iscrowd convention — a detection inside a crowd region
    counts as covered regardless of the region's size)."""
    d, g = len(det_boxes), len(gt_boxes)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    xx1 = np.maximum(det_boxes[:, None, 0], gt_boxes[None, :, 0])
    yy1 = np.maximum(det_boxes[:, None, 1], gt_boxes[None, :, 1])
    xx2 = np.minimum(det_boxes[:, None, 2], gt_boxes[None, :, 2])
    yy2 = np.minimum(det_boxes[:, None, 3], gt_boxes[None, :, 3])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    det_area = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    denom = np.where(
        gt_crowd[None, :], det_area[:, None], det_area[:, None] + gt_area[None, :] - inter
    )
    return np.where(denom > 0, inter / denom, 0.0)


def _coco_match_image(
    ious: np.ndarray,  # (D, G) dets score-sorted, gts ignore-sorted
    gt_ignore: np.ndarray,  # (G,) bool, sorted so non-ignored first
    gt_crowd: np.ndarray,  # (G,) bool, same order
    det_areas: np.ndarray,  # (D,) pixel areas
    area_range: Tuple[float, float],
    thresholds: np.ndarray,  # (T,)
) -> Tuple[np.ndarray, np.ndarray]:
    """pycocotools evaluateImg matching. Returns (det_matched, det_ignored)
    of shape (T, D)."""
    num_d, num_g = ious.shape
    num_t = len(thresholds)
    dtm = np.zeros((num_t, num_d), bool)
    dt_ig = np.zeros((num_t, num_d), bool)
    gtm = np.zeros((num_t, num_g), bool)
    for ti, t in enumerate(thresholds):
        for di in range(num_d):
            best_iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(num_g):
                # Already-claimed non-crowd GT can't match again; crowd can.
                if gtm[ti, gi] and not gt_crowd[gi]:
                    continue
                # GTs are sorted non-ignored first: once we hold a
                # non-ignored match, ignored candidates can't improve it.
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = True
            dt_ig[ti, di] = gt_ignore[m]
            gtm[ti, m] = True
    # Unmatched detections outside the area range are ignored, not FP.
    outside = (det_areas < area_range[0]) | (det_areas > area_range[1])
    dt_ig |= (~dtm) & outside[None, :]
    return dtm, dt_ig


def _interp_precision_101(
    scores: np.ndarray, tp: np.ndarray, fp: np.ndarray, npos: int
) -> Tuple[np.ndarray, float]:
    """Global score sort -> 101-point interpolated precision + max recall."""
    order = np.argsort(-scores, kind="mergesort")
    tp_cum = np.cumsum(tp[order])
    fp_cum = np.cumsum(fp[order])
    if len(tp_cum) == 0 or npos == 0:
        return np.zeros(101), 0.0
    rc = tp_cum / npos
    pr = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    # Monotone precision envelope from the right (pycocotools accumulate).
    pr = np.maximum.accumulate(pr[::-1])[::-1]
    inds = np.searchsorted(rc, COCO_RECALL_THRESHOLDS, side="left")
    q = np.zeros(101)
    valid = inds < len(pr)
    q[valid] = pr[inds[valid]]
    return q, float(rc[-1])


class MeanAPEvaluator:
    """Accumulate per-image detections + GT; compute (m)AP at the end.

    add_image(image_id, det_boxes, det_scores, det_classes,
              gt_boxes, gt_labels, gt_difficult, gt_crowd, image_size)
    with 0-based det classes and 1-based gt labels (matching the data layer
    convention). Boxes are normalized; `image_size` (width, height) converts
    them to pixel areas for the COCO small/medium/large ranges. `gt_crowd`
    marks COCO crowd regions (ignored, absorb multiple detections);
    `gt_difficult` marks VOC difficult boxes (ignored in both protocols).
    """

    def __init__(self, num_classes: int, style: str = "voc07"):
        self.num_classes = num_classes
        self.style = style
        self._dets: Dict[int, List[Tuple[str, float, np.ndarray]]] = defaultdict(list)
        self._gts: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
        self._diff: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
        self._crowd: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
        self._sizes: Dict[str, Tuple[float, float]] = {}
        self._images: set = set()

    def add_image(
        self,
        image_id: str,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_difficult: np.ndarray | None = None,
        gt_crowd: np.ndarray | None = None,
        image_size: Tuple[float, float] | None = None,
    ) -> None:
        if image_id in self._images:
            raise ValueError(f"duplicate image_id {image_id}")
        self._images.add(image_id)
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_labels), bool)
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_labels), bool)
        self._sizes[image_id] = image_size or (1.0, 1.0)
        for c in range(self.num_classes):
            sel = det_classes == c
            for score, box in zip(det_scores[sel], det_boxes[sel]):
                self._dets[c].append((image_id, float(score), np.asarray(box)))
            gsel = gt_labels == (c + 1)
            self._gts[c][image_id] = np.asarray(gt_boxes)[gsel]
            self._diff[c][image_id] = np.asarray(gt_difficult)[gsel]
            self._crowd[c][image_id] = np.asarray(gt_crowd)[gsel]

    def result(self, iou_threshold: float = 0.5) -> Dict[str, float]:
        if self.style == "coco":
            return self._coco_result()
        aps = []
        per_class = {}
        for c in range(self.num_classes):
            # VOC protocols have no crowd concept; treat COCO crowd regions
            # like difficult boxes (ignored: not counted in npos, matches
            # don't score) rather than as ordinary GT, which would deflate
            # mAP when evaluating COCO data with a VOC style.
            ignore = {
                img_id: diff | self._crowd[c][img_id]
                for img_id, diff in self._diff[c].items()
            }
            ap = _class_ap(
                self._dets[c], self._gts[c], ignore, iou_threshold, self.style
            )
            if ap is not None:
                aps.append(ap)
                per_class[f"ap/class_{c}"] = ap
        out = {"mAP": float(np.mean(aps)) if aps else 0.0}
        out.update(per_class)
        return out

    # -- COCO ---------------------------------------------------------------

    def _class_image_data(self, c: int):
        """Per-image pixel-space det/GT arrays for class c, pre-sorted
        (dets by score desc, GTs non-ignored first)."""
        per_image: Dict[str, dict] = {}
        dets_by_image: Dict[str, list] = defaultdict(list)
        for img_id, score, box in self._dets[c]:
            dets_by_image[img_id].append((score, box))
        image_ids = set(dets_by_image) | set(self._gts[c])
        for img_id in image_ids:
            w, h = self._sizes.get(img_id, (1.0, 1.0))
            scale = np.array([w, h, w, h], np.float64)
            det_list = sorted(dets_by_image.get(img_id, ()), key=lambda d: -d[0])
            det_scores = np.array([s for s, _ in det_list], np.float64)
            det_boxes = (
                np.stack([b for _, b in det_list]).astype(np.float64) * scale
                if det_list else np.zeros((0, 4))
            )
            gt_boxes = np.asarray(self._gts[c].get(img_id, np.zeros((0, 4)))) * scale
            ignore_base = np.asarray(
                self._diff[c].get(img_id, np.zeros(0, bool)), bool
            ) | np.asarray(self._crowd[c].get(img_id, np.zeros(0, bool)), bool)
            crowd = np.asarray(self._crowd[c].get(img_id, np.zeros(0, bool)), bool)
            gt_areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
            det_areas = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
            per_image[img_id] = dict(
                det_scores=det_scores, det_boxes=det_boxes, det_areas=det_areas,
                gt_boxes=gt_boxes, gt_areas=gt_areas,
                ignore_base=ignore_base, crowd=crowd,
            )
        return per_image

    def _coco_class_eval(
        self, per_image: Mapping[str, dict], area_range: Tuple[float, float],
        max_dets: int,
    ) -> Tuple[np.ndarray, np.ndarray] | None:
        """One (class, areaRange, maxDets) cell: returns (ap[T], ar[T]) over
        the 10 IoU thresholds, or None when the class/range has no GT."""
        num_t = len(COCO_IOU_THRESHOLDS)
        all_scores, all_tp, all_fp = [], [], []
        npos = 0
        for data in per_image.values():
            gt_ignore = data["ignore_base"] | (
                (data["gt_areas"] < area_range[0]) | (data["gt_areas"] > area_range[1])
            )
            # Sort GT: non-ignored first (stable), matching pycocotools.
            order = np.argsort(gt_ignore, kind="mergesort")
            gt_boxes = data["gt_boxes"][order]
            gt_ignore_s = gt_ignore[order]
            gt_crowd_s = data["crowd"][order]
            npos += int((~gt_ignore_s).sum())

            det_boxes = data["det_boxes"][:max_dets]
            det_scores = data["det_scores"][:max_dets]
            det_areas = data["det_areas"][:max_dets]
            if len(det_boxes) == 0:
                continue
            ious = _coco_iou_matrix(det_boxes, gt_boxes, gt_crowd_s)
            dtm, dt_ig = _coco_match_image(
                ious, gt_ignore_s, gt_crowd_s, det_areas, area_range,
                COCO_IOU_THRESHOLDS,
            )
            all_scores.append(det_scores)
            all_tp.append(dtm & ~dt_ig)
            all_fp.append(~dtm & ~dt_ig)
        if npos == 0:
            return None
        if all_scores:
            scores = np.concatenate(all_scores)
            tp = np.concatenate(all_tp, axis=1)
            fp = np.concatenate(all_fp, axis=1)
        else:
            scores = np.zeros(0)
            tp = fp = np.zeros((num_t, 0), bool)
        ap = np.zeros(num_t)
        ar = np.zeros(num_t)
        for ti in range(num_t):
            q, max_rc = _interp_precision_101(scores, tp[ti], fp[ti], npos)
            ap[ti] = q.mean()
            ar[ti] = max_rc
        return ap, ar

    def _coco_result(self) -> Dict[str, float]:
        num_t = len(COCO_IOU_THRESHOLDS)

        def mean_or_zero(cells: list) -> np.ndarray:
            return np.mean(cells, axis=0) if cells else np.zeros(num_t)

        ap_cells: Dict[str, list] = {k: [] for k in COCO_AREA_RANGES}
        ar_cells: Dict[int, list] = {1: [], 10: [], 100: []}
        for c in range(self.num_classes):
            per_image = self._class_image_data(c)
            if not per_image:
                continue
            for range_name, area_range in COCO_AREA_RANGES.items():
                cell = self._coco_class_eval(per_image, area_range, 100)
                if cell is None:
                    continue
                ap_cells[range_name].append(cell[0])
                if range_name == "all":
                    ar_cells[100].append(cell[1])
            for md in (1, 10):
                cell = self._coco_class_eval(per_image, COCO_AREA_RANGES["all"], md)
                if cell is not None:
                    ar_cells[md].append(cell[1])

        ap_all = mean_or_zero(ap_cells["all"])
        return {
            "mAP": float(ap_all.mean()),
            "AP50": float(ap_all[0]),
            "AP75": float(ap_all[5]),
            "APs": float(mean_or_zero(ap_cells["small"]).mean()),
            "APm": float(mean_or_zero(ap_cells["medium"]).mean()),
            "APl": float(mean_or_zero(ap_cells["large"]).mean()),
            "AR1": float(mean_or_zero(ar_cells[1]).mean()),
            "AR10": float(mean_or_zero(ar_cells[10]).mean()),
            "AR100": float(mean_or_zero(ar_cells[100]).mean()),
        }
