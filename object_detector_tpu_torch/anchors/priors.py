"""Prior-box (anchor) generation, numpy.

The port's copy of ``object_detector_tpu/anchors/priors.py``: center form
(cx, cy, w, h), normalized to [0, 1], level-major in the order the heads
flatten their outputs. `ssd_anchors` follows the SSD paper's scheme,
`retinanet_anchors` puts 3 octave scales x 3 aspect ratios on FPN P3..P7.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from object_detector_tpu_torch.core.config import AnchorConfig


def _level_anchor_shapes_ssd(
    min_size: float, max_size: float, aspect_ratios: Sequence[float], image_size: float
) -> np.ndarray:
    """Per-location (w, h) list for one SSD level, normalized."""
    s = min_size / image_size
    s_prime = float(np.sqrt(min_size * max_size)) / image_size
    shapes = [(s, s), (s_prime, s_prime)]
    for r in aspect_ratios:
        rt = float(np.sqrt(r))
        shapes.append((s * rt, s / rt))
        shapes.append((s / rt, s * rt))
    return np.asarray(shapes, dtype=np.float32)  # (A, 2)


def _tile_anchors(feature_size: int, shapes: np.ndarray) -> np.ndarray:
    """Tile per-location shapes over a feature map -> (f*f*A, 4) center form."""
    f = feature_size
    steps = (np.arange(f, dtype=np.float32) + 0.5) / f
    cx, cy = np.meshgrid(steps, steps)  # (f, f), cx varies along axis 1
    centers = np.stack([cx, cy], axis=-1).reshape(f * f, 1, 2)
    centers = np.broadcast_to(centers, (f * f, shapes.shape[0], 2))
    wh = np.broadcast_to(shapes[None, :, :], (f * f, shapes.shape[0], 2))
    return np.concatenate([centers, wh], axis=-1).reshape(-1, 4)


def ssd_anchors(cfg: AnchorConfig, image_size: int) -> np.ndarray:
    """All-level SSD anchors -> (num_anchors, 4) float32 center form.

    The canonical SSD-300 config yields 8732 anchors.
    """
    out: List[np.ndarray] = []
    for f, (mn, mx), ratios in zip(cfg.feature_sizes, cfg.sizes, cfg.aspect_ratios):
        shapes = _level_anchor_shapes_ssd(mn, mx, ratios, float(image_size))
        out.append(_tile_anchors(f, shapes))
    anchors = np.concatenate(out, axis=0)
    if cfg.clip:
        # Clipping center-form w/h to <= 1 (centers stay in (0, 1)).
        anchors[:, 2:] = np.minimum(anchors[:, 2:], 1.0)
    return anchors.astype(np.float32)


def retinanet_anchors(
    image_size: int,
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    anchor_scale: float = 4.0,
    octave_scales: Sequence[float] = (2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3)),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """RetinaNet anchors on P3..P7 -> (N, 4) center form, 9 per location
    (49104 at 512 px)."""
    out: List[np.ndarray] = []
    for stride in strides:
        f = max(1, image_size // stride)
        base = anchor_scale * stride / image_size
        shapes = []
        for octave in octave_scales:
            for r in aspect_ratios:
                rt = float(np.sqrt(r))
                shapes.append((base * octave * rt, base * octave / rt))
        out.append(_tile_anchors(f, np.asarray(shapes, dtype=np.float32)))
    return np.concatenate(out, axis=0).astype(np.float32)


def anchors_for_model(model_family: str, cfg: AnchorConfig, image_size: int) -> np.ndarray:
    if model_family == "retinanet":
        return retinanet_anchors(image_size)
    return ssd_anchors(cfg, image_size)


def level_slices(cfg: AnchorConfig) -> List[Tuple[int, int]]:
    """(start, end) anchor index range per pyramid level."""
    out = []
    start = 0
    for f, a in zip(cfg.feature_sizes, cfg.anchors_per_level):
        n = f * f * a
        out.append((start, start + n))
        start += n
    return out
