"""Batched inference: uint8 images -> detections, and the sweep -> mAP.

The port of ``object_detector_tpu/eval/evaluator.py``: ``make_predict_fn``
(:19, the float serving path), ``make_int8_predict_fn`` (:33, the int8 PTQ
serving path: SSD on VGG16 or ResNet-50, and RetinaNet/FPN) and
``evaluate_dataset`` (:79, the val sweep into `MeanAPEvaluator`).

Both predict functions also serve the port's DETR families, which the
reference lacks (``family="detr"`` and ``"deformable_detr"``):
``predict(images_u8, extents)`` on padded canvases, each image at the top
left of its canvas with its (h, w) extent, no anchors; DETR serves one
detection an object query (`ops.postprocess.detr_postprocess`), Deformable
DETR the best ``deformable.top_k`` (query, class) scores
(`ops.postprocess.deformable_detr_postprocess`), boxes in pixels of the
image. `FAMILIES` maps each family to what its predict functions run.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.types import Dataset
from object_detector_tpu_torch.data.upload import StagedUpload
from object_detector_tpu_torch.eval.map import MeanAPEvaluator
from object_detector_tpu_torch.models import deformable_detr, detr
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.ops.augment import normalize
from object_detector_tpu_torch.ops.nms import Detections
from object_detector_tpu_torch.ops.postprocess import (deformable_detr_postprocess,
                                                       detr_postprocess, postprocess,
                                                       postprocess_levels)
from object_detector_tpu_torch.quant import engine
from object_detector_tpu_torch.utils import profiling

# Counts the calls of every predict function while a profiler records.
PREDICT_CALLS = "odt.predict.calls"


def make_predict_fn(
    cfg: DetectorConfig,
    model: torch.nn.Module,
    anchors_center: np.ndarray,
    use_pallas: Optional[bool] = None,
    device: str | torch.device = "cuda",
) -> Callable[..., Detections]:
    """Returns predict(images_u8) for (B, H, W, 3) uint8 images (a numpy
    array or a tensor) -> batch-stacked Detections on ``device``.

    Moves ``model`` to ``device`` in place and puts it in eval mode. For
    the DETR families ``anchors_center`` may be None and the function is
    predict(images_u8, extents) (module docstring).
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    calls = itertools.count()
    upload = StagedUpload(dev)
    family = FAMILIES[cfg.model.family]
    if family.postprocess is not None:
        @torch.inference_mode()
        def predict_padded(images_u8, extents) -> Detections:
            with _predict_span(calls):
                images, ext = _normalized_canvases(cfg, images_u8, extents, upload)
                return family.postprocess(cfg, *model(images, ext), ext)

        return predict_padded
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        with _predict_span(calls):
            cls_logits, box_offsets = model(_normalized(images_u8, upload))
            return postprocess(cls_logits, box_offsets, anchors, cfg, use_pallas)

    return predict


def _predict_span(calls: itertools.count):
    """The ``odt.predict`` span of one call, its sequence number as the
    span's args, and one more on `PREDICT_CALLS`."""
    n = next(calls)
    profiling.count(PREDICT_CALLS, 1)
    return profiling.span("odt.predict", n)


def _images(images_u8) -> torch.Tensor:
    """(B, H, W, 3) uint8 images, a numpy array or a tensor, as a tensor
    where they are (no copy)."""
    images = torch.as_tensor(images_u8)
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 images, got {images.dtype} {tuple(images.shape)}"
        )
    return images


def _normalized(images_u8, upload: StagedUpload) -> torch.Tensor:
    """(B, H, W, 3) uint8 images (numpy or tensor) -> normalized float32 on
    ``upload.device``."""
    images = _images(images_u8)
    with profiling.span("odt.upload"):
        images = upload(images)
    with profiling.span("odt.normalize"):
        return normalize(images.float() / 255.0)


def _normalized_canvases(cfg: DetectorConfig, images_u8, extents, upload: StagedUpload,
                         count: bool = True):
    """(B, S, S, 3) uint8 canvases and their (B, 2) extents (h, w), host
    arrays or tensors -> (normalized float32 canvases on ``upload.device``,
    zero beyond each extent as DETR's ``NestedTensor`` pads; the extents as
    int64 there), both uploaded in the call's one ``odt.upload`` span. With
    ``count``, adds the call's unmasked tokens to the family's counter
    (`Family.count_tokens`) while a profiler records, from the extents'
    host copy."""
    images = _images(images_u8)
    ext = torch.as_tensor(np.asarray(extents), dtype=torch.int64)
    b, h, w, _ = images.shape
    if (ext.shape != (b, 2) or bool((ext < 1).any()) or bool((ext[:, 0] > h).any())
            or bool((ext[:, 1] > w).any())):
        raise ValueError(f"expected ({b}, 2) extents (h, w) within the {h} x {w} canvas, "
                         f"got {tuple(ext.shape)}: {ext.tolist()}")
    if count and profiling.enabled():
        FAMILIES[cfg.model.family].count_tokens(cfg, ext, (h, w))
    with profiling.span("odt.upload"):
        images, ext = upload(images), upload(ext)
    with profiling.span("odt.normalize"):
        rows = torch.arange(h, device=upload.device) < ext[:, :1]
        cols = torch.arange(w, device=upload.device) < ext[:, 1:]
        images = normalize(images.float() / 255.0)
        return images.mul_((rows[:, :, None] & cols[:, None, :])[..., None]), ext


def _count_detr_tokens(cfg: DetectorConfig, ext: torch.Tensor, canvas) -> None:
    """DETR's unmasked C5 tokens, on `models.detr.VALID_TOKENS`."""
    f = tuple(detr.trunk_feature_size(s, cfg.transformer.dilate_c5) for s in canvas)
    profiling.count(detr.VALID_TOKENS, detr.valid_tokens(ext, canvas, f))


def _count_deformable_tokens(cfg: DetectorConfig, ext: torch.Tensor, canvas) -> None:
    """Deformable DETR's unmasked tokens over its levels, on
    `models.deformable_detr.VALID_TOKENS`."""
    profiling.count(deformable_detr.VALID_TOKENS,
                    deformable_detr.valid_tokens(ext, canvas, cfg.deformable.levels))


@dataclasses.dataclass(frozen=True)
class Family:
    """What the predict functions run for one ``model.family``: the names of
    the int8 engine's ``quantize(cfg, params, batches) -> (qp, spec)`` and
    ``forward(qp, spec, cfg, images[, extents])`` in `quant.engine`, looked
    up when a predict function is built; and for a family served on padded
    canvases (predict(images_u8, extents)) its ``postprocess(cfg, logits,
    boxes, extents)`` and ``count_tokens(cfg, extents, canvas)``; without a
    ``postprocess``, the anchors' decode and NMS."""

    quantize: str
    int8_forward: str
    postprocess: Optional[Callable] = None
    count_tokens: Optional[Callable] = None


FAMILIES: Dict[str, Family] = {
    "ssd": Family("quantize_ssd", "int8_forward"),
    "retinanet": Family("quantize_retinanet", "retinanet_int8_forward"),
    "detr": Family("quantize_detr", "detr_int8_forward",
                   postprocess=lambda cfg, logits, boxes, ext: detr_postprocess(logits, boxes,
                                                                                ext),
                   count_tokens=_count_detr_tokens),
    "deformable_detr": Family(
        "quantize_deformable_detr", "deformable_detr_int8_forward",
        postprocess=lambda cfg, logits, boxes, ext: deformable_detr_postprocess(
            logits, boxes, ext, cfg.deformable.top_k),
        count_tokens=_count_deformable_tokens),
}


def make_int8_predict_fn(
    cfg: DetectorConfig,
    params: Mapping[str, torch.Tensor],
    anchors_center: Optional[np.ndarray],
    calibration_images_u8,
    use_pallas: Optional[bool] = None,
    device: str | torch.device = "cuda",
    calibration_extents=None,
) -> Callable[..., Detections]:
    """Quantize once (PTQ) and return predict(images_u8) -> batch-stacked
    Detections on ``device``: int8 trunk, int8 heads (RetinaNet: int8 FPN
    and heads), then the same postprocess as the float path.

    ``params`` is the model's state_dict (for a ResNet-50 backbone with its
    BatchNorm running statistics, which are folded into the convs);
    ``calibration_images_u8`` is a
    small representative (B, H, W, 3) uint8 batch. The returned function
    carries the quantized weights and the op list as ``predict.qp`` and
    ``predict.spec``.

    With ``eval.per_level_heads`` on the kernel NMS path, the int8 heads'
    native per-level outputs (RetinaNet's always run after an int8 FPN,
    `quantize_retinanet`'s default) go to `postprocess_levels`; the
    concatenated logits are never built.

    The DETR families (module docstring) calibrate on canvases with their
    ``calibration_extents`` (the whole canvas where None), need no
    anchors, and serve predict(images_u8, extents) through their
    `Family.int8_forward` (`engine.detr_int8_forward`,
    `engine.deformable_detr_int8_forward`). Each family's engine functions
    are looked up by name when the predict function is built."""
    dev = resolve_device(device)
    pallas = cfg.eval.use_pallas_nms if use_pallas is None else use_pallas
    device_params = {k: v.to(dev) for k, v in params.items()}
    calls = itertools.count()
    upload = StagedUpload(dev)
    family = FAMILIES[cfg.model.family]
    quantize, forward = getattr(engine, family.quantize), getattr(engine, family.int8_forward)
    if family.postprocess is not None:
        if calibration_extents is None:
            n, h, w = np.shape(calibration_images_u8)[:3]
            calibration_extents = np.tile([h, w], (n, 1))
        calib, _ = _normalized_canvases(cfg, calibration_images_u8, calibration_extents, upload,
                                        count=False)
        qp, spec = quantize(cfg, device_params, [calib])
        qp = qp.to(dev)
        del calib

        @torch.inference_mode()
        def predict_padded(images_u8, extents) -> Detections:
            with _predict_span(calls):
                images, ext = _normalized_canvases(cfg, images_u8, extents, upload)
                logits, boxes = forward(qp, spec, cfg, images, ext)
                return family.postprocess(cfg, logits, boxes, ext)

        predict_padded.qp, predict_padded.spec = qp, spec
        return predict_padded
    calib = _normalized(calibration_images_u8, upload)
    qp, spec = quantize(cfg, device_params, [calib])
    qp = qp.to(dev)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    per_level = cfg.eval.per_level_heads and pallas

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        with _predict_span(calls):
            images = _normalized(images_u8, upload)
            if per_level:
                cls_levels, box_levels = forward(qp, spec, cfg, images, concat_heads=False)
                return postprocess_levels(cls_levels, box_levels, anchors, cfg)
            cls_logits, box_offsets = forward(qp, spec, cfg, images)
            return postprocess(cls_logits, box_offsets, anchors, cfg, use_pallas)

    predict.qp, predict.spec = qp, spec
    return predict


def evaluate_dataset(
    cfg: DetectorConfig,
    params: Mapping[str, torch.Tensor],
    dataset: Dataset,
    cache: Optional[DecodedCache] = None,
    use_pallas: Optional[bool] = None,
    int8: bool = False,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Run the val sweep on ``device`` and return the mAP dict for
    ``cfg.eval.map_style``. ``params`` is the model's state_dict; with
    ``int8`` the engine is calibrated on the first ``min(len(cache),
    eval.batch_size)`` cached images."""
    dev = resolve_device(device)
    if cache is None:
        cache = DecodedCache(
            dataset, cfg.model.image_size, cfg.data.max_boxes, cfg.data.num_workers,
            max_ram_bytes=int(cfg.data.max_cache_ram_gb * 2**30),
            spill_dir=cfg.data.cache_spill_dir or None,
        )
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    if int8:
        n_calib = min(len(cache), cfg.eval.batch_size)
        predict = make_int8_predict_fn(cfg, params, anchors, cache.images[:n_calib], use_pallas,
                                       device=dev)
    else:
        model = build_model(cfg)
        model.load_state_dict(params)
        predict = make_predict_fn(cfg, model, anchors, use_pallas, device=dev)
    evaluator = MeanAPEvaluator(dataset.num_classes, cfg.eval.map_style)

    bs = cfg.eval.batch_size
    n = len(dataset)
    # Static batch shape: the final partial batch OVERLAPS the previous one
    # (start = n - bs) instead of padding with repeats, so every row is a
    # real image; rows already evaluated are skipped on the host.
    starts = list(range(0, n, bs))
    if n >= bs and starts and starts[-1] + bs > n:
        starts[-1] = n - bs
    done = 0
    for start in starts:
        idx = np.arange(start, min(start + bs, n))
        pad = bs - len(idx)  # only when the whole dataset is < one batch
        padded_idx = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad else idx
        batch = cache.gather(padded_idx)
        det = predict(batch["image"])
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        for row, record_i in enumerate(idx):
            if record_i < done:
                continue  # overlap row already evaluated
            rec = dataset.records[record_i]
            keep = valid[row]
            evaluator.add_image(
                rec.image_id,
                boxes[row][keep],
                scores[row][keep],
                classes[row][keep],
                rec.boxes,
                rec.labels,
                rec.difficult,
                gt_crowd=rec.crowd_mask,
                image_size=(rec.width, rec.height),
            )
        done = int(idx[-1]) + 1
    return evaluator.result()
