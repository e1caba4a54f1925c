"""Batched inference: uint8 images -> detections, and the sweep -> mAP.

The port of ``object_detector_tpu/eval/evaluator.py``: ``make_predict_fn``
(:19, the float serving path), ``make_int8_predict_fn`` (:33, the int8 PTQ
serving path: SSD on VGG16 or ResNet-50, and RetinaNet/FPN) and
``evaluate_dataset`` (:79, the val sweep into `MeanAPEvaluator`).

Both predict functions also serve the port's DETR family
(``family="detr"``), which the reference lacks: ``predict(images_u8,
extents)`` on padded canvases, each image at the top left of its canvas
with its (h, w) extent, no anchors and one detection an object query
(`ops.postprocess.detr_postprocess`, boxes in pixels of the image).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.types import Dataset
from object_detector_tpu_torch.eval.map import MeanAPEvaluator
from object_detector_tpu_torch.models import detr
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.ops.augment import normalize
from object_detector_tpu_torch.ops.nms import Detections
from object_detector_tpu_torch.ops.postprocess import (detr_postprocess, postprocess,
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
    the DETR family ``anchors_center`` may be None and the function is
    predict(images_u8, extents) (module docstring).
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    calls = itertools.count()
    if cfg.model.family == "detr":
        @torch.inference_mode()
        def predict_detr(images_u8, extents) -> Detections:
            with _predict_span(calls):
                images, ext = _normalized_canvases(cfg, images_u8, extents, dev)
                return detr_postprocess(*model(images, ext), ext)

        return predict_detr
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        with _predict_span(calls):
            cls_logits, box_offsets = model(_normalized(images_u8, dev))
            return postprocess(cls_logits, box_offsets, anchors, cfg, use_pallas)

    return predict


def _predict_span(calls: itertools.count):
    """The ``odt.predict`` span of one call, its sequence number as the
    span's args, and one more on `PREDICT_CALLS`."""
    n = next(calls)
    profiling.count(PREDICT_CALLS, 1)
    return profiling.span("odt.predict", n)


def _normalized(images_u8, dev: torch.device) -> torch.Tensor:
    """(B, H, W, 3) uint8 images (numpy or tensor) -> normalized float32 on
    ``dev``."""
    with profiling.span("odt.upload"):
        images = torch.as_tensor(images_u8).to(dev)
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 images, got {images.dtype} {tuple(images.shape)}"
        )
    with profiling.span("odt.normalize"):
        return normalize(images.float() / 255.0)


def _normalized_canvases(cfg: DetectorConfig, images_u8, extents, dev: torch.device,
                         count: bool = True):
    """(B, S, S, 3) uint8 canvases and their (B, 2) extents (h, w), host
    arrays or tensors -> (normalized float32 canvases on ``dev``, zero
    beyond each extent as DETR's ``NestedTensor`` pads; the extents as
    int64 on ``dev``). With ``count``, adds the call's unmasked C5 tokens
    to `models.detr.VALID_TOKENS` while a profiler records, from the
    extents' host copy."""
    images = _normalized(images_u8, dev)
    ext = torch.as_tensor(np.asarray(extents), dtype=torch.int64)
    b, h, w, _ = images.shape
    if (ext.shape != (b, 2) or bool((ext < 1).any()) or bool((ext[:, 0] > h).any())
            or bool((ext[:, 1] > w).any())):
        raise ValueError(f"expected ({b}, 2) extents (h, w) within the {h} x {w} canvas, "
                         f"got {tuple(ext.shape)}: {ext.tolist()}")
    if count and profiling.enabled():
        f = (detr.trunk_feature_size(h, cfg.transformer.dilate_c5),
             detr.trunk_feature_size(w, cfg.transformer.dilate_c5))
        profiling.count(detr.VALID_TOKENS, detr.valid_tokens(ext, (h, w), f))
    with profiling.span("odt.upload"):
        ext = ext.to(dev)
    with profiling.span("odt.normalize"):
        rows = torch.arange(h, device=dev) < ext[:, :1]
        cols = torch.arange(w, device=dev) < ext[:, 1:]
        return images.mul_((rows[:, :, None] & cols[:, None, :])[..., None]), ext


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

    The DETR family (module docstring) calibrates on canvases with their
    ``calibration_extents`` (the whole canvas where None), needs no
    anchors, and serves predict(images_u8, extents) through
    `engine.detr_int8_forward`."""
    dev = resolve_device(device)
    pallas = cfg.eval.use_pallas_nms if use_pallas is None else use_pallas
    device_params = {k: v.to(dev) for k, v in params.items()}
    calls = itertools.count()
    if cfg.model.family == "detr":
        if calibration_extents is None:
            n, h, w = np.shape(calibration_images_u8)[:3]
            calibration_extents = np.tile([h, w], (n, 1))
        calib, _ = _normalized_canvases(cfg, calibration_images_u8, calibration_extents, dev,
                                        count=False)
        qp, spec = engine.quantize_detr(cfg, device_params, [calib])
        qp = qp.to(dev)
        del calib

        @torch.inference_mode()
        def predict_detr(images_u8, extents) -> Detections:
            with _predict_span(calls):
                images, ext = _normalized_canvases(cfg, images_u8, extents, dev)
                logits, boxes = engine.detr_int8_forward(qp, spec, cfg, images, ext)
                return detr_postprocess(logits, boxes, ext)

        predict_detr.qp, predict_detr.spec = qp, spec
        return predict_detr
    calib = _normalized(calibration_images_u8, dev)
    if cfg.model.family == "retinanet":
        qp, spec = engine.quantize_retinanet(cfg, device_params, [calib])
        forward = engine.retinanet_int8_forward
    else:
        qp, spec = engine.quantize_ssd(cfg, device_params, [calib])
        forward = engine.int8_forward
    qp = qp.to(dev)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    per_level = cfg.eval.per_level_heads and pallas

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        with _predict_span(calls):
            images = _normalized(images_u8, dev)
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
