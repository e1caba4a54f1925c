"""Batched inference: uint8 images -> detections, and the sweep -> mAP.

The port of ``object_detector_tpu/eval/evaluator.py``: ``make_predict_fn``
(:19, the float serving path), ``make_int8_predict_fn`` (:33, the int8 PTQ
serving path: SSD on VGG16 or ResNet-50, and RetinaNet/FPN) and
``evaluate_dataset`` (:79, the val sweep into `MeanAPEvaluator`).
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
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.ops.augment import normalize
from object_detector_tpu_torch.ops.nms import Detections
from object_detector_tpu_torch.ops.postprocess import postprocess, postprocess_levels
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

    Moves ``model`` to ``device`` in place and puts it in eval mode.
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    calls = itertools.count()

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


def make_int8_predict_fn(
    cfg: DetectorConfig,
    params: Mapping[str, torch.Tensor],
    anchors_center: np.ndarray,
    calibration_images_u8,
    use_pallas: Optional[bool] = None,
    device: str | torch.device = "cuda",
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

    With ``eval.per_level_heads`` on the kernel NMS path and int8 heads (for
    RetinaNet: an int8 FPN, as `quantize_retinanet` makes by default), the
    heads' native per-level outputs go to `postprocess_levels`; the
    concatenated logits are never built."""
    dev = resolve_device(device)
    pallas = cfg.eval.use_pallas_nms if use_pallas is None else use_pallas
    device_params = {k: v.to(dev) for k, v in params.items()}
    calib = _normalized(calibration_images_u8, dev)
    if cfg.model.family == "retinanet":
        qp, spec = engine.quantize_retinanet(cfg, device_params, [calib])
        forward = engine.retinanet_int8_forward
        int8_fpn = "fpn/lateral3" in qp.w_int8
    else:
        qp, spec = engine.quantize_ssd(cfg, device_params, [calib])
        forward = engine.int8_forward
        int8_fpn = True
    qp = qp.to(dev)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    per_level = cfg.eval.per_level_heads and pallas and int8_fpn
    calls = itertools.count()

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
