"""Batched inference: uint8 images -> detections.

The port of ``object_detector_tpu/eval/evaluator.py``: ``make_predict_fn``
(:19, the float serving path) and ``make_int8_predict_fn`` (:33, the int8
PTQ serving path, SSD family: VGG16 and ResNet-50). The mAP sweep is not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.ops.augment import normalize
from object_detector_tpu_torch.ops.nms import Detections
from object_detector_tpu_torch.ops.postprocess import postprocess
from object_detector_tpu_torch.quant import engine


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

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        cls_logits, box_offsets = model(_normalized(images_u8, dev))
        return postprocess(cls_logits, box_offsets, anchors, cfg, use_pallas)

    return predict


def _normalized(images_u8, dev: torch.device) -> torch.Tensor:
    """(B, H, W, 3) uint8 images (numpy or tensor) -> normalized float32 on
    ``dev``."""
    images = torch.as_tensor(images_u8).to(dev)
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 images, got {images.dtype} {tuple(images.shape)}"
        )
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
    Detections on ``device``: int8 trunk, int8 heads, then the same
    postprocess as the float path.

    ``params`` is the model's state_dict (for a ResNet-50 backbone with its
    BatchNorm running statistics, which are folded into the convs);
    ``calibration_images_u8`` is a
    small representative (B, H, W, 3) uint8 batch. The returned function
    carries the quantized weights and the op list as ``predict.qp`` and
    ``predict.spec``."""
    if cfg.model.family != "ssd":
        raise NotImplementedError(f"the int8 engine for {cfg.model.family!r} is not ported yet")
    dev = resolve_device(device)
    pallas = cfg.eval.use_pallas_nms if use_pallas is None else use_pallas
    if cfg.eval.per_level_heads and pallas:
        raise NotImplementedError("per_level_heads is not ported yet")
    device_params = {k: v.to(dev) for k, v in params.items()}
    calib = _normalized(calibration_images_u8, dev)
    qp, spec = engine.quantize_ssd(cfg, device_params, [calib])
    qp = qp.to(dev)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)

    @torch.inference_mode()
    def predict(images_u8) -> Detections:
        cls_logits, box_offsets = engine.int8_forward(qp, spec, cfg, _normalized(images_u8, dev))
        return postprocess(cls_logits, box_offsets, anchors, cfg, use_pallas)

    predict.qp, predict.spec = qp, spec
    return predict
