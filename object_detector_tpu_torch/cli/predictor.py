"""Single-image prediction API.

The port of ``object_detector_tpu/cli/predictor.py``: loads an image, runs
the forward + decode + NMS (float, or the int8 engine), and returns
detections in original-image pixel coordinates; optionally draws and saves
them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.eval.evaluator import make_int8_predict_fn, make_predict_fn
from object_detector_tpu_torch.models.retinanet import build_model


@dataclasses.dataclass
class Detection:
    box: np.ndarray  # (4,) pixel corner coords in the original image
    score: float
    class_id: int  # 0-based
    class_name: str


class Predictor:
    """Serving path for one image at a time: the float model, or with
    ``int8=True`` the int8 engine, quantized once at construction.

    ``params`` is the model's state_dict (from `convert.init_params` or
    `convert.params_from_jax`). The int8 engine calibrates on
    ``calibration_images_u8``, by default 8 random uint8 images from
    ``default_rng(0)``, as the reference does.
    """

    def __init__(
        self,
        cfg: DetectorConfig,
        params: Mapping[str, torch.Tensor],
        class_names: Optional[Sequence[str]] = None,
        use_pallas: Optional[bool] = None,
        device: str | torch.device = "cuda",
        int8: bool = False,
        calibration_images_u8: Optional[np.ndarray] = None,
    ):
        self.cfg = cfg
        self.class_names = list(class_names) if class_names else [
            f"class_{i}" for i in range(cfg.model.num_classes)
        ]
        anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
        if int8:
            if calibration_images_u8 is None:
                s = cfg.model.image_size
                calibration_images_u8 = np.random.default_rng(0).integers(
                    0, 255, (8, s, s, 3), dtype=np.uint8
                )
            self.model = None
            self._predict = make_int8_predict_fn(
                cfg, params, anchors, calibration_images_u8, use_pallas, device
            )
        else:
            self.model = build_model(cfg)
            self.model.load_state_dict(params)
            self._predict = make_predict_fn(cfg, self.model, anchors, use_pallas, device)

    def predict_array(
        self, image_u8: np.ndarray, score_threshold: float = 0.3
    ) -> List[Detection]:
        """image_u8: (H, W, 3) uint8 at any resolution."""
        from PIL import Image

        h, w = image_u8.shape[:2]
        s = self.cfg.model.image_size
        canvas = np.array(
            Image.fromarray(image_u8).resize((s, s), Image.BILINEAR), np.uint8
        )
        det = self._predict(canvas[None])
        boxes, scores, classes, valid = (t[0].cpu().numpy() for t in det)
        out: List[Detection] = []
        for box, score, cls, ok in zip(boxes, scores, classes, valid):
            if not ok or score < score_threshold:
                continue
            pixel_box = np.array(
                [box[0] * w, box[1] * h, box[2] * w, box[3] * h], np.float32
            )
            out.append(
                Detection(
                    box=pixel_box,
                    score=float(score),
                    class_id=int(cls),
                    class_name=self.class_names[int(cls)],
                )
            )
        return out

    def predict_file(
        self,
        image_path: str,
        score_threshold: float = 0.3,
        output_path: Optional[str] = None,
    ) -> List[Detection]:
        from PIL import Image

        with Image.open(image_path) as im:
            image = np.asarray(im.convert("RGB"), np.uint8)
        dets = self.predict_array(image, score_threshold)
        if output_path:
            draw_detections(image, dets, output_path)
        return dets


def draw_detections(
    image_u8: np.ndarray, detections: List[Detection], output_path: str
) -> None:
    from PIL import Image, ImageDraw

    im = Image.fromarray(image_u8)
    draw = ImageDraw.Draw(im)
    for d in detections:
        x1, y1, x2, y2 = [float(v) for v in d.box]
        draw.rectangle([x1, y1, x2, y2], outline=(255, 64, 64), width=3)
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{d.class_name} {d.score:.2f}", fill=(255, 255, 0))
    im.save(output_path)
