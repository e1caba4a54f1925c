"""On-device augmentation and image normalization, batched.

The port of ``object_detector_tpu/ops/augment.py``. Every geometric op
(zoom-out "expand", SSD min-IoU crop, horizontal flip, resize) composes into
one affine source rectangle per image, applied with a single linear
resample; photometric jitter is elementwise. The whole batch is augmented on
the device the images lie on.

The reference draws its random numbers inside each op from ``jax.random``
keys. Two frameworks' streams cannot agree, so each op here is split in two:
``draw_*`` draws the parameters from an explicit ``torch.Generator`` (on the
device the parameters should lie on), ``apply_*`` applies given parameters.
The applying halves are what the tests hold against the reference.

The resample follows ``jax.image.scale_and_translate(method="linear")`` with
its default antialiasing: where the source rect is larger than the output
(every expand), the triangle kernel widens by ``1 / scale``, each output
pixel's weights are renormalised, and samples outside the image get zero
weight (which is why the image is shifted by ``fill`` first). It is built as
two separable weight matrices per image, applied as two batched matrix
products.

Boxes: normalized corner (x1, y1, x2, y2) in source-image coordinates.
Images are channel-last, (B, H, W, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from object_detector_tpu_torch.core.config import AugmentConfig
from object_detector_tpu_torch.ops import boxes as box_ops
from object_detector_tpu_torch.ops.matching import first_argmax

Tensor = torch.Tensor

IMAGENET_MEAN = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32)
IMAGENET_STD = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32)

# Hue rotation operates in YIQ space: RGB -> YIQ, rotate IQ plane, back.
_RGB2YIQ = torch.tensor(
    [[0.299, 0.587, 0.114],
     [0.596, -0.274, -0.322],
     [0.211, -0.523, 0.312]], dtype=torch.float32
)
_YIQ2RGB = torch.tensor(
    [[1.0, 0.956, 0.621],
     [1.0, -0.272, -0.647],
     [1.0, -1.106, 1.703]], dtype=torch.float32
)

# A weight column whose sum is below this is dropped, as jax does.
_MIN_WEIGHT_SUM = 1000.0 * float(torch.finfo(torch.float32).eps)


class AugmentedExample(NamedTuple):
    image: Tensor  # (B, S, S, 3) float32, ImageNet-normalized
    boxes: Tensor  # (B, M, 4) corner, normalized to the output image
    labels: Tensor  # (B, M) int32
    valid: Tensor  # (B, M) bool


class PhotometricParams(NamedTuple):
    """One value per image, each of shape (B,)."""

    brightness: Tensor  # added to every pixel
    contrast: Tensor  # factor about the image mean
    saturation: Tensor  # factor about each pixel's gray value
    hue: Tensor  # rotation of the IQ plane, in turns
    contrast_first: Tensor  # bool: contrast before saturation and hue, else after


def normalize(img: Tensor) -> Tensor:
    """(..., 3) float images in [0, 1] -> ImageNet-normalized, channel last."""
    return (img - IMAGENET_MEAN.to(img.device)) / IMAGENET_STD.to(img.device)


def _uniform(generator: torch.Generator, shape, low: float = 0.0, high: float = 1.0) -> Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return low + (high - low) * u


# --------------------------------------------------------------------------
# Photometric ops (elementwise; input/output in [0, 1])
# --------------------------------------------------------------------------

def draw_photometric(batch: int, generator: torch.Generator, cfg: AugmentConfig) -> PhotometricParams:
    return PhotometricParams(
        brightness=_uniform(generator, (batch,), -cfg.brightness_delta, cfg.brightness_delta),
        contrast=_uniform(generator, (batch,), *cfg.contrast_range),
        saturation=_uniform(generator, (batch,), *cfg.saturation_range),
        hue=_uniform(generator, (batch,), -cfg.hue_delta, cfg.hue_delta),
        contrast_first=_uniform(generator, (batch,)) < 0.5,
    )


def apply_photometric(img: Tensor, params: PhotometricParams) -> Tensor:
    """img (B, H, W, 3) in [0, 1]. Brightness, then saturation and hue with
    the contrast before or after them, then a clip to [0, 1]."""
    per_image = lambda v: v.to(img.dtype)[:, None, None, None]  # noqa: E731

    def contrast(x: Tensor) -> Tensor:
        mean = x.mean(dim=(-3, -2, -1), keepdim=True)
        return (x - mean) * per_image(params.contrast) + mean

    def saturation(x: Tensor) -> Tensor:
        gray = x.mean(dim=-1, keepdim=True)
        return (x - gray) * per_image(params.saturation) + gray

    def hue(x: Tensor) -> Tensor:
        theta = params.hue.to(img.dtype) * (2.0 * math.pi)
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([one, zero, zero, zero, c, -s, zero, s, c], dim=-1).view(-1, 3, 3)
        m = _YIQ2RGB.to(x.device) @ rot @ _RGB2YIQ.to(x.device)  # (B, 3, 3)
        return torch.einsum("bhwc,bdc->bhwd", x, m)

    first = params.contrast_first[:, None, None, None]
    x = img + per_image(params.brightness)
    x = torch.where(first, contrast(x), x)
    x = hue(saturation(x))
    x = torch.where(first, x, contrast(x))
    return x.clamp(0.0, 1.0)


def photometric_jitter(img: Tensor, generator: torch.Generator, cfg: AugmentConfig) -> Tensor:
    return apply_photometric(img, draw_photometric(img.shape[0], generator, cfg))


# --------------------------------------------------------------------------
# Geometric ops: one source-rect per image
# --------------------------------------------------------------------------

def _sample_crop_candidates(
    generator: torch.Generator, boxes: Tensor, valid: Tensor, cfg: AugmentConfig
) -> Tuple[Tensor, Tensor]:
    """Sample K candidate crop rects per image; score validity. Returns
    (rects (B, K, 4) corner form in source coords, ok (B, K) bool: the rect
    meets its sampled min-IoU constraint and keeps >= 1 GT center inside)."""
    shape = (boxes.shape[0], cfg.crop_candidates)
    area = _uniform(generator, shape, *cfg.crop_area_range)
    log_r = _uniform(
        generator, shape, math.log(cfg.crop_aspect_range[0]), math.log(cfg.crop_aspect_range[1])
    )
    ratio = torch.exp(log_r)
    w = torch.sqrt(area * ratio).clamp_max(1.0)
    h = torch.sqrt(area / ratio).clamp_max(1.0)
    x1 = _uniform(generator, shape) * (1.0 - w)
    y1 = _uniform(generator, shape) * (1.0 - h)
    rects = torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)  # (B, K, 4)

    # Each candidate draws one of the SSD min-IoU thresholds.
    thresholds = torch.tensor(cfg.crop_min_ious, dtype=torch.float32, device=rects.device)
    t_idx = torch.randint(
        0, len(cfg.crop_min_ious), shape, generator=generator, device=generator.device
    )
    min_iou = thresholds[t_idx]

    iou = box_ops.iou(rects, boxes)  # (B, K, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    meets_iou = iou.amax(dim=-1) >= min_iou

    centers = 0.5 * (boxes[..., :2] + boxes[..., 2:])  # (B, M, 2)
    inside = (
        (centers[:, None, :, 0] > rects[:, :, None, 0])
        & (centers[:, None, :, 0] < rects[:, :, None, 2])
        & (centers[:, None, :, 1] > rects[:, :, None, 1])
        & (centers[:, None, :, 1] < rects[:, :, None, 3])
        & valid[:, None, :]
    )
    keeps_center = inside.any(dim=-1)
    has_gt = valid.any(dim=-1, keepdim=True)
    return rects, meets_iou & keeps_center & has_gt


def sample_source_rect(
    generator: torch.Generator, boxes: Tensor, valid: Tensor, cfg: AugmentConfig
) -> Tensor:
    """Sample the per-image source rect (B, 4) combining expand (zoom-out)
    and min-IoU crop. Identity rect = (0, 0, 1, 1). Expand rects extend
    outside [0, 1] (out-of-range pixels are mean-filled by the resampler)."""
    batch = boxes.shape[0]
    # Expand: rect of size r >= 1 containing the unit square.
    r = _uniform(generator, (batch,), 1.0, cfg.expand_max_ratio)
    ex = _uniform(generator, (batch,)) * (r - 1.0)
    ey = _uniform(generator, (batch,)) * (r - 1.0)
    expand_rect = torch.stack([-ex, -ey, r - ex, r - ey], dim=-1)

    # Crop: first valid candidate, else identity.
    rects, ok = _sample_crop_candidates(generator, boxes, valid, cfg)
    idx = first_argmax(ok.to(torch.int32), dim=-1)
    first_ok = torch.gather(rects, 1, idx[:, None, None].expand(batch, 1, 4))[:, 0]
    identity = torch.tensor([0.0, 0.0, 1.0, 1.0], device=rects.device).expand(batch, 4)
    crop_rect = torch.where(ok.any(dim=-1, keepdim=True), first_ok, identity)

    u_mode, u_expand, u_crop = _uniform(generator, (3, batch)).unbind(0)
    do_expand = u_expand < cfg.expand_prob
    do_crop = u_crop < cfg.crop_prob
    # SSD applies expand xor crop per sample (zoom-out or zoom-in); u_mode
    # arbitrates when both fire.
    pick_expand = do_expand & ((~do_crop) | (u_mode < 0.5))
    pick_crop = do_crop & ~pick_expand
    return torch.where(
        pick_expand[:, None], expand_rect, torch.where(pick_crop[:, None], crop_rect, identity)
    )


def resample_weights(
    input_size: int, output_size: int, scale: Tensor, translation: Tensor
) -> Tensor:
    """(B, input_size, output_size) weights of one axis of a linear,
    antialiased scale-and-translate, for per-image ``scale`` and
    ``translation`` (B,): output pixel j reads input pixel i with weight
    [b, i, j]. Operation for operation ``jax._src.image.scale
    .compute_weight_mat`` with the triangle kernel."""
    scale = scale.to(torch.float32)[:, None]
    translation = translation.to(torch.float32)[:, None]
    dev = scale.device
    inv_scale = 1.0 / scale
    # Downsampling widens the kernel (a low pass); upsampling only interpolates.
    kernel_scale = inv_scale.clamp_min(1.0)
    out_pos = torch.arange(output_size, dtype=torch.float32, device=dev)
    in_pos = torch.arange(input_size, dtype=torch.float32, device=dev)
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5  # (B, out)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() / kernel_scale[:, :, None]
    weights = (1.0 - x.abs()).clamp_min(0.0)  # (B, in, out)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > _MIN_WEIGHT_SUM,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    # Zero out samples that lie wholly outside the input range.
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def scale_and_translate(
    images: Tensor,  # (B, H, W, C) float32
    out_size: int,
    scale_yx: Tensor,  # (B, 2)
    translation_yx: Tensor,  # (B, 2)
) -> Tensor:
    """``jax.image.scale_and_translate(method="linear")`` of every image to
    (out_size, out_size), each with its own scale and translation."""
    b, h, w, c = images.shape
    wy = resample_weights(h, out_size, scale_yx[:, 0], translation_yx[:, 0])  # (B, H, S)
    wx = resample_weights(w, out_size, scale_yx[:, 1], translation_yx[:, 1])  # (B, W, S)
    rows = torch.matmul(wy.transpose(1, 2), images.reshape(b, h, w * c))  # (B, S, W*C)
    rows = rows.view(b, out_size, w, c).transpose(2, 3)  # (B, S, C, W)
    out = torch.matmul(rows, wx[:, None])  # (B, S, C, S)
    return out.transpose(2, 3)


def apply_geometric(
    image: Tensor,  # (B, H, W, 3) float32 in [0, 1]
    boxes: Tensor,  # (B, M, 4)
    valid: Tensor,  # (B, M)
    rect: Tensor,  # (B, 4) source rects
    flip: Tensor,  # (B,) bool
    out_size: int,
    fill: Optional[Tensor] = None,  # (B, 3)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Resample each image's ``rect`` to (out_size, out_size); adjust boxes.
    The image is shifted by ``fill`` (its mean colour by default) around the
    resample, so out-of-bounds pixels read as the fill colour."""
    h, w = image.shape[1], image.shape[2]
    if fill is None:
        fill = image.mean(dim=(1, 2))
    fill = fill[:, None, None, :]
    x1, y1, x2, y2 = rect.unbind(-1)
    rw = x2 - x1
    rh = y2 - y1

    # Output pixel grid (0..S) maps to source pixels: src = (dst/S*rw + x1)*W.
    scale_x = out_size / (rw * w)
    scale_y = out_size / (rh * h)
    trans_x = -x1 * w * scale_x
    trans_y = -y1 * h * scale_y
    out = scale_and_translate(
        image - fill, out_size,
        torch.stack([scale_y, scale_x], dim=-1), torch.stack([trans_y, trans_x], dim=-1),
    )
    out = out + fill

    # Boxes into rect coordinates.
    new_boxes = torch.stack(
        [
            (boxes[..., 0] - x1[:, None]) / rw[:, None],
            (boxes[..., 1] - y1[:, None]) / rh[:, None],
            (boxes[..., 2] - x1[:, None]) / rw[:, None],
            (boxes[..., 3] - y1[:, None]) / rh[:, None],
        ],
        dim=-1,
    )
    # Validity: box center must remain inside the crop (SSD rule).
    centers = 0.5 * (new_boxes[..., :2] + new_boxes[..., 2:])
    center_in = ((centers > 0.0) & (centers < 1.0)).all(dim=-1)
    new_boxes = new_boxes.clamp(0.0, 1.0)
    degenerate = (new_boxes[..., 2] - new_boxes[..., 0] <= 1e-4) | (
        new_boxes[..., 3] - new_boxes[..., 1] <= 1e-4
    )
    new_valid = valid & center_in & (~degenerate)

    # Horizontal flip.
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    flipped = torch.stack(
        [1.0 - new_boxes[..., 2], new_boxes[..., 1], 1.0 - new_boxes[..., 0], new_boxes[..., 3]],
        dim=-1,
    )
    new_boxes = torch.where(flip[:, None, None], flipped, new_boxes)
    return out, new_boxes, new_valid


class AugmentParams(NamedTuple):
    photometric: PhotometricParams
    rect: Tensor  # (B, 4)
    flip: Tensor  # (B,) bool


def draw_augment(
    generator: torch.Generator, boxes: Tensor, valid: Tensor, cfg: AugmentConfig
) -> AugmentParams:
    batch = boxes.shape[0]
    return AugmentParams(
        photometric=draw_photometric(batch, generator, cfg),
        rect=sample_source_rect(generator, boxes, valid, cfg),
        flip=_uniform(generator, (batch,)) < cfg.hflip_prob,
    )


def take_rows(params: AugmentParams, rows: slice) -> AugmentParams:
    """The draws of some images of a batch. Every draw is made for the
    whole batch at once, one value (or rect) per image and each image's from
    its own boxes, so the rows of a batch's draws are what a process that
    drew for the whole batch gives those images: data-parallel ranks draw
    for the global batch and each takes its rows."""
    return AugmentParams(
        photometric=PhotometricParams(*(t[rows] for t in params.photometric)),
        rect=params.rect[rows],
        flip=params.flip[rows],
    )


def apply_augment(
    images_u8: Tensor, boxes: Tensor, labels: Tensor, valid: Tensor, params: AugmentParams,
    out_size: int,
) -> AugmentedExample:
    img = images_u8.to(torch.float32) / 255.0
    img = apply_photometric(img, params.photometric)
    img, boxes, valid = apply_geometric(img, boxes, valid, params.rect, params.flip, out_size)
    return AugmentedExample(image=normalize(img), boxes=boxes, labels=labels, valid=valid)


def augment_batch(
    images_u8: Tensor,  # (B, S, S, 3) uint8
    boxes: Tensor,  # (B, M, 4)
    labels: Tensor,  # (B, M)
    valid: Tensor,  # (B, M)
    generator: torch.Generator,  # on the images' device
    cfg: AugmentConfig,
    out_size: int,
) -> AugmentedExample:
    """Full train-time augmentation of a batch."""
    params = draw_augment(generator, boxes, valid, cfg)
    return apply_augment(images_u8, boxes, labels, valid, params, out_size)


def augment_example(
    image_u8: Tensor, boxes: Tensor, labels: Tensor, valid: Tensor,
    generator: torch.Generator, cfg: AugmentConfig, out_size: int,
) -> AugmentedExample:
    """`augment_batch` for one example: (H, W, 3), (M, 4), (M,), (M,)."""
    ex = augment_batch(image_u8[None], boxes[None], labels[None], valid[None], generator, cfg,
                       out_size)
    return AugmentedExample(*(t[0] for t in ex))


def preprocess_eval(image_u8: Tensor, out_size: int) -> Tensor:
    """Eval-time path: resize + normalize only. (H, W, 3) or (B, H, W, 3)."""
    single = image_u8.dim() == 3
    img = (image_u8[None] if single else image_u8).to(torch.float32) / 255.0
    b, h, w = img.shape[:3]
    scale = torch.tensor([out_size / h, out_size / w], device=img.device).expand(b, 2)
    out = normalize(scale_and_translate(img, out_size, scale, torch.zeros_like(scale)))
    return out[0] if single else out
