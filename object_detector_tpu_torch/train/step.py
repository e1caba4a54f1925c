"""The train step: augmentation -> anchor matching -> forward -> loss ->
backward -> optimizer update, all on the device the batch lies on.

The port of ``object_detector_tpu/train/step.py`` for one device. With
``cfg.model.pool_grad_kernel`` the backward of the four VGG pools runs the
port's first-max pool kernel (`kernels.pool_bwd`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.losses.detection import detection_loss
from object_detector_tpu_torch.ops import augment as aug_ops
from object_detector_tpu_torch.ops import matching
from object_detector_tpu_torch.train.state import TrainState, global_norm, make_optimizer

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed for one step's random numbers, a function of the run's
    seed and the step alone (splitmix64 of their mix), so a resumed run draws
    what an unbroken one would have."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def encode_batch_targets(
    boxes: Tensor, labels: Tensor, valid: Tensor, anchors_center: Tensor, cfg: DetectorConfig,
) -> matching.MatchTargets:
    return matching.match(
        boxes, labels, valid, anchors_center, cfg.matcher,
        cfg.anchors.center_variance, cfg.anchors.size_variance,
    )


def check_trainable(cfg: DetectorConfig) -> None:
    """Raises for the models the port serves but does not train yet: a
    BatchNorm backbone needs batch statistics in the forward and running
    ones kept as flax keeps them (the biased batch variance; torch keeps
    the unbiased one)."""
    if cfg.model.backbone == "resnet50" or cfg.model.family == "retinanet":
        raise NotImplementedError(
            f"training {cfg.model.family}/{cfg.model.backbone} (batch statistics) is not ported yet"
        )


def make_train_step(
    cfg: DetectorConfig,
    model: torch.nn.Module,
    anchors_center: np.ndarray,
    device: str | torch.device = "cuda",
    augment: bool = True,
) -> Callable[[TrainState, Dict[str, Tensor], torch.Generator], Tuple[TrainState, Dict[str, Tensor]]]:
    """Build the (state, batch, generator) -> (state, metrics) step.

    batch: image (B,S,S,3) uint8, boxes (B,M,4), labels (B,M), valid (B,M),
    tensors on ``device``. ``model`` gives the structure; the weights are
    ``state.params``, which the step updates in place (with the optimizer
    state and the EMA), returning the same state with ``step`` advanced.
    ``generator`` is the run's root generator: the step reads its initial
    seed and never advances it, and draws from a generator of its own seeded
    by `fold_in` of that seed and ``state.step``. Metrics are 0-dim tensors
    on the device: ``loss``, ``cls_loss``, ``box_loss``, ``num_positives``
    and ``grad_norm`` of the unclipped gradients. The step's
    ``loss_fn(params, batch, seed) -> (loss, metrics)`` is its differentiable
    half, for callers that want the gradients themselves.
    """
    check_trainable(cfg)
    dev = resolve_device(device)
    model.to(dev).train()
    update = make_optimizer(cfg.train)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    step_generator = torch.Generator(device=dev)

    def loss_fn(params, batch, seed: int):
        if augment:
            step_generator.manual_seed(seed)
            with torch.no_grad():
                ex = aug_ops.augment_batch(
                    batch["image"], batch["boxes"], batch["labels"], batch["valid"],
                    step_generator, cfg.data.augment, cfg.model.image_size,
                )
            images, boxes, labels, valid = ex.image, ex.boxes, ex.labels, ex.valid
        else:
            images = aug_ops.normalize(batch["image"].to(torch.float32) / 255.0)
            boxes, labels, valid = batch["boxes"], batch["labels"], batch["valid"]

        with torch.no_grad():
            targets = encode_batch_targets(boxes, labels, valid, anchors, cfg)
        cls_logits, box_preds = torch.func.functional_call(model, params, (images,))
        return detection_loss(
            cls_logits, box_preds, targets.cls, targets.box,
            use_focal=cfg.train.use_focal,
            focal_alpha=cfg.train.focal_alpha,
            focal_gamma=cfg.train.focal_gamma,
            smooth_l1_beta=cfg.train.smooth_l1_beta,
            box_loss_weight=cfg.train.box_loss_weight,
            negatives_per_positive=cfg.train.negatives_per_positive,
        )

    def train_step(state: TrainState, batch, generator: torch.Generator):
        total, metrics = loss_fn(state.params, batch, fold_in(generator.initial_seed(), state.step))
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(total, [state.params[n] for n in names])))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        update(state, grads, metrics["grad_norm"])
        state.step += 1
        return state, metrics

    train_step.loss_fn = loss_fn
    return train_step
