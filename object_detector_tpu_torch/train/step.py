"""The train step: augmentation -> anchor matching -> forward -> loss ->
backward -> optimizer update, all on the device the batch lies on.

The port of ``object_detector_tpu/train/step.py`` for all three families.
With ``cfg.model.pool_grad_kernel`` the backward of the four VGG pools runs
the port's first-max pool kernel (`kernels.pool_bwd`). A ResNet-50
backbone's BatchNorm normalizes with the batch's statistics, and the step
returns the running statistics they move (flax's ``batch_stats``).

Under data parallelism (a `parallel.mesh.Mesh`) each rank runs the step on
its rows of the global batch and the step equals the one-device step on the
concatenated batch, as the reference's sharded program does: the
augmentation draws for the global batch and applies the rank's rows, the
BatchNorm moments and the loss's positive count are the global batch's,
the gradients are SUM all-reduced (each rank's loss is its share of the
global loss), and the metrics are the global batch's. Every rank then
applies the same update to the same state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.losses.detection import detection_loss
from object_detector_tpu_torch.models.resnet import BatchNorm
from object_detector_tpu_torch.ops import augment as aug_ops
from object_detector_tpu_torch.ops import matching
from object_detector_tpu_torch.parallel.mesh import Mesh
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


def make_train_step(
    cfg: DetectorConfig,
    model: torch.nn.Module,
    anchors_center: np.ndarray,
    device: str | torch.device = "cuda",
    augment: bool = True,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Dict[str, Tensor], torch.Generator], Tuple[TrainState, Dict[str, Tensor]]]:
    """Build the (state, batch, generator) -> (state, metrics) step.

    batch: image (B,S,S,3) uint8, boxes (B,M,4), labels (B,M), valid (B,M),
    tensors on ``device`` (``mesh.device`` under a mesh). Under a mesh the
    batch is this rank's rows of the global batch and also holds the global
    batch's ``global_boxes`` and ``global_valid``
    (`parallel.mesh.shard_batch`), from which the augmentation draws.
    ``model`` gives the structure; the weights are ``state.params``, which
    the step updates in place (with the optimizer state and the EMA), and
    the running statistics ``state.batch_stats``, which it replaces by the
    forward's new ones, returning the same state with ``step`` advanced.
    ``generator`` is the run's root generator: the step reads its initial
    seed and never advances it, and draws from a generator of its own seeded
    by `fold_in` of that seed and ``state.step``. Metrics are 0-dim tensors
    on the device: ``loss``, ``cls_loss``, ``box_loss``, ``num_positives``
    and ``grad_norm`` of the unclipped gradients, of the global batch under
    a mesh. The step's ``loss_fn(params, batch_stats, batch, seed) ->
    (loss, metrics, new_batch_stats)`` is its differentiable half, for
    callers that want the gradients themselves; it leaves ``batch_stats``
    and the model's mode as they were. Under a mesh its loss and metrics
    are the rank's shares (their SUM over the ranks is the global batch's)
    and its gradients the rank's share of the global gradients.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    update = make_optimizer(cfg.train)
    anchors = torch.as_tensor(np.asarray(anchors_center, np.float32), device=dev)
    step_generator = torch.Generator(device=dev)
    batch_norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    all_reduce = None if mesh is None else mesh.all_reduce

    def loss_fn(params, batch_stats, batch, seed: int):
        if augment:
            step_generator.manual_seed(seed)
            if mesh is None:
                draw_boxes, draw_valid, rows = batch["boxes"], batch["valid"], slice(None)
            else:  # draw for the global batch, apply this rank's rows
                b = batch["image"].shape[0]
                draw_boxes, draw_valid = batch["global_boxes"], batch["global_valid"]
                rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
            with torch.no_grad():
                draws = aug_ops.draw_augment(step_generator, draw_boxes, draw_valid,
                                             cfg.data.augment)
                ex = aug_ops.apply_augment(
                    batch["image"], batch["boxes"], batch["labels"], batch["valid"],
                    aug_ops.take_rows(draws, rows), cfg.model.image_size,
                )
            images, boxes, labels, valid = ex.image, ex.boxes, ex.labels, ex.valid
        else:
            images = aug_ops.normalize(batch["image"].to(torch.float32) / 255.0)
            boxes, labels, valid = batch["boxes"], batch["labels"], batch["valid"]

        with torch.no_grad():
            targets = encode_batch_targets(boxes, labels, valid, anchors, cfg)
        # The training-mode forward moves the running statistics in place:
        # into copies, which are the step's new statistics.
        new_stats = {k: v.clone() for k, v in batch_stats.items()}
        was_training = model.training
        model.train()
        for bn in batch_norms:
            bn.all_reduce = all_reduce
        try:
            cls_logits, box_preds = torch.func.functional_call(
                model, {**params, **new_stats}, (images,))
        finally:
            model.train(was_training)
            for bn in batch_norms:
                bn.all_reduce = None
        total, metrics = detection_loss(
            cls_logits, box_preds, targets.cls, targets.box,
            use_focal=cfg.train.use_focal,
            focal_alpha=cfg.train.focal_alpha,
            focal_gamma=cfg.train.focal_gamma,
            smooth_l1_beta=cfg.train.smooth_l1_beta,
            box_loss_weight=cfg.train.box_loss_weight,
            negatives_per_positive=cfg.train.negatives_per_positive,
            all_reduce=all_reduce,
        )
        return total, metrics, new_stats

    def train_step(state: TrainState, batch, generator: torch.Generator):
        total, metrics, new_stats = loss_fn(
            state.params, state.batch_stats, batch, fold_in(generator.initial_seed(), state.step))
        names = list(state.params)
        grads = torch.autograd.grad(total, [state.params[n] for n in names])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            grads = mesh.all_reduce_buckets(grads)
            shares = ("loss", "cls_loss", "box_loss")
            summed = mesh.all_reduce_(torch.stack([metrics[k] for k in shares]))
            metrics.update(zip(shares, summed.unbind()))
        grads = dict(zip(names, grads))
        metrics["grad_norm"] = global_norm(grads)
        update(state, grads, metrics["grad_norm"])
        state.batch_stats = new_stats
        state.step += 1
        return state, metrics

    train_step.loss_fn = loss_fn
    return train_step
