"""Detection losses: sigmoid focal + smooth-L1, plus classic SSD softmax +
hard-negative mining (both behind ``TrainConfig.use_focal``).

The port of ``object_detector_tpu/losses/detection.py``. Inputs come from
`ops.matching` targets: per-anchor class ids in {-1 ignore, 0 background,
1..C} and encoded box offsets, batched (B, A, ...). Normalization is by the
number of positive anchors in the batch: under data parallelism the global
batch's, so that the ranks' losses sum to the global batch's loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def sigmoid_focal_loss(
    logits: Tensor,  # (B, A, C) foreground class logits
    cls_targets: Tensor,  # (B, A) int in {-1, 0, 1..C}
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> Tensor:
    """Per-anchor focal loss summed over classes -> (B, A). One-vs-all
    sigmoid formulation (RetinaNet, arXiv:1708.02002): background anchors
    contribute as all-negative rows; ignored anchors are masked by the
    caller."""
    num_classes = logits.shape[-1]
    # One-hot over foreground classes; background (0) and ignore (-1) -> zeros.
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (cls_targets[..., None] - 1 == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, onehot)
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    loss = alpha_t * torch.pow(1.0 - p_t, gamma) * ce
    return loss.sum(dim=-1)


def optax_sigmoid_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Numerically-stable sigmoid cross-entropy (max(x,0) - x*z + log1p(e^-|x|))."""
    return logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Huber/smooth-L1 per element; summed over the last (coord) axis."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return loss.sum(dim=-1)


def softmax_ce_with_background(
    logits: Tensor,  # (B, A, C+1): class 0 is background
    cls_targets: Tensor,  # (B, A)
) -> Tensor:
    labels = cls_targets.clamp_min(0).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def hard_negative_mine(
    per_anchor_loss: Tensor,  # (B, A) classification loss
    positive: Tensor,  # (B, A) bool
    valid: Tensor,  # (B, A) bool (not ignored)
    negatives_per_positive: int = 3,
) -> Tensor:
    """Classic SSD OHNM: keep the top-k loss negatives, k = 3x positives.
    Returns a bool mask of anchors whose classification loss is kept. Ranks
    come from two stable sorts, so tied losses keep their anchor order as in
    the reference."""
    negative = valid & (~positive)
    neg_loss = torch.where(negative, per_anchor_loss, -torch.inf)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    num_pos = positive.sum(dim=1, keepdim=True)
    max_neg = negatives_per_positive * num_pos.clamp_min(1)
    keep_neg = negative & (ranks < max_neg)
    return positive | keep_neg


def detection_loss(
    cls_logits: Tensor,  # (B, A, C) focal / (B, A, C+1) softmax
    box_preds: Tensor,  # (B, A, 4)
    cls_targets: Tensor,  # (B, A)
    box_targets: Tensor,  # (B, A, 4)
    *,
    use_focal: bool = True,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    smooth_l1_beta: float = 1.0,
    box_loss_weight: float = 1.0,
    negatives_per_positive: int = 3,
    all_reduce: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total scalar loss + metrics dict, computed in float32.

    With ``all_reduce`` (a SUM over the data-parallel ranks) the batch is
    this rank's rows of a global batch: the positives are counted over the
    global batch, clamped to at least 1 after the sum, and the losses and
    their metrics are this rank's shares of the global batch's (their SUM
    over the ranks). ``num_positives`` is the global count. Hard-negative
    mining stays per image."""
    cls_logits = cls_logits.to(torch.float32)
    box_preds = box_preds.to(torch.float32)
    positive = cls_targets > 0
    valid = cls_targets >= 0  # ignore band excluded everywhere
    num_pos = positive.sum()
    if all_reduce is not None:
        num_pos = all_reduce(num_pos)
    num_pos = num_pos.clamp_min(1).to(torch.float32)

    if use_focal:
        per_anchor = sigmoid_focal_loss(cls_logits, cls_targets, focal_alpha, focal_gamma)
        cls_loss = torch.where(valid, per_anchor, 0.0).sum() / num_pos
    else:
        per_anchor = softmax_ce_with_background(cls_logits, cls_targets)
        keep = hard_negative_mine(per_anchor, positive, valid, negatives_per_positive)
        cls_loss = torch.where(keep, per_anchor, 0.0).sum() / num_pos

    box_l = smooth_l1(box_preds, box_targets, smooth_l1_beta)
    box_loss = torch.where(positive, box_l, 0.0).sum() / num_pos

    total = cls_loss + box_loss_weight * box_loss
    return total, {
        "loss": total,
        "cls_loss": cls_loss,
        "box_loss": box_loss,
        "num_positives": num_pos,
    }
