"""Packed single-key top-k for the NMS candidate and merge sorts.

The port's copy of ``object_detector_tpu/ops/packsort.py``. The candidate
index goes into the low bits of one sortable int32 score key, so a top-k is
one single-operand sort:

    key = (sortable_int(score) & ~idx_mask) | (n-1 - index)

`sortable_int` is the IEEE trick (flip all bits of negatives, keep
positives): a monotone bijection float32 -> int32, so integer order is float
order, negative logits included. Clearing the low ``idx_bits`` bits is a
monotone (floor) quantization; the inverted index in those bits breaks ties
toward the LOWER index, as ``ops.nms.top_k`` does.

Approximation contract: scores whose keys differ only in the low
``idx_bits`` bits collapse into one tie bucket, so selection among
near-equal scores can differ from an exact top-k. Callers gather the exact
scores back through the returned indices.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_INT_MIN = -(2**31)


def sortable_int(x: Tensor) -> Tensor:
    """Monotone float32 -> int32 bijection: int32 order is the float32 total
    order (negatives inverted bitwise, positives offset past them)."""
    b = x.float().view(torch.int32)
    return torch.where(b < 0, torch.bitwise_not(b) ^ _INT_MIN, b)


def top_k_packed_idx(x: Tensor, k: int, idx_bits: int | None = None) -> Tensor:
    """Indices of the top-k entries of ``x`` along the last axis, descending,
    by one int32 single-key sort. Ties (within the idx_bits quantization)
    break toward the lower index. Returns (..., k) int64 indices.
    """
    n = x.shape[-1]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    if idx_bits is None:
        idx_bits = max(1, (n - 1).bit_length())
    if n > (1 << idx_bits):
        raise ValueError(f"idx_bits={idx_bits} cannot address n={n}")
    mask = (1 << idx_bits) - 1
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    key = (sortable_int(x) & ~mask) | (n - 1 - iota)
    # Descending sort == ascending sort of the bitwise complement.
    top = torch.bitwise_not(torch.sort(torch.bitwise_not(key), dim=-1).values[..., :k])
    return (n - 1 - (top & mask)).long()
