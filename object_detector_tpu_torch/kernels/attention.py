"""DETR's multi-head attention core over each image's unmasked keys: a
hand-written CUDA kernel (``csrc/detr_attention.cu``) on the card, its plain
PyTorch version on the CPU.

It replaces no Pallas kernel (the JAX package has no DETR); it replaces
``F.scaled_dot_product_attention`` with a boolean key mask, which computed
every masked pair. The contract:

    masked_attention(q, k, v, heads, key_pad=None)
      q        (B, Lq, d), k and v (B, Lk, d): projected queries, keys and
               values, heads as d-slices of d / heads; last dim contiguous,
               rows at any stride (the chunk views of a fused projection)
      key_pad  (B, Lk) bool, True where a key is padding, or None
    -> (B, Lq, d) in q's dtype, contiguous:
       softmax(q_h k_h^T / sqrt(d / heads), over the unpadded keys) v_h for
       every head h and every query row, padded ones included.

The kernel takes bfloat16 with heads of 32 and no autograd (DETR is served,
not trained, on the port); it raises on anything else. It computes the
products in bf16 with fp32 sums, the softmax in fp32 and P in bf16.

While a profiler records, `SKIPPED_KEYS` adds up the masked keys each call
leaves out (as `models.detr.VALID_TOKENS` counts only then): a sum on the
mask's device, read when the counters are, so a call takes no host sync.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.utils import profiling

Tensor = torch.Tensor

# The head width the kernel is built for.
HEAD_DIM = 32
# Masked keys left out, summed over images and calls (a profiler recording).
SKIPPED_KEYS = "odt.detr.attention.skipped_keys"
# Keys of a masked call: the block's list of unmasked keys (2 bytes a key)
# shares the 48 KB of shared memory a block has by default with its tiles
# (32 KB) and its warp totals.
MAX_MASKED_KEYS = 8184
_LOG2E = 1.4426950408889634


def masked_attention_reference(q: Tensor, k: Tensor, v: Tensor, heads: int,
                               key_pad: Optional[Tensor] = None) -> Tensor:
    """Plain version, on either device: explicit scores, the mask, the
    softmax and the product, all in float32; the result in q's dtype. A row
    with no unpadded key is NaN, as a softmax over nothing is."""
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads
    qh = q.float().reshape(b, lq, heads, dh).transpose(1, 2)
    kh = k.float().reshape(b, lk, heads, dh).transpose(1, 2)
    vh = v.float().reshape(b, lk, heads, dh).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(2, 3)) * (1.0 / math.sqrt(dh))
    if key_pad is not None:
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
    out = torch.matmul(scores.softmax(-1), vh)
    return out.transpose(1, 2).reshape(b, lq, d).to(q.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor, heads: int, key_pad: Optional[Tensor]) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Lq, d) and k, v (B, Lk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, d = q.shape
    if k.shape[0] != b or k.shape[2] != d or heads < 1 or d % heads:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree, or d = {d} "
                         f"does not split into {heads} heads")
    if key_pad is not None and (key_pad.dtype != torch.bool
                                or tuple(key_pad.shape) != (b, k.shape[1])):
        raise ValueError(f"key_pad must be ({b}, {k.shape[1]}) bool, got {key_pad.dtype} "
                         f"{tuple(key_pad.shape)}")
    others = [t for t in (k, v, key_pad) if t is not None]
    if any(t.device != q.device for t in others) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v (and key_pad) must share a device and a dtype, got "
                         f"{[(str(t.device), t.dtype) for t in (q, *others)]}")


def _check_kernel(q: Tensor, k: Tensor, v: Tensor, heads: int, key_pad: Optional[Tensor]) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got {q.dtype}")
    if q.shape[2] // heads != HEAD_DIM:
        raise ValueError(f"the attention kernel takes heads of {HEAD_DIM}, got "
                         f"{q.shape[2] // heads}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("the attention kernel has no backward: call it without autograd")
    if key_pad is not None and k.shape[1] > MAX_MASKED_KEYS:
        raise ValueError(f"the attention kernel takes at most {MAX_MASKED_KEYS} masked keys, "
                         f"got {k.shape[1]}")
    if q.shape[0] > 65535 or heads > 65535:
        raise ValueError(f"the attention kernel takes at most 65535 images and heads, got "
                         f"{q.shape[0]} and {heads}")


def _rows(x: Tensor) -> Tensor:
    """x as it lies where each row starts 16-byte aligned with a unit last
    stride, else a dense copy."""
    if (x.stride(2) == 1 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def masked_attention(q: Tensor, k: Tensor, v: Tensor, heads: int,
                     key_pad: Optional[Tensor] = None) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `masked_attention_reference` for CPU tensors (module docstring).
    ``masked_attention.launches`` counts kernel launches."""
    _check(q, k, v, heads, key_pad)
    if q.device.type != "cpu":
        _check_kernel(q, k, v, heads, key_pad)
    plain = build.runs_plain("masked_attention", q.device)
    if key_pad is not None and profiling.enabled():
        profiling.count(SKIPPED_KEYS, key_pad.sum())
    if plain:
        return masked_attention_reference(q, k, v, heads, key_pad)
    b, lq, d = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = _rows(q), _rows(k), _rows(v)
    pad = None if key_pad is None else key_pad.contiguous()
    build.launch(
        "detr_attention", q.device,
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1), None if pad is None else pad.data_ptr(),
        lk, out.data_ptr(), b, lq, lk, heads, _LOG2E / math.sqrt(HEAD_DIM),
    )
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
