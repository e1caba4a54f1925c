"""Multi-scale deformable attention's core (Deformable DETR, arXiv:2010.04159
eq. 3): a hand-written CUDA kernel (``csrc/msda.cu``) on the card, its plain
PyTorch version on the CPU.

It replaces no Pallas kernel (the JAX package has no Deformable DETR), and
no library call computes it: the public code's PyTorch form is
``F.grid_sample`` once a level, then a stack and a weighted sum. The
contract:

    msda(value, shapes, ref, offsets, logits, query_pad=None)
      value      (B, Len, heads, 32): the projected values of the levels'
                 tokens, level after level, padded tokens already zero
      shapes     the levels' (H, W), host integers; level l's tokens start
                 at the sum of the earlier levels' H * W
      ref        (B, Lq, L, 2) float32: each query's reference point (x, y)
                 in [0, 1] of each level
      offsets    (B, Lq, heads * L * P * 2) float32, (heads, L, P, xy)
                 order, in cells of the level; last dim contiguous, rows at
                 any stride
      logits     (B, Lq, heads * L * P) float32, (heads, L, P) order, the
                 attention weights before their softmax; as offsets
      query_pad  (B, Lq) bool, True where a query row is padding, or None
    -> (B, Lq, heads * 32) in value's dtype, contiguous: for each query and
       head, sum over the L * P samples of softmax(logits) times the value
       sampled bilinearly at ref + offset / (W, H), as ``F.grid_sample``
       (bilinear, zeros outside the map, align_corners=False) samples it:
       at pixel (x W - 0.5, y H - 0.5). A padded query row is zero.

The softmax, the locations and the bilinear sums are float32 on both
devices: at level 0's 136 columns, a bfloat16 location would be off by up to
half a cell. The kernel takes bfloat16 values with heads of 32 in multiples
of 8, 4 levels and 4 points, and no autograd (the model is served, not
trained); it raises on anything else.

While a profiler records, `SAMPLED_POINTS` adds up query rows x heads x
levels x points of each call, from the shapes alone (no host sync).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.utils import profiling

Tensor = torch.Tensor

# The head width, levels and points a level the kernel is built for, and
# the heads a warp of it takes (4 lanes a head).
HEAD_DIM = 32
LEVELS = 4
POINTS = 4
HEADS_A_WARP = 8
# Query rows x heads x levels x points, summed over calls (a profiler recording).
SAMPLED_POINTS = "odt.deformable.sampled_points"


def level_starts(shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """The first token of each level: the running sum of H * W."""
    starts, n = [], 0
    for h, w in shapes:
        starts.append(n)
        n += h * w
    return tuple(starts)


def sampling_locations(ref: Tensor, offsets: Tensor, shapes: Sequence[Tuple[int, int]],
                       heads: int) -> Tensor:
    """(B, Lq, heads, L, P, 2) float32 locations in [0, 1] of each level:
    ``ref + offset / (W, H)``, as the public code's ``MSDeformAttn``."""
    b, lq = ref.shape[:2]
    n_levels = len(shapes)
    off = offsets.float().reshape(b, lq, heads, n_levels, -1, 2)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=ref.device)
    return ref.float()[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]


def msda_reference(value: Tensor, shapes: Sequence[Tuple[int, int]], ref: Tensor,
                   offsets: Tensor, logits: Tensor, query_pad: Optional[Tensor] = None) -> Tensor:
    """Plain version, on either device: the bilinear gather written out, four
    corners a sample, each read by index where it lies on the map; all in
    float32, the result in value's dtype."""
    b, _, heads, dh = value.shape
    lq = ref.shape[1]
    n_levels = len(shapes)
    weights = logits.float().reshape(b, lq, heads, -1).softmax(-1)
    weights = weights.reshape(b, lq, heads, n_levels, -1)
    loc = sampling_locations(ref, offsets, shapes, heads)
    v = value.float()
    out = v.new_zeros((b, lq, heads, dh))
    bi = torch.arange(b, device=v.device)[:, None, None, None]
    hi = torch.arange(heads, device=v.device)[None, None, :, None]
    for level, ((h, w), start) in enumerate(zip(shapes, level_starts(shapes))):
        # Pixel coordinates, clamped where every corner is off the map anyway.
        x = (loc[:, :, :, level, :, 0] * w - 0.5).clamp(-2.0, float(w))
        y = (loc[:, :, :, level, :, 1] * h - 0.5).clamp(-2.0, float(h))
        x0, y0 = x.floor(), y.floor()
        fx, fy = x - x0, y - y0
        for dy, dx, bilinear in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                                 (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            token = start + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (B, Lq, heads, P)
            corner = weights[:, :, :, level] * bilinear * inside
            out += (corner[..., None] * v[bi, token, hi]).sum(3)
    if query_pad is not None:
        out = out.masked_fill(query_pad[:, :, None, None], 0.0)
    return out.reshape(b, lq, heads * dh).to(value.dtype)


def _check(value: Tensor, shapes: Sequence[Tuple[int, int]], ref: Tensor, offsets: Tensor,
           logits: Tensor, query_pad: Optional[Tensor]) -> None:
    if value.dim() != 4 or ref.dim() != 4 or offsets.dim() != 3 or logits.dim() != 3:
        raise ValueError(f"expected value (B, Len, heads, d), ref (B, Lq, L, 2), offsets and "
                         f"logits (B, Lq, n), got {tuple(value.shape)}, {tuple(ref.shape)}, "
                         f"{tuple(offsets.shape)}, {tuple(logits.shape)}")
    b, length, heads, _ = value.shape
    lq, n_levels = ref.shape[1], len(shapes)
    if length != sum(h * w for h, w in shapes) or tuple(ref.shape) != (b, lq, n_levels, 2):
        raise ValueError(f"value's {length} tokens or ref {tuple(ref.shape)} disagree with the "
                         f"levels {list(shapes)}")
    points = logits.shape[2] // max(heads * n_levels, 1)
    if (tuple(logits.shape) != (b, lq, heads * n_levels * points) or points < 1
            or tuple(offsets.shape) != (b, lq, 2 * heads * n_levels * points)):
        raise ValueError(f"offsets {tuple(offsets.shape)} and logits {tuple(logits.shape)} are "
                         f"not (B, Lq, heads * L * P * 2) and (B, Lq, heads * L * P)")
    if ref.dtype != torch.float32 or offsets.dtype != torch.float32 \
            or logits.dtype != torch.float32:
        raise TypeError(f"ref, offsets and logits must be float32, got {ref.dtype}, "
                        f"{offsets.dtype}, {logits.dtype}")
    if query_pad is not None and (query_pad.dtype != torch.bool
                                  or tuple(query_pad.shape) != (b, lq)):
        raise ValueError(f"query_pad must be ({b}, {lq}) bool, got {query_pad.dtype} "
                         f"{tuple(query_pad.shape)}")
    others = [t for t in (ref, offsets, logits, query_pad) if t is not None]
    if any(t.device != value.device for t in others):
        raise ValueError(f"value, ref, offsets, logits (and query_pad) must share a device, got "
                         f"{[str(t.device) for t in (value, *others)]}")


def _aligned_rows(x: Tensor) -> bool:
    """Whether each row of x starts 16-byte aligned with a unit last stride."""
    return (x.stride(2) == 1 and x.stride(0) % 4 == 0 and x.stride(1) % 4 == 0
            and x.data_ptr() % 16 == 0)


def _check_kernel(value: Tensor, shapes: Sequence[Tuple[int, int]], logits: Tensor) -> None:
    if value.dtype != torch.bfloat16:
        raise TypeError(f"the sampling kernel takes bfloat16 values, got {value.dtype}")
    heads = value.shape[2]
    if value.shape[3] != HEAD_DIM or heads % HEADS_A_WARP or len(shapes) != LEVELS \
            or logits.shape[2] != heads * LEVELS * POINTS:
        raise ValueError(f"the sampling kernel takes heads of {HEAD_DIM} in multiples of "
                         f"{HEADS_A_WARP}, {LEVELS} levels and {POINTS} points, got "
                         f"{heads} heads of {value.shape[3]}, {len(shapes)} levels and "
                         f"{logits.shape[2] // max(heads * len(shapes), 1)} points")
    if value.requires_grad:
        raise ValueError("the sampling kernel has no backward: call it without autograd")


def msda(value: Tensor, shapes: Sequence[Tuple[int, int]], ref: Tensor, offsets: Tensor,
         logits: Tensor, query_pad: Optional[Tensor] = None) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs `msda_reference`
    for CPU tensors (module docstring). ``msda.launches`` counts kernel
    launches."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    _check(value, shapes, ref, offsets, logits, query_pad)
    if value.device.type != "cpu":
        _check_kernel(value, shapes, logits)
    plain = build.runs_plain("msda", value.device)
    b, length, heads, dh = value.shape
    lq = ref.shape[1]
    if profiling.enabled():
        profiling.count(SAMPLED_POINTS, b * lq * logits.shape[2])
    if plain:
        return msda_reference(value, shapes, ref, offsets, logits, query_pad)
    out = torch.empty((b, lq, heads * dh), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    value, ref = value.contiguous(), ref.contiguous()
    offsets = offsets if _aligned_rows(offsets) else offsets.contiguous()
    logits = logits if _aligned_rows(logits) else logits.contiguous()
    pad = None if query_pad is None else query_pad.contiguous()
    build.launch(
        "msda", value.device,
        value.data_ptr(), ref.data_ptr(), offsets.data_ptr(), offsets.stride(0),
        offsets.stride(1), logits.data_ptr(), logits.stride(0), logits.stride(1),
        None if pad is None else pad.data_ptr(), out.data_ptr(), b, lq, length, heads,
        *(n for hw in shapes for n in hw),
    )
    msda.launches += 1
    return out


msda.launches = 0
