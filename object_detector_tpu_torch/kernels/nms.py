"""Candidate-sparse decode + per-class NMS, with the suppression scan as a
hand-written CUDA kernel (``csrc/nms.cu``).

The port of ``object_detector_tpu/kernels/nms_pallas.py``'s serving path,
``pallas_decode_nms``:

1. class-agnostic top-M anchors per image by raw max-class logit
   (M = 2 * pre_nms_top_k; sigmoid is monotone, so this ranks by score);
2. gather, then float32 sigmoid and ``decode(clip=True)`` on the M
   candidates only;
3. pad the candidates to a multiple of 128 and lay every (image, class)
   problem out as one of R = B * C rows;
4. the suppression scan (`nms_rows`: the CUDA kernel on a card, one warp a
   row for rows of up to `WARP_ROUTE_MAX_K` columns, `nms_rows_reference`
   for tensors on the CPU);
5. merge: the top ``max_detections`` of each image's C * n_out survivors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.ops import boxes as box_ops
from object_detector_tpu_torch.ops.nms import Detections, as_f32, top_k

Tensor = torch.Tensor
RowsFn = Callable[..., Tuple[Tensor, Tensor]]

_LANE = 128
# Rows of up to WARP_ROUTE_MAX_K columns take the kernel's warp route (one
# warp a row, the row in registers, 16 columns a lane at most); wider rows
# take its block route, the row in shared memory at 24 bytes a column, where
# 8192 columns stay under the 227 KB a block may use.
WARP_ROUTE_MAX_K = 512
MAX_K = 8192


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_score_threshold(score_threshold: float) -> None:
    """Suppressed and padded scores are 0.0, which must never clear the
    threshold."""
    if score_threshold < 0:
        raise ValueError(
            f"score_threshold must be >= 0 (got {score_threshold}): the NMS "
            "kernel uses 0.0 as the suppressed/padded-score sentinel"
        )


def _t_ratio(iou_threshold: float) -> float:
    """t/(1+t) in double, rounded once to float32 (`inter > t*union` is
    rearranged to `inter > t/(1+t) * (area + w_area)`)."""
    return as_f32(iou_threshold / (1.0 + iou_threshold))


def nms_rows_reference(
    coords: Tensor,  # (4, R, k) x1/y1/x2/y2 planes, float32
    scores: Tensor,  # (R, k) float32
    *,
    max_out: int,
    iou_threshold: float,
    score_threshold: float,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel, emit step for emit step.

    Returns per-row survivors in emit order: scores (R, max_out) float32,
    0 for an empty slot, and candidate columns (R, max_out) int32, 0 for an
    empty slot.
    """
    rows, k = scores.shape
    x1, y1, x2, y2 = coords.unbind(0)
    t_ratio = _t_ratio(iou_threshold)
    threshold = as_f32(score_threshold)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    area_scaled = area * t_ratio
    remaining = scores.clone()
    out_s = torch.zeros((rows, max_out), dtype=torch.float32, device=scores.device)
    out_c = torch.zeros((rows, max_out), dtype=torch.int32, device=scores.device)
    for j in range(max_out):
        idx = remaining.argmax(dim=1, keepdim=True)  # first index on ties
        s = remaining.gather(1, idx)
        valid = s > threshold
        if not bool(valid.any()):
            break  # every row is done; the slots left stay empty
        out_s[:, j : j + 1] = torch.where(valid, s, torch.zeros_like(s))
        out_c[:, j : j + 1] = torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int32)
        # The reference's masked max with identity 0: max(x[w], 0) for k > 1.
        wx1, wy1, wx2, wy2 = (
            p.gather(1, idx).clamp_min(0.0) if k > 1 else p.gather(1, idx)
            for p in (x1, y1, x2, y2)
        )
        w_area = (wx2 - wx1).clamp_min(0.0) * (wy2 - wy1).clamp_min(0.0)
        iw = (torch.minimum(wx2, x2) - torch.maximum(wx1, x1)).clamp_min(0.0)
        ih = torch.minimum(wy2, y2) - torch.maximum(wy1, y1)
        suppress = iw * ih > area_scaled + w_area * t_ratio
        suppress.scatter_(1, idx, True)
        # A row below the threshold is zeroed too: all it has left is below
        # the threshold, so nothing it could still emit changes.
        remaining = remaining.masked_fill(suppress, 0.0)
    return out_s, out_c


def nms_rows(
    coords: Tensor,
    scores: Tensor,
    *,
    max_out: int,
    iou_threshold: float,
    score_threshold: float,
) -> Tuple[Tensor, Tensor]:
    """The suppression scan: launches the CUDA kernel for CUDA tensors and
    runs `nms_rows_reference` for CPU tensors. Same contract as
    `nms_rows_reference`; ``nms_rows.launches`` counts kernel launches."""
    if scores.device.type == "cpu":
        return nms_rows_reference(
            coords, scores, max_out=max_out, iou_threshold=iou_threshold,
            score_threshold=score_threshold,
        )
    if scores.device.type != "cuda":
        raise ValueError(f"nms_rows runs on cuda or cpu tensors, got {scores.device}")
    rows, k = scores.shape
    if coords.shape != (4, rows, k):
        raise ValueError(f"coords must be (4, {rows}, {k}), got {tuple(coords.shape)}")
    if coords.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_rows takes float32, got {coords.dtype} and {scores.dtype}")
    if coords.device != scores.device:
        raise ValueError(f"coords on {coords.device}, scores on {scores.device}")
    if not (coords.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_rows takes contiguous coords and scores")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"row width k={k} outside [1, {MAX_K}]")
    if not 1 <= max_out <= k:
        raise ValueError(f"max_out={max_out} outside [1, k={k}]")
    out_s = torch.empty((rows, max_out), dtype=torch.float32, device=scores.device)
    out_c = torch.empty((rows, max_out), dtype=torch.int32, device=scores.device)
    if rows == 0:
        return out_s, out_c
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().nms_rows(
            coords.data_ptr(), scores.data_ptr(), rows, k, max_out,
            _t_ratio(iou_threshold), as_f32(score_threshold),
            out_s.data_ptr(), out_c.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_rows kernel launch failed with CUDA error {err}")
    nms_rows.launches += 1
    return out_s, out_c


nms_rows.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("nms")
    fn = lib.nms_rows
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.nms_rows_warp_max_k.restype = ctypes.c_int
    return lib


def warp_route_max_k() -> int:
    """The widest row of the kernel's warp route, as the built library has it
    (builds it)."""
    return int(_library().nms_rows_warp_max_k())


def _merge_survivors(
    kept_s: Tensor,  # (B*C, n_out) survivor scores
    kept_c: Tensor,  # (B*C, n_out) survivor candidate columns
    cand_boxes: Tensor,  # (B, m, 4)
    batch: int,
    num_classes: int,
    n_out: int,
    max_detections: int,
) -> Detections:
    """Cross-class merge per image over the compact survivor lists."""
    total = num_classes * n_out
    flat_scores = kept_s.reshape(batch, total)
    flat_cols = kept_c.reshape(batch, total).long()
    if total < max_detections:  # tiny configs: pad with empty slots
        pad = max_detections - total
        flat_scores = torch.nn.functional.pad(flat_scores, (0, pad))
        flat_cols = torch.nn.functional.pad(flat_cols, (0, pad))
    merged_scores, merged_idx = top_k(flat_scores, max_detections)
    anchor_idx = torch.gather(flat_cols, 1, merged_idx)
    # An empty slot holds column 0, so an invalid detection carries
    # candidate 0's box, as in the reference.
    out_boxes = torch.gather(cand_boxes, 1, anchor_idx[..., None].expand(-1, -1, 4))
    out_classes = torch.clamp(merged_idx // n_out, max=num_classes - 1).to(torch.int32)
    return Detections(
        boxes=out_boxes, scores=merged_scores, classes=out_classes,
        valid=merged_scores > 0.0,
    )


def decode_nms(
    cls_logits: Tensor,  # (B, A, C) raw sigmoid logits
    box_offsets: Tensor,  # (B, A, 4) SSD-encoded offsets
    anchors_center: Tensor,  # (A, 4)
    *,
    score_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    pre_nms_top_k: int = 256,
    max_detections: int = 200,
    max_per_class: int = 100,
    center_variance: float = 0.1,
    size_variance: float = 0.2,
    exact_prefilter: bool = False,
    packed_sort: bool = False,
    class_top_k: int = 0,
    coord_bf16: bool = False,
    rows_fn: RowsFn = nms_rows,
) -> Detections:
    """Fused candidate-sparse postprocess; the contract of the reference's
    ``pallas_decode_nms``. Exact per-class NMS only when M >= A; otherwise
    the class-agnostic prefilter can drop candidates a per-class scan would
    keep. ``exact_prefilter`` is accepted for the config's sake: selection
    is always exact, as in the reference off a TPU. ``rows_fn`` is the
    suppression scan (the kernel wrapper unless a caller swaps in
    `nms_rows_reference`)."""
    del exact_prefilter
    if packed_sort:
        raise NotImplementedError("nms_packed_sort is not ported yet")
    if class_top_k:
        raise NotImplementedError("nms_class_top_k > 0 is not ported yet")
    if coord_bf16:
        raise NotImplementedError("nms_coord_bf16 is not ported yet")
    _check_score_threshold(score_threshold)
    batch, num_anchors, num_classes = cls_logits.shape
    m_eff = min(2 * pre_nms_top_k, num_anchors)
    m = _round_up(m_eff, _LANE)

    if m_eff >= num_anchors:
        cand_logits = cls_logits
        cand_offsets = box_offsets
        cand_anchors = anchors_center[None].expand(batch, num_anchors, 4)
    else:
        _, aidx = top_k(cls_logits.amax(dim=-1), m_eff)  # (B, M)
        cand_logits = torch.gather(cls_logits, 1, aidx[..., None].expand(-1, -1, num_classes))
        cand_offsets = torch.gather(box_offsets, 1, aidx[..., None].expand(-1, -1, 4))
        cand_anchors = anchors_center[aidx]  # (B, M, 4)

    cand_scores = torch.sigmoid(cand_logits.float())
    cand_boxes = box_ops.decode(
        cand_offsets.float(), cand_anchors, center_variance, size_variance, clip=True
    )
    pad = m - cand_scores.shape[1]
    if pad:
        cand_scores = torch.nn.functional.pad(cand_scores, (0, 0, 0, pad))
        cand_boxes = torch.nn.functional.pad(cand_boxes, (0, 0, 0, pad))

    rows = batch * num_classes
    row_scores = cand_scores.transpose(1, 2).reshape(rows, m).contiguous()
    coords = (
        cand_boxes.permute(2, 0, 1)[:, :, None, :]
        .expand(4, batch, num_classes, m)
        .reshape(4, rows, m)
        .contiguous()
    )
    n_out = min(max_per_class, max_detections, m)
    kept_s, kept_c = rows_fn(
        coords, row_scores, max_out=n_out, iou_threshold=iou_threshold,
        score_threshold=score_threshold,
    )
    return _merge_survivors(
        kept_s, kept_c, cand_boxes, batch, num_classes, n_out, max_detections
    )
