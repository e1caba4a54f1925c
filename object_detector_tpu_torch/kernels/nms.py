"""Candidate-sparse decode + per-class NMS, with the suppression scan as a
hand-written CUDA kernel (``csrc/nms.cu``).

The port of ``object_detector_tpu/kernels/nms_pallas.py``'s serving paths,
``pallas_decode_nms`` (`decode_nms`) and ``pallas_decode_nms_levels``
(`decode_nms_levels`), and of its NMS on decoded boxes,
``pallas_per_class_nms_batched`` (`per_class_nms_batched`):

1. class-agnostic top-M anchors per image by raw max-class logit
   (M = 2 * pre_nms_top_k; sigmoid is monotone, so this ranks by score);
   `decode_nms_levels` selects per level first, then across levels;
2. gather, then float32 sigmoid and ``decode(clip=True)`` on the M
   candidates only;
3. pad the candidates to a multiple of 128 and lay every (image, class)
   problem out as one of R = B * C rows; with ``class_top_k`` keep each
   row's top 128 or 256 columns;
4. the suppression scan (`nms_rows`: the CUDA kernel on a card, one warp a
   row for rows of up to `WARP_ROUTE_MAX_K` columns, `nms_rows_reference`
   for tensors on the CPU), on float32 or, with ``coord_bf16``, bfloat16
   coordinate planes;
5. merge: the top ``max_detections`` of each image's C * n_out survivors.

``packed_sort`` makes the prefilter's and the merge's top-k one int32 key
sort (`ops.packsort`).
"""

from __future__ import annotations

import types
from typing import Callable, Sequence, Tuple

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.ops import boxes as box_ops
from object_detector_tpu_torch.ops.nms import Detections, as_f32, top_k
from object_detector_tpu_torch.ops.packsort import top_k_packed_idx
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor
RowsFn = Callable[..., Tuple[Tensor, Tensor]]

_LANE = 128
# Rows of up to WARP_ROUTE_MAX_K columns take the kernel's warp route (one
# warp a row, the row in registers, 16 columns a lane at most); wider rows
# take its block route, the row in shared memory at 24 bytes a column, where
# 8192 columns stay under the 227 KB a block may use.
WARP_ROUTE_MAX_K = 512
MAX_K = 8192
# The coordinate types of the scan's two instantiations.
COORD_DTYPES = (torch.float32, torch.bfloat16)


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


def _t_ratio(iou_threshold: float, dtype: torch.dtype = torch.float32) -> float:
    """t/(1+t) in double, rounded once to float32 (`inter > t*union` is
    rearranged to `inter > t/(1+t) * (area + w_area)`). For bfloat16
    coordinates it is then rounded to bfloat16: the reference's
    ``cdt.type(t)`` (an ml_dtypes scalar) rounds a double through float32
    too, which at some thresholds differs from rounding it straight to
    bfloat16."""
    t = as_f32(iou_threshold / (1.0 + iou_threshold))
    if dtype == torch.bfloat16:
        t = float(torch.tensor(t, dtype=torch.float32).to(torch.bfloat16))
    return t


def _check_coords(coords: Tensor) -> None:
    if coords.dtype not in COORD_DTYPES:
        raise TypeError(f"nms_rows takes float32 or bfloat16 coordinates, got {coords.dtype}")


def nms_rows_reference(
    coords: Tensor,  # (4, R, k) x1/y1/x2/y2 planes, float32 or bfloat16
    scores: Tensor,  # (R, k) float32
    *,
    max_out: int,
    iou_threshold: float,
    score_threshold: float,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel, emit step for emit step.

    The coordinate arithmetic runs in the planes' dtype, each operation
    rounded to it (bfloat16: PyTorch computes in float32 and rounds once,
    as the kernel does); the suppress compare reads those values in
    float32. Returns per-row survivors in emit order: scores (R, max_out)
    float32, 0 for an empty slot, and candidate columns (R, max_out) int32,
    0 for an empty slot.
    """
    _check_coords(coords)
    rows, k = scores.shape
    x1, y1, x2, y2 = coords.unbind(0)
    t_ratio = torch.tensor(_t_ratio(iou_threshold, coords.dtype), dtype=coords.dtype,
                           device=coords.device)
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
        suppress = (iw * ih).float() > (area_scaled + w_area * t_ratio).float()
        suppress.scatter_(1, idx, True)
        # A row below the threshold is zeroed too: all it has left is below
        # the threshold, so nothing it could still emit changes.
        remaining = remaining.masked_fill(suppress, 0.0)
    return out_s, out_c


@spanned("odt.kernel.nms")
def nms_rows(
    coords: Tensor,
    scores: Tensor,
    *,
    max_out: int,
    iou_threshold: float,
    score_threshold: float,
) -> Tuple[Tensor, Tensor]:
    """The suppression scan: launches the CUDA kernel for CUDA tensors (the
    float32 or the bfloat16 instantiation, by the coordinates' dtype) and
    runs `nms_rows_reference` for CPU tensors. Same contract as
    `nms_rows_reference`; ``nms_rows.launches`` counts launches of the
    float32 instantiation, ``nms_rows.bf16.launches`` of the bfloat16 one."""
    _check_coords(coords)
    if build.runs_plain("nms_rows", scores.device):
        return nms_rows_reference(
            coords, scores, max_out=max_out, iou_threshold=iou_threshold,
            score_threshold=score_threshold,
        )
    rows, k = scores.shape
    if coords.shape != (4, rows, k):
        raise ValueError(f"coords must be (4, {rows}, {k}), got {tuple(coords.shape)}")
    if scores.dtype != torch.float32:
        raise TypeError(f"nms_rows takes float32 scores, got {scores.dtype}")
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
    bf16 = coords.dtype == torch.bfloat16
    build.launch(
        "nms_rows_bf16" if bf16 else "nms_rows", scores.device,
        coords.data_ptr(), scores.data_ptr(), rows, k, max_out,
        _t_ratio(iou_threshold, coords.dtype), as_f32(score_threshold),
        out_s.data_ptr(), out_c.data_ptr(),
    )
    if bf16:
        nms_rows.bf16.launches += 1
    else:
        nms_rows.launches += 1
    return out_s, out_c


nms_rows.launches = 0
# The bfloat16 instantiation's own counter.
nms_rows.bf16 = types.SimpleNamespace(launches=0)


def warp_route_max_k() -> int:
    """The widest row of the kernel's warp route, as the built library has it
    (builds it)."""
    return int(build.entry("nms_rows_warp_max_k")())


def _top_k_idx(x: Tensor, k: int, packed_sort: bool) -> Tensor:
    """Indices of the top k along the last axis: one int32 key sort with
    ``packed_sort`` (on float32 keys), else the exact stable top-k."""
    if packed_sort:
        return top_k_packed_idx(x.float(), k)
    return top_k(x, k)[1]


def _merge_survivors(
    kept_s: Tensor,  # (B*C, n_out) survivor scores
    kept_c: Tensor,  # (B*C, n_out) survivor candidate columns
    cand_boxes: Tensor,  # (B, m, 4)
    batch: int,
    num_classes: int,
    n_out: int,
    max_detections: int,
    packed_sort: bool = False,
) -> Detections:
    """Cross-class merge per image over the compact survivor lists. With
    ``packed_sort`` the top-k is one int32 key sort and the merged scores are
    gathered back through its indices, so they stay exact."""
    total = num_classes * n_out
    flat_scores = kept_s.reshape(batch, total)
    flat_cols = kept_c.reshape(batch, total).long()
    if total < max_detections:  # tiny configs: pad with empty slots
        pad = max_detections - total
        flat_scores = torch.nn.functional.pad(flat_scores, (0, pad))
        flat_cols = torch.nn.functional.pad(flat_cols, (0, pad))
    if packed_sort:
        merged_idx = top_k_packed_idx(flat_scores, max_detections)
        merged_scores = torch.gather(flat_scores, 1, merged_idx)
    else:
        merged_scores, merged_idx = top_k(flat_scores, max_detections)
    anchor_idx = torch.gather(flat_cols, 1, merged_idx)
    # An empty slot holds column 0, so an invalid detection carries
    # candidate 0's box (with class_top_k, the row's first narrowed
    # column's), as in the reference.
    out_boxes = torch.gather(cand_boxes, 1, anchor_idx[..., None].expand(-1, -1, 4))
    out_classes = torch.clamp(merged_idx // n_out, max=num_classes - 1).to(torch.int32)
    return Detections(
        boxes=out_boxes, scores=merged_scores, classes=out_classes,
        valid=merged_scores > 0.0,
    )


def _rows_nms_merge(
    cand_boxes: Tensor,  # (B, m, 4) float32 corner boxes
    row_scores: Tensor,  # (R, m) float32, R = B * C
    batch: int,
    num_classes: int,
    m_eff: int,
    *,
    class_top_k: int,
    max_per_class: int,
    max_detections: int,
    iou_threshold: float,
    score_threshold: float,
    packed_sort: bool,
    coord_bf16: bool,
    rows_fn: RowsFn,
) -> Detections:
    """The shared tail of every entry point (reference ``_rows_nms_merge``):
    the optional per-class narrowing, the suppression scan and the merge.

    ``class_top_k`` > 0 keeps each (image, class) row's exact top
    round_up(min(class_top_k, m_eff), 128) columns, ties to the lower
    column, when that is narrower than the row: the scan runs at that width
    and its columns are mapped back through the selection. ``coord_bf16``
    hands the scan bfloat16 coordinate planes."""
    rows, m = row_scores.shape
    k2 = _round_up(min(class_top_k, m_eff), _LANE) if class_top_k else m
    nidx = None
    if k2 < m:
        row_scores, nidx = top_k(row_scores, k2)
        # Each row's narrowed columns out of its image's candidates: the
        # broadcast over classes folds into the gather.
        gathered = torch.gather(
            cand_boxes, 1, nidx.reshape(batch, num_classes * k2)[..., None].expand(-1, -1, 4)
        )  # (B, C * k2, 4)
        coords = gathered.permute(2, 0, 1).reshape(4, rows, k2)
    else:
        coords = (
            cand_boxes.permute(2, 0, 1)[:, :, None, :]
            .expand(4, batch, num_classes, m)
            .reshape(4, rows, m)
        )
    if coord_bf16:
        coords = coords.to(torch.bfloat16)
    n_out = min(max_per_class, max_detections, row_scores.shape[1])
    kept_s, kept_c = rows_fn(
        coords.contiguous(), row_scores.float().contiguous(), max_out=n_out,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
    )
    if nidx is not None:
        # The scan's columns index the narrowed row; the merge looks boxes
        # up by candidate column.
        kept_c = torch.gather(nidx, 1, kept_c.long())
    return _merge_survivors(
        kept_s, kept_c, cand_boxes, batch, num_classes, n_out, max_detections,
        packed_sort=packed_sort,
    )


def _prefilter(
    ranked: Tensor,  # (B, A, C) scores or raw logits
    others: Sequence[Tensor],  # (B, A, 4) each
    m_eff: int,
    packed_sort: bool,
) -> Tuple[Tensor, ...]:
    """The class-agnostic prefilter: each image's top ``m_eff`` anchors by
    max-class value, with their rows of ``ranked`` and of every tensor in
    ``others``; every anchor when ``m_eff`` covers them all."""
    _, num_anchors, num_classes = ranked.shape
    if m_eff >= num_anchors:
        return (ranked, *others)
    aidx = _top_k_idx(ranked.amax(dim=-1), m_eff, packed_sort)[..., None]  # (B, M, 1)
    return (torch.gather(ranked, 1, aidx.expand(-1, -1, num_classes)),
            *(torch.gather(t, 1, aidx.expand(-1, -1, t.shape[-1])) for t in others))


def _candidates_nms(
    cand_scores: Tensor,  # (B, M', C) float32 scores
    cand_boxes: Tensor,  # (B, M', 4) float32 corner boxes
    m: int,  # lane-rounded row width (>= M')
    m_eff: int,
    **merge_kwargs,
) -> Detections:
    """The candidates padded to ``m`` and laid out as one row per (image,
    class), then `_rows_nms_merge`."""
    batch, _, num_classes = cand_scores.shape
    pad = m - cand_scores.shape[1]
    if pad:
        cand_scores = torch.nn.functional.pad(cand_scores, (0, 0, 0, pad))
        cand_boxes = torch.nn.functional.pad(cand_boxes, (0, 0, 0, pad))
    row_scores = cand_scores.transpose(1, 2).reshape(batch * num_classes, m)
    return _rows_nms_merge(cand_boxes, row_scores, batch, num_classes, m_eff, **merge_kwargs)


def _candidates_decode_nms(
    cand_logits: Tensor,  # (B, M', C) raw logits, any float dtype
    cand_offsets: Tensor,  # (B, M', 4) SSD-encoded offsets
    cand_anchors: Tensor,  # (B, M', 4) center-form anchors
    m: int,
    m_eff: int,
    *,
    center_variance: float,
    size_variance: float,
    **merge_kwargs,
) -> Detections:
    """The decode-NMS tail shared by `decode_nms` and `decode_nms_levels`
    (reference ``_candidates_decode_nms``): float32 sigmoid and box decode
    on the gathered candidates only, then `_candidates_nms`."""
    cand_boxes = box_ops.decode(
        cand_offsets.float(), cand_anchors, center_variance, size_variance, clip=True
    )
    return _candidates_nms(torch.sigmoid(cand_logits.float()), cand_boxes, m, m_eff,
                           **merge_kwargs)


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
    is always exact, as in the reference off a TPU (``packed_sort`` aside,
    whose ties are its key's). ``rows_fn`` is the suppression scan (the
    kernel wrapper unless a caller swaps in `nms_rows_reference`)."""
    del exact_prefilter
    _check_score_threshold(score_threshold)
    batch, num_anchors, num_classes = cls_logits.shape
    m_eff = min(2 * pre_nms_top_k, num_anchors)
    m = _round_up(m_eff, _LANE)

    cand_logits, cand_offsets, cand_anchors = _prefilter(
        cls_logits, (box_offsets, anchors_center[None].expand(batch, num_anchors, 4)),
        m_eff, packed_sort,
    )
    return _candidates_decode_nms(
        cand_logits, cand_offsets, cand_anchors, m, m_eff,
        center_variance=center_variance, size_variance=size_variance,
        class_top_k=class_top_k, max_per_class=max_per_class, max_detections=max_detections,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        packed_sort=packed_sort, coord_bf16=coord_bf16, rows_fn=rows_fn,
    )


def decode_nms_levels(
    level_logits: Sequence[Tensor],  # per level: (B, H, W, a*C) raw logits, head-native
    level_offsets: Sequence[Tensor],  # per level: (B, H, W, a*4) offsets
    anchors_center: Tensor,  # (A, 4) the full level-major anchor set
    anchors_per_level: Sequence[int],  # anchors per cell (a) of each level
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
    """Per-level candidate selection over the heads' native per-level
    tensors, never building the concatenated (B, A, C) logits; the contract
    of the reference's ``pallas_decode_nms_levels``.

    Two-stage exact prefilter: per level, the top min(M, N_l) anchors by
    max-class logit in the logits' dtype (the whole level when it fits), a
    superset of the level's share of the global top M; then the global top M
    over the stage-1 survivors. The candidate set equals `decode_nms`'s on
    the concatenated tensors; only the order of exact ties across levels
    can differ. ``exact_prefilter`` and ``rows_fn`` as in `decode_nms`."""
    del exact_prefilter
    _check_score_threshold(score_threshold)
    batch = level_logits[0].shape[0]
    counts = [t.shape[1] * t.shape[2] * a for t, a in zip(level_logits, anchors_per_level)]
    num_anchors = sum(counts)
    num_classes = level_logits[0].shape[-1] // anchors_per_level[0]
    m_eff = min(2 * pre_nms_top_k, num_anchors)
    m = _round_up(m_eff, _LANE)

    sel_logits, sel_offsets, sel_anchors = [], [], []
    offset = 0
    for tap_c, tap_b, n_l in zip(level_logits, level_offsets, counts):
        logits = tap_c.reshape(batch, n_l, num_classes)
        offsets = tap_b.reshape(batch, n_l, 4)
        amax = logits.amax(dim=-1)  # (B, N_l) in the logits' dtype
        k_l = min(m_eff, n_l)
        if k_l >= n_l:  # the whole level survives stage 1: no sort, no gather
            sel_logits.append(logits)
            sel_offsets.append(offsets)
            sel_anchors.append(anchors_center[offset:offset + n_l][None].expand(batch, n_l, 4))
        else:
            lidx = _top_k_idx(amax, k_l, packed_sort)  # (B, k_l)
            # A direct gather of the chosen anchors' rows. The reference
            # gathers the cell and selects the anchor slot by a one-hot sum
            # (a TPU layout device); a sum of one value and zeros is that
            # value, so both give the same logits and offsets.
            sel_logits.append(torch.gather(logits, 1, lidx[..., None].expand(-1, -1, num_classes)))
            sel_offsets.append(torch.gather(offsets, 1, lidx[..., None].expand(-1, -1, 4)))
            sel_anchors.append(anchors_center[offset + lidx])
        offset += n_l

    # Stage 2: the global top M over the stage-1 survivors.
    cand_logits, cand_offsets, cand_anchors = _prefilter(
        torch.cat(sel_logits, dim=1),
        (torch.cat(sel_offsets, dim=1).float(), torch.cat(sel_anchors, dim=1)),
        m_eff, packed_sort,
    )
    return _candidates_decode_nms(
        cand_logits, cand_offsets, cand_anchors, m, m_eff,
        center_variance=center_variance, size_variance=size_variance,
        class_top_k=class_top_k, max_per_class=max_per_class, max_detections=max_detections,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        packed_sort=packed_sort, coord_bf16=coord_bf16, rows_fn=rows_fn,
    )


def per_class_nms_batched(
    boxes: Tensor,  # (B, A, 4) decoded corner boxes, coordinates >= 0
    scores: Tensor,  # (B, A, C)
    *,
    score_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    pre_nms_top_k: int = 400,
    max_detections: int = 200,
    max_per_class: int = 100,
    exact_prefilter: bool = False,
    packed_sort: bool = False,
    class_top_k: int = 0,
    coord_bf16: bool = False,
    rows_fn: RowsFn = nms_rows,
) -> Detections:
    """Batched per-class NMS on decoded boxes through the scan; the contract
    of the reference's ``pallas_per_class_nms_batched``. Every (image,
    class) problem is one row. The top M = 2 * pre_nms_top_k anchors by
    max-class score are selected once per image (class-agnostic) and their
    boxes shared by every class row: exact per-class NMS only when M >= A.
    ``exact_prefilter`` and ``rows_fn`` as in `decode_nms`."""
    del exact_prefilter
    _check_score_threshold(score_threshold)
    m_eff = min(2 * pre_nms_top_k, scores.shape[1])
    cand_scores, cand_boxes = _prefilter(scores, (boxes,), m_eff, packed_sort)
    return _candidates_nms(
        cand_scores, cand_boxes, _round_up(m_eff, _LANE), m_eff,
        class_top_k=class_top_k, max_per_class=max_per_class, max_detections=max_detections,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        packed_sort=packed_sort, coord_bf16=coord_bf16, rows_fn=rows_fn,
    )
