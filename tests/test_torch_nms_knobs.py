"""Port vs reference: the serving knobs of the NMS path. `ops.packsort`,
``class_top_k``, ``packed_sort`` and ``coord_bf16`` through `decode_nms` and
`per_class_nms_batched`, and the scan's bfloat16-coordinate plain version.
The CUDA instantiation itself is held against that plain version in
tests/test_torch_cuda.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from object_detector_tpu.kernels import nms_pallas
from object_detector_tpu.ops import nms as ref_nms
from object_detector_tpu.ops import packsort as ref_packsort
from object_detector_tpu_torch.anchors.priors import ssd_anchors
from object_detector_tpu_torch.core.config import tiny_test_config
from object_detector_tpu_torch.kernels import nms as nms_kernel
from object_detector_tpu_torch.ops import packsort

torch.set_num_threads(2)

# An IoU threshold whose t / (1 + t), rounded straight from double to
# bfloat16, is 0.1259765625, but 0.125 when rounded through float32 first,
# as the reference's ml_dtypes scalar is.
IOU_DOUBLE_ROUNDING = 0.1434952540480179


# ---------------------------------------------------------------------------
# ops/packsort.py
# ---------------------------------------------------------------------------

def _packsort_case(kind, rng):
    if kind == "negatives_and_zeros":
        return np.concatenate([
            rng.normal(0, 10, 500).astype(np.float32),
            np.float32([0.0, -0.0, 1e-38, -1e-38, 3.4e38, -3.4e38, np.inf, -np.inf]),
        ])[None]
    if kind == "separated":  # no two values share a tie bucket
        vals = rng.permutation(512).astype(np.float32) - 200.0
        return np.stack([vals, vals[::-1].copy()])
    if kind == "ties":
        return np.float32([[1.0, 5.0, 5.0, 5.0, 0.5, 5.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    # bucket collisions: uniform [0, 1) scores share buckets of the low bits
    return rng.uniform(0, 1, (4, 8732)).astype(np.float32)


def test_sortable_int_bit_equal_to_reference():
    x = _packsort_case("negatives_and_zeros", np.random.default_rng(0))
    got = packsort.sortable_int(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_packsort.sortable_int(jnp.asarray(x))))


@pytest.mark.parametrize("kind,k,idx_bits", [
    ("negatives_and_zeros", 100, None), ("separated", 37, None), ("ties", 4, None),
    ("collisions", 512, None), ("collisions", 300, 16),
])
def test_top_k_packed_idx_bit_equal_to_reference(kind, k, idx_bits):
    """Exactly the reference's indices, tie buckets included (the same key
    and a sort of distinct keys)."""
    x = _packsort_case(kind, np.random.default_rng(1))
    got = packsort.top_k_packed_idx(torch.from_numpy(x), k, idx_bits)
    want = ref_packsort.top_k_packed_idx(jnp.asarray(x), k, idx_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,idx_bits", [(7, None), (2, 2)])
def test_top_k_packed_errors_are_the_reference_s(k, idx_bits):
    x = np.zeros((1, 6), np.float32)
    with pytest.raises(ValueError) as want:
        ref_packsort.top_k_packed_idx(jnp.asarray(x), k, idx_bits)
    with pytest.raises(ValueError) as got:
        packsort.top_k_packed_idx(torch.from_numpy(x), k, idx_bits)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Decoded boxes: per_class_nms_batched against pallas_per_class_nms_batched
# ---------------------------------------------------------------------------

def _scene(rng, batch, num_anchors, num_classes, grid=False):
    boxes = rng.uniform(0, 0.9, (batch, num_anchors, 4)).astype(np.float32)
    boxes[..., 2:] = np.clip(boxes[..., :2] + rng.uniform(0.05, 0.3, (batch, num_anchors, 2)),
                             0, 1)
    scores = rng.uniform(0, 1, (batch, num_anchors, num_classes))
    if grid:  # coarse values: no packed-key tie bucket holds two scores
        scores = rng.integers(0, 1000, scores.shape) / 1000.0
    scores = (scores * (rng.uniform(0, 1, scores.shape) > 0.5)).astype(np.float32)
    return boxes, scores


def _assert_same(got, want):
    """Every field of two Detections equal (no float op differs: the boxes
    are the inputs, the scores gathered ones)."""
    for name in ("valid", "classes", "scores", "boxes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("knobs", [
    {}, {"class_top_k": 128}, {"class_top_k": 256}, {"class_top_k": 4096},
    {"packed_sort": True}, {"packed_sort": True, "class_top_k": 128},
])
def test_per_class_nms_batched_matches_reference(knobs):
    """2 x 600 anchors, 4 classes, M = 512: the class-agnostic prefilter,
    the narrowing to 128 or 256 columns (4096: wider than the row, a no-op)
    and the packed sorts, bit for bit against the Pallas kernel in
    interpret mode."""
    boxes, scores = _scene(np.random.default_rng(3), 2, 600, 4, grid=True)
    kw = dict(score_threshold=0.02, iou_threshold=0.5, pre_nms_top_k=256, max_detections=64,
              max_per_class=40, **knobs)
    want = nms_pallas.pallas_per_class_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                                   interpret=True, **kw)
    got = nms_kernel.per_class_nms_batched(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    assert got.valid.sum() > 20
    _assert_same(got, want)


def test_class_top_k_off_equals_large_and_narrows_as_the_truncated_oracle():
    """The reference's two class_top_k oracles (tests/test_nms_pallas.py:
    213-241): class_top_k at least the lane-rounded M is a no-op; with
    M >= A, narrowing to k2 equals the plain per-class NMS truncated to
    pre_nms_top_k = k2, as a set of (class, score, box)."""
    boxes, scores = _scene(np.random.default_rng(4), 1, 384, 3)
    scores = np.random.default_rng(5).uniform(0.02, 1.0, scores.shape).astype(np.float32)
    b, s = torch.from_numpy(boxes[:1]), torch.from_numpy(scores[:1])
    kw = dict(score_threshold=0.01, iou_threshold=0.5, max_detections=64, max_per_class=64)
    base = nms_kernel.per_class_nms_batched(b, s, pre_nms_top_k=384, **kw)
    same = nms_kernel.per_class_nms_batched(b, s, pre_nms_top_k=384, class_top_k=4096, **kw)
    for x, y in zip(base, same):
        assert torch.equal(x, y)
    got = nms_kernel.per_class_nms_batched(b, s, pre_nms_top_k=384, class_top_k=128, **kw)
    want = ref_nms.per_class_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                 score_threshold=0.01, iou_threshold=0.5, pre_nms_top_k=128,
                                 max_detections=64)

    def as_set(det):
        v = np.asarray(det.valid)
        return {(int(c), round(float(sc), 5), tuple(np.round(np.asarray(bx), 5)))
                for c, sc, bx in zip(np.asarray(det.classes)[v], np.asarray(det.scores)[v],
                                     np.asarray(det.boxes)[v])}

    assert len(as_set(got)) > 10 and as_set(got) == as_set(want)


# ---------------------------------------------------------------------------
# Raw head outputs: decode_nms against pallas_decode_nms
# ---------------------------------------------------------------------------

def _logits_offsets(rng, batch, num_anchors, num_classes):
    cls = rng.normal(-4.0, 1.5, (batch, num_anchors, num_classes)).astype(np.float32)
    box = rng.normal(0, 0.5, (batch, num_anchors, 4)).astype(np.float32)
    return cls, box


@pytest.mark.parametrize("pre_nms_top_k,knobs", [
    (64, {"class_top_k": 128}),  # M = 128: the narrowing is a no-op
    (160, {"class_top_k": 128}),  # M = 320 = A, rows of 384 narrowed to 128
    (160, {"class_top_k": 256}),
    (64, {"packed_sort": True}),
    (160, {"packed_sort": True, "class_top_k": 128}),
])
def test_decode_nms_knobs_match_pallas_decode_nms(pre_nms_top_k, knobs):
    """tiny_test's 320 anchors, 3 images, 3 classes: valid and classes bit
    for bit, scores and boxes within 1e-6 (sigmoid and exp may round an ulp
    apart between XLA:CPU and torch)."""
    cfg = tiny_test_config()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    cls, box = _logits_offsets(np.random.default_rng(pre_nms_top_k + 1), 3, anchors.shape[0], 3)
    kw = dict(score_threshold=0.01, iou_threshold=0.45, pre_nms_top_k=pre_nms_top_k,
              max_detections=40, max_per_class=20, center_variance=0.1, size_variance=0.2,
              exact_prefilter=True, **knobs)
    want = nms_pallas.pallas_decode_nms(jnp.asarray(cls), jnp.asarray(box), jnp.asarray(anchors),
                                        interpret=True, **kw)
    got = nms_kernel.decode_nms(torch.from_numpy(cls), torch.from_numpy(box),
                                torch.from_numpy(anchors), **kw)
    assert got.valid.sum() > 30
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)


def test_decode_nms_narrowed_rows_reach_the_scan_as_the_reference_s():
    """With class_top_k the scan gets each row's top k2 columns, ties to
    the lower column, and its columns are mapped back: the rows the port's
    scan sees equal the reference's narrowing of the same rows."""
    cfg = tiny_test_config()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    cls, box = _logits_offsets(np.random.default_rng(8), 2, anchors.shape[0], 3)
    seen = {}

    def capture(coords, scores, **kwargs):
        seen.update(coords=coords, scores=scores)
        return nms_kernel.nms_rows(coords, scores, **kwargs)

    full = {}

    def capture_full(coords, scores, **kwargs):
        full.update(coords=coords, scores=scores)
        return nms_kernel.nms_rows(coords, scores, **kwargs)

    kw = dict(pre_nms_top_k=160, max_detections=40, max_per_class=20)
    args = (torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(anchors))
    nms_kernel.decode_nms(*args, class_top_k=128, rows_fn=capture, **kw)
    nms_kernel.decode_nms(*args, rows_fn=capture_full, **kw)
    assert tuple(seen["scores"].shape) == (6, 128) and tuple(full["scores"].shape) == (6, 384)
    want_s, want_idx = jax.lax.top_k(jnp.asarray(full["scores"].numpy()), 128)
    np.testing.assert_array_equal(seen["scores"].numpy(), np.asarray(want_s))
    want_coords = np.take_along_axis(full["coords"].numpy(), np.asarray(want_idx)[None], axis=2)
    np.testing.assert_array_equal(seen["coords"].numpy(), want_coords)


# ---------------------------------------------------------------------------
# bfloat16 coordinates
# ---------------------------------------------------------------------------

class _Ref:
    """An array standing in for a Pallas ref: `ref[:]` reads it, `ref[:] = v`
    replaces it."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, index):
        return self.value

    def __setitem__(self, index, value):
        self.value = value


def _reference_kernel_op_by_op(coords, scores, *, max_out, iou_threshold, score_threshold):
    """The reference's `_nms_kernel` body itself, each jnp operation run
    eagerly (`jax.disable_jit`), on all rows at once: every bfloat16
    operation rounds to bfloat16, as the TPU kernel computes. The
    reference's pallas_call in interpret mode does not: it keeps float32
    between fused bfloat16 operations on XLA:CPU, with or without
    `jax.disable_jit`."""
    rows, k = scores.shape
    refs = [_Ref(jnp.asarray(c)) for c in coords] + [_Ref(jnp.asarray(scores))]
    out_s, out_c = _Ref(), _Ref()
    with jax.disable_jit():
        nms_pallas._nms_kernel(*refs, out_s, out_c, k=k, rows=rows, max_out=max_out,
                               iou_threshold=iou_threshold, score_threshold=score_threshold)
    return np.asarray(out_s.value), np.asarray(out_c.value)


def _rows_case(kind, rows, k, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (2, rows, k))
    wh = rng.uniform(0.02, 0.3, (2, rows, k))
    coords = np.concatenate([xy, np.minimum(xy + wh, 1.0)]).astype(np.float32)
    scores = rng.uniform(0, 1, (rows, k)).astype(np.float32)
    if kind == "ties":
        scores = (rng.integers(0, 5, (rows, k)) / 4.0).astype(np.float32)
        coords[:, :, 1::2] = coords[:, :, 0::2]
    elif kind == "degenerate":
        coords[2, :, ::3] = coords[0, :, ::3]
        coords[2, :, 2::5] = coords[0, :, 2::5] * 0.5
        coords[:, :, 4::7] = 0.0
    elif kind == "negative":
        coords -= 0.4
    return torch.from_numpy(coords).to(torch.bfloat16), scores


@pytest.mark.parametrize("kind,rows,k,max_out,iou", [
    ("dense", 16, 128, 24, 0.45),
    ("dense", 16, 128, 24, 0.5),
    ("dense", 12, 256, 16, IOU_DOUBLE_ROUNDING),
    ("ties", 12, 128, 16, 0.45),
    ("degenerate", 8, 128, 16, 0.5),
    ("negative", 8, 128, 16, 0.5),
    ("dense", 8, 1, 1, 0.45),
])
def test_bf16_rows_reference_bit_equal_to_the_reference_kernel_op_by_op(kind, rows, k, max_out,
                                                                         iou):
    """bfloat16 coordinate planes: the plain version's selections, scores
    and columns bit for bit those of the reference's kernel body run op by
    op (tolerance 0)."""
    coords16, scores = _rows_case(kind, rows, k, seed=rows * k)
    kw = dict(max_out=max_out, iou_threshold=iou, score_threshold=0.01)
    got_s, got_c = nms_kernel.nms_rows_reference(coords16, torch.from_numpy(scores), **kw)
    want_s, want_c = _reference_kernel_op_by_op(
        jnp.asarray(coords16.float().numpy()).astype(jnp.bfloat16), scores, **kw)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_bf16_t_ratio_rounds_through_float32_as_the_reference():
    t = IOU_DOUBLE_ROUNDING / (1.0 + IOU_DOUBLE_ROUNDING)
    want = float(np.dtype(ml_dtypes.bfloat16).type(t))  # the reference's cdt.type(t)
    assert nms_kernel._t_ratio(IOU_DOUBLE_ROUNDING, torch.bfloat16) == want == 0.125
    # Rounded straight from double, t would be the next bfloat16 up.
    lo, hi = 0.125, 0.125 + 2.0 ** -10
    assert abs(t - hi) < abs(t - lo)
    assert nms_kernel._t_ratio(0.45, torch.bfloat16) == 0.310546875


def test_coord_bf16_detection_set_close_to_float32_and_to_the_jitted_reference():
    """The reference's own contract for coord_bf16 (tests/test_nms_pallas.py:
    274-315): the detection set, as (class, score) pairs, has a Jaccard
    index above 0.97 against float32 coordinates. The port's bf16 run is
    held to the same bound against the reference's jitted bf16 run, whose
    interpret mode rounds its fused bfloat16 operations differently."""
    rng = np.random.default_rng(11)
    batch, anchors, classes = 4, 600, 6
    boxes = rng.uniform(0, 1, (batch, anchors, 4)).astype(np.float32)
    boxes[..., 2:] = np.clip(boxes[..., :2] + rng.uniform(0.02, 0.3, (batch, anchors, 2)), 0, 1)
    scores = (rng.uniform(0, 1, (batch, anchors, classes)) ** 6).astype(np.float32)
    kw = dict(score_threshold=0.05, iou_threshold=0.45, pre_nms_top_k=128, max_detections=50,
              max_per_class=25)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    d32 = nms_kernel.per_class_nms_batched(b, s, **kw)
    d16 = nms_kernel.per_class_nms_batched(b, s, coord_bf16=True, **kw)
    ref16 = nms_pallas.pallas_per_class_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                                    coord_bf16=True, interpret=True, **kw)

    def pairs(det):
        v = np.asarray(det.valid)
        return set(zip(np.asarray(det.classes)[v].tolist(),
                       np.round(np.asarray(det.scores)[v], 5).tolist()))

    def jaccard(a, b):
        return len(a & b) / max(len(a | b), 1)

    assert len(pairs(d16)) > 100
    assert jaccard(pairs(d16), pairs(d32)) > 0.97
    assert jaccard(pairs(d16), pairs(ref16)) > 0.97


def test_decode_nms_coord_bf16_hands_the_scan_bf16_planes():
    """coord_bf16: the scan gets the float32 path's planes rounded to
    bfloat16 (after the narrowing, as the reference casts them), float32
    scores, and the detections are the plain bf16 scan's."""
    cfg = tiny_test_config()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    cls, box = _logits_offsets(np.random.default_rng(12), 2, anchors.shape[0], 3)
    seen = []

    def capture(coords, scores, **kwargs):
        seen.append((coords, scores))
        return nms_kernel.nms_rows_reference(coords, scores, **kwargs)

    args = (torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(anchors))
    kw = dict(pre_nms_top_k=160, class_top_k=128, max_detections=40, max_per_class=20)
    det16 = nms_kernel.decode_nms(*args, coord_bf16=True, rows_fn=capture, **kw)
    nms_kernel.decode_nms(*args, rows_fn=capture, **kw)
    (c16, s16), (c32, s32) = seen
    assert c16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    assert torch.equal(c16, c32.to(torch.bfloat16)) and torch.equal(s16, s32)
    assert det16.valid.any()


def test_nms_rows_takes_float32_or_bf16_coordinates():
    coords16, scores = _rows_case("dense", 4, 128, seed=0)
    kw = dict(max_out=8, iou_threshold=0.45, score_threshold=0.01)
    before = (nms_kernel.nms_rows.launches, nms_kernel.nms_rows.bf16.launches)
    got = nms_kernel.nms_rows(coords16, torch.from_numpy(scores), **kw)
    want = nms_kernel.nms_rows_reference(coords16, torch.from_numpy(scores), **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (nms_kernel.nms_rows.launches, nms_kernel.nms_rows.bf16.launches) == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        nms_kernel.nms_rows(coords16.half(), torch.from_numpy(scores), **kw)

