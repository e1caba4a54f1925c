"""Port vs reference: the NMS kernel's plain version, decode+NMS, the plain
per-class NMS and the golden detections. The CUDA kernel itself is tested
against its plain version in tests/test_torch_cuda.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.kernels import nms_pallas
from object_detector_tpu.ops import nms as ref_nms
from object_detector_tpu_torch.anchors.priors import ssd_anchors
from object_detector_tpu_torch.core.config import tiny_test_config
from object_detector_tpu_torch.kernels import nms as nms_kernel
from object_detector_tpu_torch.ops import nms

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_detections.npz")


def _rows_case(kind, rows, k, seed):
    """(coords (4, R, k), scores (R, k)) float32 for one kernel-contract case."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (2, rows, k))
    wh = rng.uniform(0.02, 0.3, (2, rows, k))
    coords = np.concatenate([xy, np.minimum(xy + wh, 1.0)]).astype(np.float32)
    scores = rng.uniform(0, 1, (rows, k)).astype(np.float32)
    if kind == "ties":
        # Few distinct scores and duplicated boxes: argmax ties everywhere.
        scores = (rng.integers(0, 5, (rows, k)) / 4.0).astype(np.float32)
        coords[:, :, 1::2] = coords[:, :, 0::2]
    elif kind == "degenerate":
        coords[2, :, ::3] = coords[0, :, ::3]  # zero width
        coords[3, :, 1::3] = coords[1, :, 1::3]  # zero height
        coords[2, :, 2::5] = coords[0, :, 2::5] * 0.5  # inverted: x2 < x1
        coords[:, :, 4::7] = 0.0  # empty boxes at the origin
    elif kind == "dead_rows":
        scores *= rng.uniform(0, 1, (rows, k)) > 0.8
        scores[::3] = 0.0
    elif kind == "negative":
        # Outside decode's [0, 1]: the winner's corners are max(x[w], 0).
        coords -= 0.4
    elif kind == "below_threshold":
        scores *= 0.009
    elif kind == "sparse":
        scores = np.where(rng.uniform(0, 1, (rows, k)) < 0.01, scores, scores * 0.005)
        scores = scores.astype(np.float32)
    return coords, scores


ROW_CASES = [
    # kind, R, k, max_out, iou_threshold
    ("ties", 300, 128, 100, 0.45),
    ("degenerate", 37, 256, 16, 0.5),
    ("dead_rows", 260, 128, 64, 0.45),
    ("below_threshold", 20, 128, 16, 0.5),
    ("dense", 300, 256, 100, 0.5),
    ("sparse", 513, 128, 50, 0.45),
    ("negative", 64, 128, 32, 0.5),
]


@pytest.mark.parametrize("kind,rows,k,max_out,iou", ROW_CASES)
def test_nms_rows_reference_bit_equal_to_pallas(kind, rows, k, max_out, iou):
    coords, scores = _rows_case(kind, rows, k, seed=rows + k)
    kw = dict(max_out=max_out, iou_threshold=iou, score_threshold=0.01)
    want_s, want_c = nms_pallas._nms_rows(
        jnp.asarray(coords), jnp.asarray(scores), interpret=True, **kw
    )
    got_s, got_c = nms_kernel.nms_rows_reference(
        torch.from_numpy(coords), torch.from_numpy(scores), **kw
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_nms_rows_on_cpu_runs_the_plain_version():
    coords, scores = _rows_case("dense", 40, 128, seed=3)
    kw = dict(max_out=20, iou_threshold=0.45, score_threshold=0.01)
    before = nms_kernel.nms_rows.launches
    got = nms_kernel.nms_rows(torch.from_numpy(coords), torch.from_numpy(scores), **kw)
    want = nms_kernel.nms_rows_reference(torch.from_numpy(coords), torch.from_numpy(scores), **kw)
    assert nms_kernel.nms_rows.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _logits_offsets(rng, batch, num_anchors, num_classes):
    cls = rng.normal(-4.0, 1.5, (batch, num_anchors, num_classes)).astype(np.float32)
    box = rng.normal(0, 0.5, (batch, num_anchors, 4)).astype(np.float32)
    return cls, box


@pytest.mark.parametrize("pre_nms_top_k", [64, 200])  # M=128 < A=320; M=400 >= A
def test_decode_nms_matches_pallas_decode_nms(pre_nms_top_k):
    cfg = tiny_test_config()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    cls, box = _logits_offsets(np.random.default_rng(pre_nms_top_k), 3, anchors.shape[0], 3)
    kw = dict(
        score_threshold=0.01, iou_threshold=0.45, pre_nms_top_k=pre_nms_top_k,
        max_detections=40, max_per_class=20, center_variance=0.1, size_variance=0.2,
        exact_prefilter=True,
    )
    want = nms_pallas.pallas_decode_nms(
        jnp.asarray(cls), jnp.asarray(box), jnp.asarray(anchors), interpret=True, **kw
    )
    got = nms_kernel.decode_nms(
        torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(anchors), **kw
    )
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    # sigmoid and exp may differ by an ulp between XLA:CPU and torch.
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pre_nms_top_k", [32, 256])
def test_decode_nms_takes_bf16_logits_as_the_reference_does(pre_nms_top_k):
    """The int8 heads of ssd512_resnet50_coco emit bf16 class logits: the
    prefilter selects on them at that type (ties between equal bf16 maxima
    go to the lower anchor in both) and the sigmoid runs in float32 on the
    gathered candidates. 32: the prefilter cuts 320 anchors to 64."""
    cfg = tiny_test_config()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    cls, box = _logits_offsets(np.random.default_rng(3), 3, anchors.shape[0], 3)
    cls16 = torch.from_numpy(cls).to(torch.bfloat16)
    kw = dict(
        score_threshold=0.01, iou_threshold=0.45, pre_nms_top_k=pre_nms_top_k,
        max_detections=40, max_per_class=20, center_variance=0.1, size_variance=0.2,
        exact_prefilter=True,
    )
    want = nms_pallas.pallas_decode_nms(
        jnp.asarray(cls16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(box),
        jnp.asarray(anchors), interpret=True, **kw
    )
    got = nms_kernel.decode_nms(cls16, torch.from_numpy(box), torch.from_numpy(anchors), **kw)
    assert got.valid.any() and got.scores.dtype == torch.float32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)
    # The same logits in float32 give the same detections: bf16 values are float32 values.
    same = nms_kernel.decode_nms(cls16.float(), torch.from_numpy(box), torch.from_numpy(anchors),
                                 **kw)
    assert torch.equal(same.scores, got.scores) and torch.equal(same.boxes, got.boxes)


def test_decode_nms_at_retinanet_s_prefilter_regime():
    """retinanet_fpn_coco's postprocess: exact_prefilter=False, bf16 class
    logits on a coarse grid (the class-agnostic maxima tie across many of the
    3069 anchors of 128 px), 2 * pre_nms_top_k = 128 candidates of them. The
    plain scan through decode_nms against pallas_decode_nms in interpret mode
    (lax.top_k, ties to the lower anchor): the same candidates, scores and
    classes bit for bit, the boxes within 1e-6 (decode's exp may round an
    ulp apart between XLA:CPU and torch, as in the tests above)."""
    from object_detector_tpu_torch.anchors.priors import retinanet_anchors

    anchors = retinanet_anchors(128)
    rng = np.random.default_rng(17)
    cls = (rng.integers(-48, 8, (2, anchors.shape[0], 3)) / 8.0).astype(np.float32)
    box = rng.normal(0, 0.5, (2, anchors.shape[0], 4)).astype(np.float32)
    cls16 = torch.from_numpy(cls).to(torch.bfloat16)
    assert torch.equal(cls16.float(), torch.from_numpy(cls))  # the grid is exact in bf16
    top = cls.max(axis=-1)
    assert (top == top.max(axis=-1, keepdims=True)).sum(axis=-1).min() > 128  # ties past M
    kw = dict(
        score_threshold=0.01, iou_threshold=0.5, pre_nms_top_k=64, max_detections=32,
        max_per_class=100, center_variance=0.1, size_variance=0.2, exact_prefilter=False,
    )
    want = nms_pallas.pallas_decode_nms(
        jnp.asarray(cls).astype(jnp.bfloat16), jnp.asarray(box), jnp.asarray(anchors),
        interpret=True, **kw
    )
    got = nms_kernel.decode_nms(cls16, torch.from_numpy(box), torch.from_numpy(anchors),
                                rows_fn=nms_kernel.nms_rows_reference, **kw)
    assert got.valid.all()
    for name in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)


def test_per_class_nms_matches_reference():
    rng = np.random.default_rng(5)
    batch, num_anchors, num_classes = 2, 300, 4
    xy = rng.uniform(0, 0.8, (batch, num_anchors, 2))
    boxes = np.concatenate(
        [xy, np.minimum(xy + rng.uniform(0.05, 0.3, (batch, num_anchors, 2)), 1.0)], -1
    ).astype(np.float32)
    scores = (rng.uniform(0, 1, (batch, num_anchors, num_classes))
              * (rng.uniform(0, 1, (batch, num_anchors, num_classes)) > 0.6)).astype(np.float32)
    kw = dict(score_threshold=0.05, iou_threshold=0.5, pre_nms_top_k=128, max_detections=64)
    got = nms.per_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jax.vmap(lambda b, s: ref_nms.per_class_nms(b, s, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores)
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)


@pytest.mark.parametrize("prefix,use_pallas", [("", False), ("pallas_", True)])
def test_golden_detections_through_the_port(prefix, use_pallas):
    """The reference's golden fixture (tests/test_golden.py) reproduced by the
    port's own tiny pipeline, with the weights carried across."""
    from object_detector_tpu.data.synthetic import make_synthetic_dataset, render_synthetic_image
    from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
    from object_detector_tpu_torch.convert import flatten_tree, params_from_jax
    from object_detector_tpu_torch.models.ssd import SSDModel
    from object_detector_tpu_torch.ops.augment import normalize
    from object_detector_tpu_torch.ops.postprocess import postprocess

    from object_detector_tpu.core.config import tiny_test_config as ref_tiny_test_config

    golden = np.load(FIXTURE)
    cfg = tiny_test_config()
    variables = RefSSDModel(ref_tiny_test_config()).init(jax.random.key(123), jnp.zeros((1, 64, 64, 3)), train=False)
    model = SSDModel(cfg)
    model.load_state_dict(params_from_jax(flatten_tree(variables["params"])))
    ds = make_synthetic_dataset(num_images=2, image_size=cfg.model.image_size, seed=7)
    img = render_synthetic_image(ds.records[0], cfg.model.image_size)
    anchors = torch.from_numpy(ssd_anchors(cfg.anchors, cfg.model.image_size))
    with torch.no_grad():
        cls, box = model(normalize(torch.from_numpy(img)[None].float() / 255.0))
    det = postprocess(cls, box, anchors, cfg, use_pallas=use_pallas)
    valid = det.valid[0].numpy()
    g_valid = golden[f"{prefix}valid"]
    np.testing.assert_array_equal(valid, g_valid)
    np.testing.assert_array_equal(det.classes[0].numpy()[valid], golden[f"{prefix}classes"][g_valid])
    np.testing.assert_allclose(det.scores[0].numpy()[valid], golden[f"{prefix}scores"][g_valid], atol=1e-4)
    np.testing.assert_allclose(det.boxes[0].numpy()[valid], golden[f"{prefix}boxes"][g_valid], atol=1e-4)


@pytest.mark.parametrize(
    "knob", [{"packed_sort": True}, {"class_top_k": 128}, {"coord_bf16": True}]
)
def test_unported_nms_knobs_raise(knob):
    """Each knob of the NMS path, once refused, now runs through decode_nms
    (one image, 320 anchors, M = 320 so the 384-column rows narrow to 128
    under class_top_k) and agrees with pallas_decode_nms in interpret mode:
    packed_sort and class_top_k with valid and classes bit for bit, scores
    and boxes within 1e-6 (sigmoid and exp may round an ulp apart);
    coord_bf16 within the reference's own bound for it, a Jaccard index
    above 0.97 of the (class, score) set, since the reference's interpret
    mode does not round its fused bfloat16 operations one by one
    (tests/test_torch_nms_knobs.py holds the scan itself bit for bit)."""
    cls, box = _logits_offsets(np.random.default_rng(0), 1, 320, 3)
    anchors = ssd_anchors(tiny_test_config().anchors, 64)
    kw = dict(score_threshold=0.01, iou_threshold=0.45, pre_nms_top_k=160, max_detections=60,
              max_per_class=30, exact_prefilter=True, **knob)
    got = nms_kernel.decode_nms(
        torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(anchors), **kw
    )
    want = nms_pallas.pallas_decode_nms(
        jnp.asarray(cls), jnp.asarray(box), jnp.asarray(anchors), interpret=True, **kw
    )
    assert got.valid.sum() > 20
    if "coord_bf16" in knob:
        def pairs(det):
            v = np.asarray(det.valid)
            return set(zip(np.asarray(det.classes)[v].tolist(),
                           np.round(np.asarray(det.scores)[v], 5).tolist()))

        a, b = pairs(got), pairs(want)
        assert len(a & b) / len(a | b) > 0.97
        return
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)


def test_unported_per_level_heads_raises():
    """eval.per_level_heads, once refused on the kernel path, is read only by
    the int8 serving path (make_int8_predict_fn); the float postprocess
    ignores it, as the reference's make_predict_fn does
    (eval/evaluator.py:19-30): the same detections with it on and off."""
    from object_detector_tpu_torch.ops.postprocess import postprocess

    cfg = tiny_test_config()
    cls, box = _logits_offsets(np.random.default_rng(0), 1, 320, 3)
    anchors = torch.from_numpy(ssd_anchors(cfg.anchors, 64))
    args = (torch.from_numpy(cls), torch.from_numpy(box), anchors)
    want = postprocess(*args, cfg, use_pallas=True)
    got = postprocess(*args, cfg.override({"eval.per_level_heads": True}), use_pallas=True)
    assert want.valid.any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
