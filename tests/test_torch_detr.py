"""DETR-DC5 on the port (``models/detr.py``, ``quant/engine.py``
`detr_int8_forward`, the DETR branch of ``eval/evaluator.py`` and
``ops/postprocess.py`` `detr_postprocess`) against the benchmark's plain
float32 reference (``port_bench/reference/detr.py``), on a tiny DETR on the
CPU: a 128 px canvas, d_model 64, 4 heads, 2 + 2 layers, 10 queries, 5
classes, DC5 on, with the benchmark's seeded weights."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.eval.evaluator import make_int8_predict_fn, make_predict_fn
from object_detector_tpu_torch.models import detr
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.ops.augment import normalize
from object_detector_tpu_torch.ops.postprocess import detr_postprocess
from object_detector_tpu_torch.quant import engine
from port_bench.detr_weights import make_weights
from port_bench.reference import detr as ref

torch.set_num_threads(2)

INIT = {"cls_gain": 3.0, "box_gain": 1.0, "bias_std": 0.1, "qk_gain": 2.0}
# (h, w) of the test batch's images on the 128 px canvas: landscape,
# portrait, the whole canvas, a small one.
EXTENTS = np.array([[96, 128], [128, 96], [128, 128], [40, 70]])
# The int8 path against the float32 reference: the trunk's int8 codes and
# the transformer in bfloat16 move the served score of a query and a box
# corner (0.023 and 1.28 px read on the fixture's images; 0.064 and 1.39 px
# on another seed's); the tolerances leave about twice that. A fault of the
# mask, the positions or the box scaling moves them by tenths and by tens of
# pixels.
INT8_SCORE_TOL = 0.12
INT8_BOX_TOL_PX = 4.0
# The float path in bfloat16 (the preset's compute dtype) against the
# float32 reference: 0.0067 in score and 0.97 px read over three seeds'
# weights and images; the tolerances leave about three times that.
BF16_SCORE_TOL = 0.02
BF16_BOX_TOL_PX = 2.5


def _arch(cfg):
    return json.loads(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                  for k in ("model", "eval", "transformer")}))


@pytest.fixture(scope="module")
def tiny():
    cfg = config.tiny_detr_config()
    arch = _arch(cfg)
    weights = make_weights(arch, INIT, 2 ** 40 + 19, "cpu")
    gen = torch.Generator().manual_seed(7)
    images = torch.randint(0, 256, (len(EXTENTS), 128, 128, 3), generator=gen,
                           dtype=torch.uint8)
    extents = torch.as_tensor(EXTENTS)
    ref_logits, ref_boxes = ref.outputs(weights, images, extents, arch)
    return dataclasses.make_dataclass("Tiny", ["cfg", "arch", "weights", "images", "extents",
                                               "ref_logits", "ref_boxes"])(
        cfg, arch, weights, images, extents, ref_logits, ref_boxes)


def _canvases(images, extents):
    x = normalize(images.float() / 255.0)
    return x * ~ref.canvas_mask(extents, *images.shape[1:3])[..., None]


def test_the_layout_is_the_references():
    for cfg in (config.tiny_detr_config(), config.get_config("detr_r50_dc5_coco")):
        with torch.device("meta"):
            model = build_model(cfg)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert want == {n: tuple(s) for n, s, _ in ref.param_spec(_arch(cfg))}
    n = sum(math.prod(s) for name, s, _ in ref.param_spec(_arch(cfg)) if "running" not in name)
    assert 41e6 < n < 42e6  # Table 1: 41M


def test_the_dc5_trunk_keeps_stride_16_and_dilates_stage_4():
    cfg = config.tiny_detr_config()
    spec = engine.build_resnet_trunk_spec(dilate_c5=True)
    convs = {op.path: op for op in spec if isinstance(op, engine.ConvOp)}
    fused = {op.base for op in spec if isinstance(op, engine.BottleneckOp)}
    assert convs["backbone/stage4_block1/conv2"].stride == 1
    assert convs["backbone/stage4_block1/proj"].stride == 1
    for block in (2, 3):
        assert convs[f"backbone/stage4_block{block}/conv2"].dilation == 2
        assert f"backbone/stage4_block{block}" not in fused
    assert len(fused) == 2 + 3 + 5  # stages 1 to 3 keep the bottleneck kernel
    assert detr.trunk_feature_size(128, True) == 8 and detr.trunk_feature_size(1088, True) == 68
    with torch.no_grad():
        c5 = build_model(cfg).backbone(torch.zeros(1, 3, 128, 128))[-1]
    assert tuple(c5.shape) == (1, 2048, 8, 8)


def test_the_mask_and_the_sine_encoding_by_hand():
    # 64 px canvas, 4 x 4 feature map: a cell samples the canvas at 16 i;
    # an image 40 high keeps rows 0, 16, 32, and one 17 wide columns 0, 16.
    mask = detr.feature_mask(torch.tensor([[40, 64], [64, 17]]), (64, 64), (4, 4))
    assert mask[0].tolist() == [[False] * 4] * 3 + [[True] * 4]
    assert mask[1].tolist() == [[False, False, True, True]] * 4
    # A 2 x 2 map, all of it the image, d_model 4: y and x count 1, 2,
    # normalized to pi and 2 pi; dim_t is 1 for both features of each axis.
    pos = detr.sine_position(torch.zeros(1, 2, 2, dtype=torch.bool), 4)
    e = lambda c: c / (2 + 1e-6) * 2 * math.pi  # noqa: E731
    want = [[math.sin(e(y)), math.cos(e(y)), math.sin(e(x)), math.cos(e(x))]
            for y in (1, 2) for x in (1, 2)]
    np.testing.assert_allclose(pos[0].numpy(), want, rtol=1e-6, atol=1e-6)


def test_the_mask_and_the_sine_encoding_are_detrs():
    gen = torch.Generator().manual_seed(3)
    extents = torch.stack([torch.randint(1, 129, (6,), generator=gen),
                           torch.randint(1, 129, (6,), generator=gen)], 1)
    full = ref.canvas_mask(extents, 128, 128)
    for hw in ((8, 8), (5, 7), (68, 68)):
        want = F.interpolate(full[None].float(), size=hw).to(torch.bool)[0]
        got = detr.feature_mask(extents, (128, 128), hw)
        assert torch.equal(got, want), hw
        pos = detr.sine_position(got, 64)
        want_pos = ref.position_encoding(want, 64).flatten(2).transpose(1, 2)
        np.testing.assert_allclose(pos.numpy(), want_pos.numpy(), rtol=0, atol=1e-5)


def test_the_float_path_is_the_reference_in_float32(tiny):
    model = build_model(tiny.cfg)
    model.load_state_dict(tiny.weights)
    model.eval()
    with torch.no_grad():
        logits, boxes = model(_canvases(tiny.images, tiny.extents), tiny.extents)
    np.testing.assert_allclose(logits.numpy(), tiny.ref_logits.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), tiny.ref_boxes.numpy(), rtol=0, atol=1e-4)
    predict = make_predict_fn(tiny.cfg, model, None, device="cpu")
    det = predict(tiny.images.numpy(), EXTENTS)
    corners, scores, labels = ref.postprocess(tiny.ref_logits, tiny.ref_boxes, tiny.extents)
    np.testing.assert_allclose(det.scores.numpy(), scores.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(det.boxes.numpy(), corners.numpy(), rtol=0, atol=128 * 1e-4)
    assert torch.equal(det.classes.long(), labels) and bool(det.valid.all())


def test_the_float_path_in_bfloat16_is_the_reference_within_its_tolerance(tiny):
    cfg = tiny.cfg.override({"model.compute_dtype": "bfloat16"})
    model = build_model(cfg)
    model.load_state_dict(tiny.weights)
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    assert dtypes["transformer.encoder.layers.0.linear1.weight"] == torch.bfloat16
    assert dtypes["class_embed.weight"] == dtypes["query_embed.weight"] == torch.float32
    det = make_predict_fn(cfg, model, None, device="cpu")(tiny.images.numpy(), EXTENTS)
    corners, scores, _ = ref.postprocess(tiny.ref_logits, tiny.ref_boxes, tiny.extents)
    prob = torch.softmax(tiny.ref_logits, -1)[..., :-1]
    at_label = prob.gather(-1, det.classes.long()[..., None])[..., 0]
    assert det.scores.dtype == det.boxes.dtype == torch.float32
    assert float((det.scores - at_label).abs().max()) < BF16_SCORE_TOL
    assert float((det.scores - scores).abs().max()) < BF16_SCORE_TOL
    assert float((det.boxes - corners).abs().max()) < BF16_BOX_TOL_PX
    assert bool(det.valid.all())


@pytest.fixture(scope="module")
def int8_predict(tiny):
    return make_int8_predict_fn(tiny.cfg, tiny.weights, None, tiny.images.numpy(),
                                device="cpu", calibration_extents=EXTENTS)


def test_the_int8_path_is_the_reference_within_its_tolerance(tiny, int8_predict):
    det = int8_predict(tiny.images.numpy(), EXTENTS)
    corners, _, _ = ref.postprocess(tiny.ref_logits, tiny.ref_boxes, tiny.extents)
    prob = torch.softmax(tiny.ref_logits, -1)[..., :-1]
    at_label = prob.gather(-1, det.classes.long()[..., None])[..., 0]
    assert det.scores.shape == det.classes.shape == (len(EXTENTS), tiny.cfg.transformer.queries)
    assert float((det.scores - at_label).abs().max()) < INT8_SCORE_TOL
    assert float((det.scores - prob.amax(-1)).abs().max()) < INT8_SCORE_TOL
    assert float((det.boxes - corners).abs().max()) < INT8_BOX_TOL_PX
    assert bool(det.valid.all()) and int8_predict.spec[0] == engine.StemPoolPallasOp()


def test_an_image_is_served_alike_whatever_its_batch_mates_and_padding(tiny, int8_predict):
    images = tiny.images.clone()
    gen = torch.Generator().manual_seed(11)
    base = int8_predict(images.numpy(), EXTENTS)
    images[1:] = torch.randint(0, 256, images[1:].shape, generator=gen, dtype=torch.uint8)
    h, w = EXTENTS[0]
    images[0, h:] = 255  # image 0's padding
    images[0, :, w:] = 0
    other = int8_predict(images.numpy(), EXTENTS)
    for got, want in zip(other, base):
        assert torch.equal(got[0], want[0])
    swapped = int8_predict(images.numpy()[[1, 0, 2, 3]], EXTENTS[[1, 0, 2, 3]])
    for got, want in zip(swapped, other):
        assert torch.equal(got[1], want[0])


def test_the_postprocess_scales_boxes_by_each_extent():
    logits = torch.tensor([[[0.0, 2.0, 1.0]], [[3.0, 0.0, 5.0]]])  # 2 classes + no object
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.4]], [[0.25, 0.75, 0.5, 0.5]]])
    extents = torch.tensor([[800, 1066], [1066, 800]])  # (h, w)
    det = detr_postprocess(logits, boxes, extents)
    np.testing.assert_allclose(det.boxes.numpy(), [
        [[0.4 * 1066, 0.3 * 800, 0.6 * 1066, 0.7 * 800]],
        [[0.0, 0.5 * 1066, 0.5 * 800, 1.0 * 1066]]], rtol=1e-6)
    p0 = math.exp(2.0) / (1 + math.exp(2.0) + math.exp(1.0))
    p1 = math.exp(3.0) / (math.exp(3.0) + 1 + math.exp(5.0))
    np.testing.assert_allclose(det.scores.numpy(), [[p0], [p1]], rtol=1e-6)
    assert det.classes.tolist() == [[1], [0]] and det.classes.dtype == torch.int32
    assert bool(det.valid.all())
    got = ref.postprocess(logits, boxes, extents)
    np.testing.assert_allclose(det.boxes.numpy(), got[0].numpy(), rtol=1e-6)


def test_predict_refuses_extents_outside_the_canvas(tiny, int8_predict):
    with pytest.raises(ValueError, match="extents"):
        int8_predict(tiny.images.numpy(), np.array([[96, 129]] * len(EXTENTS)))
    with pytest.raises(ValueError, match="extents"):
        int8_predict(tiny.images.numpy(), EXTENTS[:2])
