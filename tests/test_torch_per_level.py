"""Port vs reference: the per-level serving path and the NMS knobs through
the SSD entry points, on tiny shapes. `decode_nms_levels` against
``pallas_decode_nms_levels`` in interpret mode, `level_slices`,
`postprocess_levels`, `int8_forward(concat_heads=False)`, and
`make_predict_fn`, `make_int8_predict_fn`, `Predictor`, `evaluate_dataset`
and ``predict`` with the knobs on (RetinaNet's per-level path is in
tests/test_torch_retinanet_quant.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.cli.predictor import Predictor as RefPredictor
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.kernels import nms_pallas
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.ops import postprocess as ref_postprocess
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.anchors.priors import level_slices, ssd_anchors
from object_detector_tpu_torch.cli.main import main
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import flatten_tree, params_from_jax, quant_params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.data.upload import StagedUpload
from object_detector_tpu_torch.eval import evaluator
from object_detector_tpu_torch.kernels import nms as nms_kernel
from object_detector_tpu_torch.models.ssd import SSDModel
from object_detector_tpu_torch.ops import postprocess
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)

# tiny_test serves through the plain NMS; the knobs are the kernel path's.
PALLAS = {"eval.use_pallas_nms": True}
# The knobs at tiny_test's size: M = 2 * 160 = 320 anchors, rows of 384
# columns narrowed to 128 by class_top_k.
KNOBS = {**PALLAS, "eval.pre_nms_top_k": 160, "eval.nms_class_top_k": 128,
         "eval.nms_packed_sort": True}


def _levels(rng, batch, num_classes, shapes, dtype=np.float32):
    """Per-level native head tensors (B, H, W, a*C) and (B, H, W, a*4), and
    center-form anchors for all of them (the reference test's
    ``_random_levels``, from a numpy seed)."""
    cls = [rng.normal(-3.0, 1.5, (batch, h, w, a * num_classes)).astype(dtype)
           for h, w, a in shapes]
    box = [rng.normal(0, 0.4, (batch, h, w, a * 4)).astype(np.float32) for h, w, a in shapes]
    anchors = rng.uniform(0.2, 0.8, (sum(h * w * a for h, w, a in shapes), 4)).astype(np.float32)
    anchors[:, 2:] = rng.uniform(0.05, 0.3, (anchors.shape[0], 2))
    return cls, box, anchors


def _assert_detections_equal(got, want, atol):
    """valid and classes bit for bit; scores and boxes within ``atol``."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=atol)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=atol)


def _jaccard_within(got, want, atol):
    """|matched| / |union| of two batches of detections, a detection of
    ``got`` matching one of ``want`` (each at most once) of the same image
    and class whose score and box are within ``atol``: the reference's
    Jaccard bound for coord_bf16 where the two sides' scores may also differ
    by float rounding."""
    matched = total = 0
    for b in range(got.valid.shape[0]):
        g_v, w_v = np.asarray(got.valid[b]), np.asarray(want.valid[b])
        g = list(zip(np.asarray(got.classes[b])[g_v], np.asarray(got.scores[b])[g_v],
                     np.asarray(got.boxes[b])[g_v]))
        w = list(zip(np.asarray(want.classes[b])[w_v], np.asarray(want.scores[b])[w_v],
                     np.asarray(want.boxes[b])[w_v]))
        for c, sc, bx in g:
            hit = next((i for i, (c2, s2, b2) in enumerate(w) if c2 == c and abs(s2 - sc) <= atol
                        and np.abs(b2 - bx).max() <= atol), None)
            if hit is not None:
                matched += 1
                w.pop(hit)
        total += int(g_v.sum()) + int(w_v.sum())
    return matched / max(total - matched, 1)


def _detection_set(det):
    out = set()
    for b in range(det.valid.shape[0]):
        v = np.asarray(det.valid[b])
        out |= {(b, int(c), round(float(s), 5), tuple(np.round(np.asarray(x), 5)))
                for c, s, x in zip(np.asarray(det.classes[b])[v], np.asarray(det.scores[b])[v],
                                   np.asarray(det.boxes[b])[v])}
    return out


# ---------------------------------------------------------------------------
# decode_nms_levels, level_slices, postprocess_levels
# ---------------------------------------------------------------------------

GATHER = ((8, 8, 4), (4, 4, 6), (2, 2, 4))  # level 0's 256 anchors > M
ALL_FIT = ((4, 4, 4), (2, 2, 6))  # every level within M: no stage-1 sort


@pytest.mark.parametrize("shapes,num_classes,pre_nms_top_k,knobs", [
    (GATHER, 5, 64, {}),
    (GATHER, 5, 100, {"class_top_k": 128}),
    (GATHER, 5, 64, {"packed_sort": True}),
    (ALL_FIT, 3, 64, {}),
    (ALL_FIT, 3, 64, {"packed_sort": True, "class_top_k": 128}),
])
def test_decode_nms_levels_matches_pallas_decode_nms_levels(shapes, num_classes, pre_nms_top_k,
                                                            knobs):
    """The reference's two per-level oracles' shapes (tests/test_nms_pallas.py:
    318-408): valid and classes bit for bit, scores and boxes within 1e-6
    (sigmoid and exp may round an ulp apart between XLA:CPU and torch); the
    same detection set as `decode_nms` on the concatenated tensors."""
    cls, box, anchors = _levels(np.random.default_rng(len(shapes)), 2, num_classes, shapes)
    apl = tuple(a for _, _, a in shapes)
    kw = dict(score_threshold=0.01, iou_threshold=0.5, pre_nms_top_k=pre_nms_top_k,
              max_detections=16, max_per_class=8, exact_prefilter=True, **knobs)
    want = nms_pallas.pallas_decode_nms_levels(
        tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, box)), jnp.asarray(anchors), apl,
        interpret=True, **kw)
    got = nms_kernel.decode_nms_levels(
        [torch.from_numpy(t) for t in cls], [torch.from_numpy(t) for t in box],
        torch.from_numpy(anchors), apl, **kw)
    assert got.valid.sum() > 10
    _assert_detections_equal(got, want, 1e-6)
    cat = nms_kernel.decode_nms(
        torch.cat([torch.from_numpy(t).reshape(2, -1, num_classes) for t in cls], 1),
        torch.cat([torch.from_numpy(t).reshape(2, -1, 4) for t in box], 1),
        torch.from_numpy(anchors), **kw)
    assert _detection_set(cat) == _detection_set(got)


@pytest.mark.parametrize("name", ["ssd300_vgg16_voc", "ssd512_resnet50_coco", "tiny_test"])
def test_level_slices_match_reference(name):
    cfg, ref_cfg = config.get_config(name), ref_config.get_config(name)
    slices = level_slices(cfg.anchors)
    assert slices == ref_priors.level_slices(ref_cfg.anchors)
    assert slices[-1][1] == ssd_anchors(cfg.anchors, cfg.model.image_size).shape[0]


@pytest.mark.parametrize("overrides", [{}, KNOBS, {"eval.nms_coord_bf16": True}])
def test_postprocess_levels_matches_reference(overrides):
    """tiny_test's six levels in their native layout, bf16 class logits as
    the int8 heads give them with eval.int8_logits_bf16: against the
    reference's postprocess_levels (interpret mode), exactly as in the test
    above; with coord_bf16 the detection set within the reference's
    Jaccard bound of 0.97 (its interpret mode keeps float32 between fused
    bfloat16 operations; tests/test_torch_nms_knobs.py holds the scan)."""
    cfg = config.get_config("tiny_test").override(overrides)
    ref_cfg = ref_config.get_config("tiny_test").override(overrides)
    shapes = [(f, f, a) for f, a in zip(cfg.anchors.feature_sizes, cfg.anchors.anchors_per_level)]
    cls, box, _ = _levels(np.random.default_rng(7), 2, cfg.model.num_classes, shapes)
    cls16 = [torch.from_numpy(t).to(torch.bfloat16) for t in cls]
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    want = ref_postprocess.postprocess_levels(
        [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in cls16],
        [jnp.asarray(t) for t in box], jnp.asarray(anchors), ref_cfg)
    got = postprocess.postprocess_levels(cls16, [torch.from_numpy(t) for t in box],
                                         torch.from_numpy(anchors), cfg)
    assert got.valid.sum() > 10
    if overrides.get("eval.nms_coord_bf16"):
        a, b = _detection_set(got), _detection_set(want)
        assert len(a & b) / len(a | b) > 0.97
    else:
        _assert_detections_equal(got, want, 1e-6)


# ---------------------------------------------------------------------------
# The int8 heads' per-level outputs and the int8 serving path
# ---------------------------------------------------------------------------

def _tiny(seed):
    cfg, ref_cfg = config.get_config("tiny_test"), ref_config.get_config("tiny_test")
    variables = RefSSDModel(ref_cfg).init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)),
                                          train=False)
    return cfg, ref_cfg, variables, params_from_jax(flatten_tree(variables["params"]))


@pytest.fixture(scope="module")
def tiny():
    cfg, ref_cfg, variables, params = _tiny(seed=9)
    rng = np.random.default_rng(10)
    calib = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    x = ref_augment.normalize(jnp.asarray(calib).astype(jnp.float32) / 255.0)
    scales = ref_engine.calibrate_scales(variables["params"], ref_engine.build_spec(ref_cfg), [x])
    return cfg, ref_cfg, variables, params, calib, images, scales


def test_int8_sweep_with_the_knobs_matches_reference(monkeypatch):
    """evaluate_dataset(int8=True) with per_level_heads, class_top_k and
    packed_sort over 8 synthetic images at batch 8, on the reference's
    scales for them: the voc07 dict within 1e-3, as
    tests/test_torch_evaluate.py holds the default.
    The reference's sweep serves each batch through its int8 forward and
    then its postprocess_levels, each jitted, with JAX's caches cleared
    before the postprocess: in a process that has run other jitted programs
    of it with packed_sort, its one jitted predict program can fail in XLA
    ("Execution supplied 1 buffers but compiled program expected 80
    buffers")."""
    overrides = {"eval.batch_size": 8, "eval.per_level_heads": True, **KNOBS}
    cfg, ref_cfg, variables, params = _tiny(seed=11)
    cfg, ref_cfg = (c.override(overrides) for c in (cfg, ref_cfg))
    dataset = make_synthetic_dataset(num_images=8, image_size=64, seed=5)
    cache = DecodedCache(dataset, 64, cfg.data.max_boxes, 1)
    calib = ref_augment.normalize(jnp.asarray(cache.images[:8]).astype(jnp.float32) / 255.0)
    spec = ref_engine.build_spec(ref_cfg)
    scales = ref_engine.calibrate_scales(variables["params"], spec, [calib])
    ref_qp = ref_engine.quantize_params(variables["params"], spec, scales)

    def ref_make_int8_predict_fn(cfg_, variables_, anchors, calib_u8, use_pallas=None):
        forward = jax.jit(lambda images_u8: ref_engine.int8_forward(
            ref_qp, spec, cfg_, ref_augment.normalize(images_u8.astype(jnp.float32) / 255.0),
            concat_heads=False))

        def predict(images_u8):
            levels = forward(jnp.asarray(images_u8))
            jax.clear_caches()
            return ref_postprocess.postprocess_levels(*levels, jnp.asarray(anchors), cfg_)
        return predict

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_evaluator, "make_int8_predict_fn", ref_make_int8_predict_fn)
        want = ref_evaluator.evaluate_dataset(ref_cfg, RefSSDModel(ref_cfg), variables, dataset,
                                              cache=cache, int8=True)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    got = evaluator.evaluate_dataset(cfg, params, dataset, cache=cache, int8=True, device="cpu")
    assert set(got) == set(want) and any(v > 0 for k, v in want.items() if k.startswith("ap/"))
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-3, (key, got[key], value)


@pytest.mark.parametrize("logits_bf16", [False, True])
def test_int8_forward_per_level_outputs_match_reference(tiny, logits_bf16):
    """int8_forward(concat_heads=False): the (B, H, W, a*C) and (B, H, W, a*4)
    tensors of each level bit for bit the reference's op-by-op
    int8_forward(concat_heads=False) (the same codes and the same float32
    epilogue; bf16 class logits the same float32 values cast), and
    concatenated bit for bit the concat path's."""
    cfg, ref_cfg, variables, params, calib, images, scales = tiny
    cfg, ref_cfg = (c.override({"eval.int8_logits_bf16": logits_bf16}) for c in (cfg, ref_cfg))
    spec = ref_engine.build_spec(ref_cfg)
    ref_qp = ref_engine.quantize_params(variables["params"], spec, scales)
    x = np.asarray(ref_augment.normalize(jnp.asarray(images).astype(jnp.float32) / 255.0))
    want_cls, want_box = ref_engine.int8_forward(ref_qp, spec, ref_cfg, jnp.asarray(x),
                                                 concat_heads=False)
    qp = quant_params_from_jax(ref_qp)
    got_cls, got_box = engine.int8_forward(qp, engine.build_spec(cfg), cfg, torch.from_numpy(x),
                                           concat_heads=False)
    assert len(got_cls) == len(want_cls) == len(cfg.anchors.feature_sizes)
    for got, want in zip(got_cls + got_box, tuple(want_cls) + tuple(want_box)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    cls_cat, box_cat = engine.int8_forward(qp, engine.build_spec(cfg), cfg, torch.from_numpy(x))
    c = cfg.model.num_classes
    assert torch.equal(torch.cat([t.reshape(4, -1, c) for t in got_cls], 1), cls_cat)
    assert torch.equal(torch.cat([t.reshape(4, -1, 4) for t in got_box], 1), box_cat)


def _assert_served_match(got, want):
    """valid and classes equal; scores and boxes within 1e-4, the int8 tests'
    tolerance: the reference's jitted int8 program contracts its epilogue
    into an FMA (tests/test_torch_int8_predict.py)."""
    valid = got.valid.numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides", [{"eval.per_level_heads": True, **PALLAS},
                                       {"eval.per_level_heads": True, **KNOBS}])
def test_int8_predict_fn_per_level_heads_matches_reference(tiny, overrides, monkeypatch):
    """make_int8_predict_fn with eval.per_level_heads (reference
    eval/evaluator.py:56-72) against the reference's, on its scales; and the
    same detection set as the concat path (reference
    tests/test_quant.py:626-664)."""
    cfg, ref_cfg, variables, params, calib, images, scales = tiny
    cfg, ref_cfg = (c.override(overrides) for c in (cfg, ref_cfg))
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    want = ref_evaluator.make_int8_predict_fn(ref_cfg, variables, anchors, calib)(
        jnp.asarray(images))
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    levels = []
    real = evaluator.postprocess_levels
    monkeypatch.setattr(evaluator, "postprocess_levels",
                        lambda *a, **k: levels.append(a[0]) or real(*a, **k))
    got = evaluator.make_int8_predict_fn(cfg, params, anchors, calib, device="cpu")(images)
    assert len(levels) == 1 and len(levels[0]) == len(cfg.anchors.feature_sizes)
    _assert_served_match(got, want)
    concat = evaluator.make_int8_predict_fn(cfg.override({"eval.per_level_heads": False}), params,
                                            anchors, calib, device="cpu")(images)
    assert _detection_set(concat) == _detection_set(got)


# ---------------------------------------------------------------------------
# The knobs through the other entry points
# ---------------------------------------------------------------------------

def _reference_scan(coords, scores, **kwargs):
    """The scan as the reference's kernel body computes it, run op by op
    (tests/test_torch_nms_knobs.py)."""
    from test_torch_nms_knobs import _reference_kernel_op_by_op

    planes = jnp.asarray(coords.float().numpy()).astype(jnp.bfloat16)
    out_s, out_c = _reference_kernel_op_by_op(planes, scores.numpy(), **kwargs)
    return torch.from_numpy(out_s), torch.from_numpy(out_c)


@pytest.mark.parametrize("overrides", [{**KNOBS, "eval.per_level_heads": True},
                                       {**PALLAS, "eval.nms_coord_bf16": True}])
def test_float_predict_fn_with_the_knobs_matches_reference(overrides):
    """The float make_predict_fn with the knobs (per_level_heads is ignored
    there, as in the reference): against the reference's, the golden
    tolerances, 1e-4. With coord_bf16 the reference's jitted program keeps
    float32 between its fused bfloat16 operations on XLA:CPU, which here
    keeps its bf16 set nearer its float32 one than the port's, rounding each
    operation as the TPU kernel does, is to the port's float32 set; so the
    served detections are held bit for bit against the port's model outputs
    through the reference's kernel body run op by op as the scan."""
    cfg, ref_cfg, variables, params = _tiny(seed=9)
    cfg, ref_cfg = (c.override(overrides) for c in (cfg, ref_cfg))
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    images = np.random.default_rng(10).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    model = SSDModel(cfg)
    model.load_state_dict(params)
    got = evaluator.make_predict_fn(cfg, model, anchors, device="cpu")(images)
    if "eval.nms_coord_bf16" in overrides:
        with torch.no_grad():
            cls, box = model(evaluator._normalized(images, StagedUpload(torch.device("cpu"))))
        want = nms_kernel.decode_nms(cls, box, torch.from_numpy(anchors), rows_fn=_reference_scan,
                                     **postprocess.nms_kwargs(cfg))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    want = ref_evaluator.make_predict_fn(ref_cfg, RefSSDModel(ref_cfg), anchors)(
        variables, jnp.asarray(images))
    _assert_served_match(got, want)


def test_int8_predictor_with_the_knobs_matches_reference_predictor(tiny, monkeypatch):
    """Predictor(int8=True) with per_level_heads, class_top_k and
    packed_sort against the reference's Predictor, on its scales for the
    default calibration batch (tolerances of
    tests/test_torch_int8_predict.py)."""
    cfg, ref_cfg, variables, params, _, _, _ = tiny
    overrides = {"eval.per_level_heads": True, **KNOBS}
    cfg, ref_cfg = (c.override(overrides) for c in (cfg, ref_cfg))
    img = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    img[20:60, 30:90] = (220, 40, 40)
    default_calib = np.random.default_rng(0).integers(0, 255, (8, 64, 64, 3), dtype=np.uint8)
    x = ref_augment.normalize(jnp.asarray(default_calib).astype(jnp.float32) / 255.0)
    scales = ref_engine.calibrate_scales(variables["params"], ref_engine.build_spec(ref_cfg), [x])
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    want = RefPredictor(ref_cfg, variables, int8=True).predict_array(img, score_threshold=0.0)
    got = Predictor(cfg, params, device="cpu", int8=True).predict_array(img, score_threshold=0.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        assert abs(g.score - w.score) <= 1e-4
        np.testing.assert_allclose(g.box, w.box, atol=1e-4 * 120)


def test_cli_predict_takes_the_knobs(tmp_path, capsys):
    """``predict --int8 --set ...`` with every serving knob on runs on the
    CPU and prints its detections."""
    from PIL import Image

    image = tmp_path / "scene.png"
    scene = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    scene[20:60, 30:90] = (220, 40, 40)
    Image.fromarray(scene).save(image)
    sets = ["eval.per_level_heads=true", "eval.nms_class_top_k=128", "eval.pre_nms_top_k=160",
            "eval.nms_packed_sort=true", "eval.nms_coord_bf16=true", "eval.use_pallas_nms=true",
            "eval.max_detections=8"]
    argv = ["predict", "--preset", "tiny_test", "--device", "cpu", "--int8", "--image",
            str(image), "--output", str(tmp_path / "out.png"), "--score-threshold", "0.0"]
    for s in sets:
        argv += ["--set", s]
    assert main(argv) in (0, None)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert 0 < len(lines) <= 8 and set(lines[0]) == {"class", "score", "box"}
