"""The int8 serving slice as a whole against the reference: uint8 images ->
detections through `make_int8_predict_fn`, `Predictor(int8=True)` and
``predict --int8``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.anchors.priors import ssd_anchors
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import flatten_tree, init_params, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.eval.evaluator import make_int8_predict_fn
from object_detector_tpu_torch.models.ssd import SSDModel
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(seed):
    cfg, ref_cfg = config.get_config("tiny_test"), ref_config.get_config("tiny_test")
    variables = RefSSDModel(ref_cfg).init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)),
                                          train=False)
    return cfg, ref_cfg, variables, params_from_jax(flatten_tree(variables["params"]))


def _ref_scales(ref_cfg, variables, calib_u8):
    """The reference's activation scales for a uint8 calibration batch."""
    calib = ref_augment.normalize(jnp.asarray(calib_u8).astype(jnp.float32) / 255.0)
    spec = ref_engine.build_spec(ref_cfg)
    return ref_engine.calibrate_scales(variables["params"], spec, [calib])


def _assert_detections_match(got, want):
    """valid and classes equal; scores and boxes within 1e-4. Both engines
    run on the same scales here. The reference's jitted program contracts
    the requant epilogue into an FMA, divides by a constant scale as a
    reciprocal multiply and takes XLA's rsqrt: on these inputs none of that
    moved a detection by 1e-4."""
    valid = got.valid.numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=1e-4)


def _inputs():
    rng = np.random.default_rng(10)
    calib = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    return calib, images


@pytest.mark.parametrize("use_pallas", [True, False])
def test_int8_predict_fn_matches_reference(use_pallas, monkeypatch):
    """The whole slice, uint8 in to detections out, on the reference's
    scales (calibration alone is held in test_torch_quant.py)."""
    cfg, ref_cfg, variables, params = _tiny(seed=9)
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    calib, images = _inputs()
    want = ref_evaluator.make_int8_predict_fn(ref_cfg, variables, anchors, calib, use_pallas)(
        jnp.asarray(images)
    )
    scales = _ref_scales(ref_cfg, variables, calib)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    predict = make_int8_predict_fn(cfg, params, anchors, calib, use_pallas, device="cpu")
    assert predict.qp.act_scale == scales
    _assert_detections_match(predict(images), want)


def test_int8_predict_fn_own_calibration_close_to_reference():
    """Each engine calibrating itself: the scales agree within rtol 1e-5
    (about 1e-6 observed: the float32 convs sum in another order), and an
    ulp of scale flips codes at rounding boundaries, which then propagate.
    Observed on these inputs: logits apart by 0.011 on average and 0.073 at
    most, half the reference's own int8-vs-float band (p99 < 0.15,
    tests/test_quant.py:36-46); too much for near-tied detections to keep
    their order, so this compares the logits."""
    cfg, ref_cfg, variables, params = _tiny(seed=9)
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    calib, images = _inputs()
    predict = make_int8_predict_fn(cfg, params, anchors, calib, device="cpu")
    scales = _ref_scales(ref_cfg, variables, calib)
    assert set(predict.qp.act_scale) == set(scales)
    for key, want in scales.items():
        assert predict.qp.act_scale[key] == pytest.approx(want, rel=1e-5), key
    x = ref_augment.normalize(jnp.asarray(images).astype(jnp.float32) / 255.0)
    ref_qp = ref_engine.quantize_params(variables["params"], ref_engine.build_spec(ref_cfg),
                                        scales)
    want = jax.jit(lambda im: ref_engine.int8_forward(ref_qp, ref_engine.build_spec(ref_cfg),
                                                      ref_cfg, im))(x)
    got = engine.int8_forward(predict.qp, predict.spec, cfg, torch.tensor(np.asarray(x)))
    for g, w in zip(got, want):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= 0.15 and diff.mean() <= 0.02, (diff.max(), diff.mean())
    det = predict(images)
    assert det.boxes.shape == (4, cfg.eval.max_detections, 4)
    assert torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()


def _scene(h=90, w=120):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    img[20:60, 30:90] = (220, 40, 40)
    return img


def test_int8_predictor_matches_reference_predictor(monkeypatch):
    """On the reference's scales for the default calibration batch, as
    test_int8_predict_fn_matches_reference."""
    from object_detector_tpu.cli.predictor import Predictor as RefPredictor

    cfg, ref_cfg, variables, params = _tiny(seed=13)
    img = _scene()
    default_calib = np.random.default_rng(0).integers(0, 255, (8, 64, 64, 3), dtype=np.uint8)
    scales = _ref_scales(ref_cfg, variables, default_calib)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    want = RefPredictor(ref_cfg, variables, int8=True).predict_array(img, score_threshold=0.0)
    got = Predictor(cfg, params, device="cpu", int8=True).predict_array(img, score_threshold=0.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        assert abs(g.score - w.score) <= 1e-4
        np.testing.assert_allclose(g.box, w.box, atol=1e-4 * 120)


def test_cli_predict_int8_runs_on_cpu(tmp_path):
    from PIL import Image

    image = tmp_path / "scene.png"
    Image.fromarray(_scene()).save(image)
    proc = subprocess.run(
        [sys.executable, "-m", "object_detector_tpu_torch", "predict", "--preset", "tiny_test",
         "--int8", "--device", "cpu", "--image", str(image), "--score-threshold", "0.0",
         "--set", "eval.max_detections=8"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert 0 < len(lines) <= 8
    assert set(lines[0]) == {"class", "score", "box"} and len(lines[0]["box"]) == 4


def test_int8_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    cfg = config.get_config("tiny_test")
    params = init_params(SSDModel(cfg), seed=0).state_dict()
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    calib = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_int8_predict_fn(cfg, params, anchors, calib)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, params, int8=True)
