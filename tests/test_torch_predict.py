"""The port's serving slice as a whole against the reference: uint8 images
-> detections through `make_predict_fn`, the `Predictor`, and the CLI."""

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
from object_detector_tpu_torch.anchors.priors import ssd_anchors
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import flatten_tree, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.eval.evaluator import make_predict_fn
from object_detector_tpu_torch.models.ssd import SSDModel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(seed):
    cfg = config.get_config("tiny_test")
    ref_cfg = ref_config.get_config("tiny_test")
    ref_model = RefSSDModel(ref_cfg)
    variables = ref_model.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    params = params_from_jax(flatten_tree(variables["params"]))
    return cfg, ref_cfg, ref_model, variables, params


@pytest.mark.parametrize("use_pallas", [True, False])
def test_predict_fn_matches_reference(use_pallas):
    cfg, ref_cfg, ref_model, variables, params = _tiny(seed=9)
    anchors = ssd_anchors(cfg.anchors, cfg.model.image_size)
    images = np.random.default_rng(10).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    want = ref_evaluator.make_predict_fn(ref_cfg, ref_model, anchors, use_pallas)(
        variables, jnp.asarray(images)
    )
    model = SSDModel(cfg)
    model.load_state_dict(params)
    got = make_predict_fn(cfg, model, anchors, use_pallas, device="cpu")(images)
    valid = got.valid.numpy()
    assert valid.any()
    # The golden test's tolerances (tests/test_golden.py).
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid], atol=1e-4)


def _scene(h=90, w=120):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    img[20:60, 30:90] = (220, 40, 40)
    return img


def test_predictor_matches_reference_predictor():
    from object_detector_tpu.cli.predictor import Predictor as RefPredictor

    cfg, ref_cfg, _, variables, params = _tiny(seed=13)
    img = _scene()
    want = RefPredictor(ref_cfg, variables).predict_array(img, score_threshold=0.0)
    got = Predictor(cfg, params, device="cpu").predict_array(img, score_threshold=0.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        assert abs(g.score - w.score) <= 1e-4
        # Pixel boxes: normalized boxes to 1e-4, times the image size.
        np.testing.assert_allclose(g.box, w.box, atol=1e-4 * 120)


def test_cli_predict_runs_on_cpu(tmp_path):
    from PIL import Image

    image = tmp_path / "scene.png"
    Image.fromarray(_scene()).save(image)
    out = tmp_path / "out.png"
    proc = subprocess.run(
        [sys.executable, "-m", "object_detector_tpu_torch", "predict", "--preset", "tiny_test",
         "--device", "cpu", "--image", str(image), "--output", str(out),
         "--score-threshold", "0.0", "--set", "eval.max_detections=8"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert 0 < len(lines) <= 8
    assert set(lines[0]) == {"class", "score", "box"} and len(lines[0]["box"]) == 4
    assert Image.open(out).size == (120, 90)


@pytest.mark.parametrize(
    "argv",
    [
        ["evaluate", "--preset", "tiny_test", "--int8"],
        ["evaluate", "--preset", "tiny_test", "--checkpoint", "ck", "--no-such-flag"],
        ["evaluate", "--preset", "tiny_test", "--device", "cpu", "--checkpoint", "{empty}"],
        ["evaluate", "--preset", "no_such_preset", "--checkpoint", "ck"],
    ],
)
def test_cli_unported_paths_exit_nonzero(argv, capsys, tmp_path):
    """The evaluate command's refusals: no --checkpoint, an unknown flag and
    an unknown preset are argparse errors (exit 2); a directory that holds
    no checkpoint says so."""
    from object_detector_tpu_torch.cli.main import main

    argv = [a.replace("{empty}", str(tmp_path)) for a in argv]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    err = capsys.readouterr().err
    if str(tmp_path) in argv:
        assert str(exc.value) == f"no checkpoint found in {tmp_path}"
    else:
        assert exc.value.code == 2
        assert ("required: --checkpoint" in err or "unrecognized arguments: --no-such-flag" in err
                or "invalid choice: 'no_such_preset'" in err), err
