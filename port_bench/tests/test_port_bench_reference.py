"""The plain reference: it loads nothing of the program, and at small sizes
it computes what the program's float model computes."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from port_bench import harness
from port_bench.reference import detector
from port_bench.weights import make_weights


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import port_bench.reference.detector, "
            "port_bench.weights, port_bench.scenes, port_bench.counts, port_bench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'object_detector_tpu', 'object_detector_tpu_torch', 'jax', 'flax'}))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _arch(cfg):
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    return {k: d[k] for k in ("model", "anchors", "eval")}


@pytest.mark.parametrize("which", ["ssd", "retinanet"])
def test_reference_forward_matches_the_programs_float_model(which):
    from object_detector_tpu_torch.anchors.priors import anchors_for_model
    from object_detector_tpu_torch.core.config import tiny_retinanet_config, tiny_test_config
    from object_detector_tpu_torch.models.retinanet import build_model
    from object_detector_tpu_torch.ops.augment import normalize

    cfg = tiny_test_config() if which == "ssd" else tiny_retinanet_config()
    arch = _arch(cfg)
    weights = make_weights(arch, {"cls_gain": 1.0, "box_gain": 1.0, "bias_std": 0.1,
                                  "cls_bias": -4.6, "cls_bias_std": 0.5}, 5, "cpu")
    model = build_model(cfg)
    model.load_state_dict(weights)
    model.eval()
    s = cfg.model.image_size
    images = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_logits, want_boxes = model(normalize(images.float() / 255.0))
    got_logits, got_boxes = detector.forward(weights, images, arch)
    scale = want_logits.abs().max()
    assert (got_logits - want_logits).abs().max() <= 1e-4 * scale
    assert (got_boxes - want_boxes).abs().max() <= 1e-4 * want_boxes.abs().max()
    assert (detector.anchors(arch) == anchors_for_model(
        cfg.model.family, cfg.anchors, cfg.model.image_size)).all()


def test_detect_keeps_the_best_candidate_and_suppresses_overlaps():
    arch = _arch(__import__("object_detector_tpu_torch.core.config",
                            fromlist=["tiny_test_config"]).tiny_test_config())
    boxes = torch.tensor([[[0.1, 0.1, 0.5, 0.5], [0.11, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]]])
    scores = torch.tensor([[[0.9, 0.0, 0.0], [0.8, 0.0, 0.0], [0.0, 0.7, 0.0]]])
    out_b, out_s, out_c, valid = detector.detect(scores, boxes, arch)
    assert out_s[0, :2].tolist() == pytest.approx([0.9, 0.7]) and valid[0].sum() == 2
    assert out_c[0, :2].tolist() == [0, 1]
