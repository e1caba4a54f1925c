"""The port end to end, the counterpart of tests/test_e2e.py: tiny_test
trained 60 steps on 16 synthetic images (crop and expand off), then the
loss has fallen, the float mAP is above 0.05 and the int8 engine's mAP is
within 0.08 of the float mAP and above 0.3, the reference's bounds."""

import json

import numpy as np
import pytest
import torch

from object_detector_tpu_torch.core.config import tiny_test_config
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.eval.evaluator import evaluate_dataset
from object_detector_tpu_torch.train.loop import train

# The reference's module is slow-marked for its 60-step fixture; so is this.
pytestmark = pytest.mark.slow

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    cfg = tiny_test_config().override({
        "train.num_steps": 60,
        "train.base_lr": 5e-3,
        "train.checkpoint_every": 30,
        "data.augment.crop_prob": 0.0,
        "data.augment.expand_prob": 0.0,
        "data.num_workers": 1,
    })
    dataset = make_synthetic_dataset(num_images=16, image_size=cfg.model.image_size)
    metrics_path = str(root / "metrics.jsonl")
    state = train(cfg, dataset, metrics_path=metrics_path, checkpoint_dir=str(root / "ckpt"),
                  device="cpu")
    params = {k: v.detach() for k, v in state.params.items()}
    return cfg, dataset, params, metrics_path


def test_training_loss_decreases(trained):
    *_, metrics_path = trained
    losses = [json.loads(line)["loss"] for line in open(metrics_path)]
    assert len(losses) >= 2 and losses[-1] < losses[0], losses


def test_eval_map_positive(trained):
    cfg, dataset, params, _ = trained
    result = evaluate_dataset(cfg, params, dataset, device="cpu")
    assert result["mAP"] > 0.05, result


def test_int8_eval_matches_float(trained):
    cfg, dataset, params, _ = trained
    float_map = evaluate_dataset(cfg, params, dataset, device="cpu")["mAP"]
    int8_map = evaluate_dataset(cfg, params, dataset, int8=True, device="cpu")["mAP"]
    assert np.isfinite(float_map) and np.isfinite(int8_map)
    assert abs(float_map - int8_map) < 0.08, (float_map, int8_map)
    assert int8_map > 0.3, f"int8 path collapsed: {int8_map}"
