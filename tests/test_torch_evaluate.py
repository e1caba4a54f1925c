"""The port's evaluate surface: `evaluate_dataset` against the reference's on
`tiny_test`, its batching (the overlapped last batch, a set smaller than one
batch), and the ``evaluate`` command on VOC files written into
``tmp_path``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.data.pipeline import DecodedCache as RefDecodedCache
from object_detector_tpu.data.synthetic import make_synthetic_dataset as ref_synthetic
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.cli.main import main
from object_detector_tpu_torch.convert import flatten_tree, init_params, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.data.voc import VOC_CLASSES
from object_detector_tpu_torch.eval import evaluator
from object_detector_tpu_torch.models.ssd import SSDModel
from object_detector_tpu_torch.ops.nms import Detections
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)

N_IMAGES = 20


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny_test at eval.batch_size=8 with seeded flax
    weights, the port's copy of them, and both packages' caches of the same
    20-image synthetic set (20 is not a multiple of 8)."""
    cfg = config.get_config("tiny_test").override({"eval.batch_size": 8})
    ref_cfg = ref_config.get_config("tiny_test").override({"eval.batch_size": 8})
    ref_model = RefSSDModel(ref_cfg)
    variables = ref_model.init(jax.random.key(11), jnp.zeros((1, 64, 64, 3)), train=False)
    params = params_from_jax(flatten_tree(variables["params"]))
    dataset = make_synthetic_dataset(num_images=N_IMAGES, image_size=64, seed=5)
    ref_dataset = ref_synthetic(num_images=N_IMAGES, image_size=64, seed=5)
    cache = DecodedCache(dataset, 64, cfg.data.max_boxes, 1)
    ref_cache = RefDecodedCache(ref_dataset, 64, ref_cfg.data.max_boxes, 1)
    np.testing.assert_array_equal(cache.images, ref_cache.images)
    return cfg, ref_cfg, ref_model, variables, params, dataset, ref_dataset, cache, ref_cache


def _assert_close(got, want, atol):
    assert set(got) == set(want) and "mAP" in got
    for key, value in want.items():
        assert abs(got[key] - value) <= atol, (key, got[key], value)
    assert any(v > 0 for k, v in want.items() if k.startswith("ap/"))


def test_float_sweep_matches_reference(tiny):
    """Within 1e-6: the same detections up to float32 rounding of the convs
    (the predict tests hold them within 1e-4), which move no match here."""
    cfg, ref_cfg, ref_model, variables, params, dataset, ref_dataset, cache, ref_cache = tiny
    want = ref_evaluator.evaluate_dataset(ref_cfg, ref_model, variables, ref_dataset,
                                          cache=ref_cache)
    got = evaluator.evaluate_dataset(cfg, params, dataset, cache=cache, device="cpu")
    _assert_close(got, want, 1e-6)


@pytest.fixture(scope="module")
def ref_int8(tiny):
    """The reference's int8 sweep, and its scales for the first
    eval.batch_size cached images (what it calibrates on)."""
    cfg, ref_cfg, ref_model, variables, params, dataset, ref_dataset, cache, ref_cache = tiny
    want = ref_evaluator.evaluate_dataset(ref_cfg, ref_model, variables, ref_dataset,
                                          cache=ref_cache, int8=True)
    calib = ref_augment.normalize(jnp.asarray(ref_cache.images[:8]).astype(jnp.float32) / 255.0)
    scales = ref_engine.calibrate_scales(variables["params"], ref_engine.build_spec(ref_cfg),
                                         [calib])
    return want, scales


@pytest.mark.parametrize("stem_fp", ["0", "1"])
def test_int8_sweep_matches_reference_on_its_scales(tiny, ref_int8, monkeypatch, stem_fp):
    """Calibrated on the first eval.batch_size cached images, on the
    reference's scales for them. Within 1e-3: the reference's jitted int8
    program rounds its epilogue differently (ROADMAP §C), which moves
    detections by up to 1e-4. Both of the port's block-1 routes."""
    cfg, ref_cfg, ref_model, variables, params, dataset, ref_dataset, cache, ref_cache = tiny
    want, scales = ref_int8
    monkeypatch.setenv("ODT_STEM_FP", stem_fp)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    got = evaluator.evaluate_dataset(cfg, params, dataset, cache=cache, int8=True, device="cpu")
    _assert_close(got, want, 1e-3)


class _IndexCache:
    """A cache whose image n carries n in its first byte, so a stub predict
    knows which records a batch holds."""

    def __init__(self, n, size=8):
        self.images = np.zeros((n, size, size, 3), np.uint8)
        self.images[:, 0, 0, 0] = np.arange(n)

    def __len__(self):
        return len(self.images)

    def gather(self, idx):
        return {"image": self.images[idx]}


@pytest.mark.parametrize("n,int8", [(20, False), (16, False), (5, False), (20, True), (5, True)])
def test_sweep_adds_each_image_once(monkeypatch, n, int8):
    """A stub predict returning each image's ground truth, jittered: mAP
    well above 0; a set the batch does not divide overlaps its last batch
    and adds no image twice; a set smaller than one batch is padded with
    row 0; int8 calibrates on the first min(n, batch) cached images."""
    cfg = config.get_config("tiny_test").override({"eval.batch_size": 8})
    dataset = make_synthetic_dataset(num_images=n, image_size=64, seed=3)
    rng = np.random.default_rng(0)
    batches, calibrated = [], []

    def stub(images_u8):
        idx = images_u8[:, 0, 0, 0].astype(int)
        batches.append(idx.tolist())
        d = 4
        boxes = np.zeros((len(idx), d, 4), np.float32)
        scores = np.zeros((len(idx), d), np.float32)
        classes = np.zeros((len(idx), d), np.int32)
        valid = np.zeros((len(idx), d), bool)
        for row, i in enumerate(idx):
            rec = dataset.records[i]
            m = min(len(rec.boxes), d)
            boxes[row, :m] = rec.boxes[:m] + rng.normal(0, 0.005, (m, 4))
            scores[row, :m] = rng.uniform(0.5, 1.0, m)
            classes[row, :m] = rec.labels[:m] - 1
            valid[row, :m] = True
        return Detections(*(torch.from_numpy(a) for a in (boxes, scores, classes, valid)))

    def make_float(*args, **kwargs):
        return stub

    def make_int8(cfg_, params_, anchors, calib, use_pallas, device):
        calibrated.append(calib[:, 0, 0, 0].tolist())
        return stub

    added = []

    class Recording(evaluator.MeanAPEvaluator):
        def add_image(self, image_id, *args, **kwargs):
            added.append(image_id)
            super().add_image(image_id, *args, **kwargs)

    monkeypatch.setattr(evaluator, "make_predict_fn", make_float)
    monkeypatch.setattr(evaluator, "make_int8_predict_fn", make_int8)
    monkeypatch.setattr(evaluator, "MeanAPEvaluator", Recording)
    params = init_params(SSDModel(cfg), seed=0).state_dict()
    result = evaluator.evaluate_dataset(cfg, params, dataset, cache=_IndexCache(n), int8=int8,
                                        device="cpu")
    assert sorted(added) == sorted(r.image_id for r in dataset.records) and len(added) == n
    assert all(len(b) == 8 for b in batches)  # a static batch shape
    want_batches = {20: [list(range(8)), list(range(8, 16)), list(range(12, 20))],
                    16: [list(range(8)), list(range(8, 16))],
                    5: [[0, 1, 2, 3, 4, 0, 0, 0]]}[n]
    assert batches == want_batches
    assert calibrated == ([list(range(min(n, 8)))] if int8 else [])
    assert result["mAP"] > 0.9


def _evaluate(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_then_evaluate_on_voc_files(tmp_path, capsys):
    """The counterpart of tests/test_real_files_cli.py: real JPEGs (one of
    them corrupt) and VOC XML in tmp_path, trained for 4 steps, then
    evaluated in float and int8 with both block-1 routes, on the CPU; the
    same command without --device cpu needs a card."""
    from test_real_files_cli import _write_voc_tree

    root = str(tmp_path / "VOCdevkit")
    _write_voc_tree(root)
    ckpt = str(tmp_path / "ckpt")
    common = ["--preset", "tiny_test", "--data-root", root, "--set", "data.dataset=voc",
              "--set", f"model.num_classes={len(VOC_CLASSES)}"]
    assert main(["train", *common, "--device", "cpu", "--steps", "4", "--checkpoint", ckpt,
                 "--set", "train.batch_size=8", "--set", "train.checkpoint_every=2"]) == 0
    capsys.readouterr()
    argv = ["evaluate", *common, "--device", "cpu", "--checkpoint", ckpt, "--split", "test",
            "--set", "eval.batch_size=4"]
    result = _evaluate(capsys, argv)
    assert "mAP" in result and 0.0 <= result["mAP"] <= 1.0
    assert set(result) <= {"mAP"} | {f"ap/class_{c}" for c in range(len(VOC_CLASSES))}
    int8 = {}
    for route in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ODT_STEM_FP", route)
            int8[route] = _evaluate(capsys, argv + ["--int8"])
    assert int8["0"] == int8["1"] and set(int8["0"]) == set(result)
    assert all(np.isfinite(v) for v in int8["0"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([a for a in argv if a not in ("--device", "cpu")])
