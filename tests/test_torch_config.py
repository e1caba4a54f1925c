"""Port vs reference: config presets, anchors, box math, normalization, and
the port's import hygiene and device defaults."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.ops import boxes as ref_boxes
from object_detector_tpu_torch.anchors import priors
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.ops import augment, boxes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ref_config.list_presets())
def test_presets_match_reference(name):
    assert config.list_presets() == ref_config.list_presets()
    ported = config.get_config(name)
    ref = ref_config.get_config(name)
    assert dataclasses.asdict(ported) == dataclasses.asdict(ref)
    assert ported.anchors.num_anchors == ref.anchors.num_anchors
    assert ported.model.num_levels == ref.model.num_levels


def test_override_matches_reference():
    kw = {"eval.score_threshold": 0.2, "model.compute_dtype": "float32"}
    ported = config.get_config("ssd300_infer_bs64").override(kw)
    ref = ref_config.get_config("ssd300_infer_bs64").override(kw)
    assert dataclasses.asdict(ported) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        config.get_config("tiny_test").override({"eval.no_such_field": 1})


@pytest.mark.parametrize("name", ["tiny_test", "ssd300_vgg16_voc", "ssd512_resnet50_coco",
                                  "retinanet_fpn_coco"])
def test_anchors_match_reference(name):
    cfg = config.get_config(name)
    got = priors.anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    ref_cfg = ref_config.get_config(name)
    want = ref_priors.anchors_for_model(
        ref_cfg.model.family, ref_cfg.anchors, ref_cfg.model.image_size
    )
    np.testing.assert_array_equal(got, want)
    if name == "ssd300_vgg16_voc":
        assert got.shape == (8732, 4)
    if name == "retinanet_fpn_coco":
        assert got.shape == (49104, 4) == (cfg.anchors.num_anchors, 4)


def test_tiny_retinanet_config_matches_reference():
    ported, ref = config.tiny_retinanet_config(), ref_config.tiny_retinanet_config()
    assert dataclasses.asdict(ported) == dataclasses.asdict(ref)
    assert ported.anchors.num_anchors == ref.anchors.num_anchors == 3069
    assert dataclasses.asdict(config.tiny_retinanet_config(5)) == dataclasses.asdict(
        ref_config.tiny_retinanet_config(5))


def _corner_boxes(rng, n):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.01, 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_ops_match_reference():
    rng = np.random.default_rng(0)
    a, b = _corner_boxes(rng, 40), _corner_boxes(rng, 30)
    a[3, 2] = a[3, 0]  # zero width
    anchors = np.concatenate(
        [rng.uniform(0.1, 0.9, (40, 2)), rng.uniform(0.05, 0.5, (40, 2))], -1
    ).astype(np.float32)
    offsets = rng.normal(0, 1.0, (40, 4)).astype(np.float32)
    ta, tb, tanc, toff = (torch.from_numpy(x) for x in (a, b, anchors, offsets))
    cases = [
        (boxes.corner_to_center(ta), ref_boxes.corner_to_center(a)),
        (boxes.center_to_corner(tanc), ref_boxes.center_to_corner(anchors)),
        (boxes.area(ta), ref_boxes.area(a)),
        (boxes.iou(ta, tb), ref_boxes.iou(a, b)),
        (boxes.encode(ta, tanc, 0.1, 0.2), ref_boxes.encode(a, anchors, 0.1, 0.2)),
        (boxes.decode(toff, tanc, 0.1, 0.2, clip=True),
         ref_boxes.decode(offsets, anchors, 0.1, 0.2, clip=True)),
        (boxes.decode(toff, tanc, 0.1, 0.2, clip=False),
         ref_boxes.decode(offsets, anchors, 0.1, 0.2, clip=False)),
    ]
    for got, want in cases:
        # One float32 ulp of slack for exp/log between XLA:CPU and torch.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_normalize_matches_reference():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = augment.normalize(torch.from_numpy(img).float() / 255.0)
    want = ref_augment.normalize(jnp.asarray(img).astype(jnp.float32) / 255.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "name", ["TrainConfig", "AugmentConfig", "MatcherConfig", "DataConfig", "MeshConfig"])
def test_section_defaults_match_reference(name):
    ported, ref = getattr(config, name)(), getattr(ref_config, name)()
    assert dataclasses.asdict(ported) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ported)] == [f.name for f in dataclasses.fields(ref)]


def test_dp8_training_preset_matches_reference():
    ported = config.get_config("ssd300_voc_train_dp8")
    ref = ref_config.get_config("ssd300_voc_train_dp8")
    assert dataclasses.asdict(ported.train) == dataclasses.asdict(ref.train)
    assert ported.train.batch_size == 256 and ported.mesh.data_parallel == 8
    assert dataclasses.asdict(ported.data.augment) == dataclasses.asdict(ref.data.augment)


def _records_equal(a, b):
    assert (a.image_id, a.path, a.width, a.height) == (b.image_id, b.path, b.width, b.height)
    for field in ("boxes", "labels", "difficult", "crowd_mask"):
        got, want = getattr(a, field), getattr(b, field)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_data_copies_match_reference(tmp_path):
    """data/types.py, data/synthetic.py and data/pipeline.py against the
    originals: the same records, pixels, padded annotations, cache arrays
    (in RAM and spilled) and batch order."""
    from object_detector_tpu.data import pipeline as ref_pipeline
    from object_detector_tpu.data import synthetic as ref_synthetic
    from object_detector_tpu.data import types as ref_types
    from object_detector_tpu_torch.data import pipeline, synthetic, types

    kw = dict(num_images=10, image_size=32, max_objects=4, seed=3)
    ds, ref_ds = synthetic.make_synthetic_dataset(**kw), ref_synthetic.make_synthetic_dataset(**kw)
    assert (ds.name, tuple(ds.class_names), len(ds), ds.num_classes) == (
        ref_ds.name, tuple(ref_ds.class_names), len(ref_ds), ref_ds.num_classes)
    assert synthetic.SYNTH_CLASSES == ref_synthetic.SYNTH_CLASSES
    for rec, ref_rec in zip(ds.records, ref_ds.records):
        _records_equal(rec, ref_rec)
        np.testing.assert_array_equal(synthetic.render_synthetic_image(rec, 24),
                                      ref_synthetic.render_synthetic_image(ref_rec, 24))
    # Crowd regions never become targets; overflow is truncated.
    rec, ref_rec = ds.records[0], ref_ds.records[0]
    n = len(rec.labels)
    rec.crowd = ref_rec.crowd = np.arange(n) == 0
    for max_boxes in (8, 1):
        for got, want in zip(types.pad_annotations(rec, max_boxes),
                             ref_types.pad_annotations(ref_rec, max_boxes)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rec.crowd = ref_rec.crowd = None

    for spill in (False, True):
        extra = dict(max_ram_bytes=1000, spill_dir=str(tmp_path / "spill")) if spill else {}
        ref_extra = dict(extra, spill_dir=str(tmp_path / "ref_spill")) if spill else {}
        cache = pipeline.DecodedCache(ds, 32, max_boxes=6, num_workers=2, **extra)
        ref_cache = ref_pipeline.DecodedCache(ref_ds, 32, max_boxes=6, num_workers=2, **ref_extra)
        assert len(cache) == len(ref_cache) == 10
        assert (cache.memmap_path is not None) == spill
        if spill:
            assert os.path.basename(cache.memmap_path) == os.path.basename(ref_cache.memmap_path)
            assert os.path.exists(cache.memmap_path + ".complete")
            again = pipeline.DecodedCache(ds, 32, max_boxes=6, num_workers=2, **extra)  # reused
            np.testing.assert_array_equal(again.images, cache.images)
            np.testing.assert_array_equal(again.boxes, cache.boxes)
        stream = pipeline.epoch_batches(cache, 4, seed=5, start_step=3)
        ref_stream = ref_pipeline.epoch_batches(ref_cache, 4, seed=5, start_step=3)
        for _ in range(4):  # across the edge of an epoch (2 batches an epoch)
            got, want = next(stream), next(ref_stream)
            assert set(got) == set(want) == {"image", "boxes", "labels", "valid"}
            assert got["image"].shape == (4, 32, 32, 3)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="yields zero batches at batch_size=11"):
        pipeline.epoch_batches(cache, 11, seed=0)
    # The resumed stream is the tail of the unbroken one, across an epoch edge.
    take = lambda it, n: [next(it)["labels"] for _ in range(n)]  # noqa: E731
    whole = take(pipeline.epoch_batches(cache, 4, seed=5), 6)
    tail = take(pipeline.epoch_batches(cache, 4, seed=5, start_step=3), 3)
    for a, b in zip(whole[3:], tail):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_and_logging_copies(tmp_path):
    import json

    from object_detector_tpu.utils import logging as ref_logging
    from object_detector_tpu_torch.data import pipeline
    from object_detector_tpu_torch.utils import logging as port_logging

    batches = [{"image": np.full((2, 4, 4, 3), i, np.uint8), "valid": np.ones((2, 3), bool)}
               for i in range(5)]
    pre = pipeline.DevicePrefetcher(iter(batches), pipeline.make_place(torch.device("cpu")), depth=2)
    got = list(pre)
    assert [int(b["image"][0, 0, 0, 0]) for b in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["image"], torch.Tensor) and b["image"].dtype == torch.uint8
               and b["valid"].dtype == torch.bool for b in got)
    endless = pipeline.DevicePrefetcher(iter(lambda: batches[0], None), lambda b: b, depth=2)
    next(endless)
    endless.close()  # stops a stream that never ends
    assert not endless._thread.is_alive()

    for mod, name in ((port_logging, "port.jsonl"), (ref_logging, "ref.jsonl")):
        log = mod.MetricsLogger(str(tmp_path / name), echo=False)
        log.log("train", step=3, loss=np.float32(1.5), note="x")
        log.close()
    port_row, ref_row = (json.loads((tmp_path / n).read_text()) for n in ("port.jsonl", "ref.jsonl"))
    port_row.pop("ts"), ref_row.pop("ts")
    assert port_row == ref_row == {"kind": "train", "step": 3, "loss": 1.5, "note": "x"}
    assert port_logging.setup_logging().name == "object_detector_tpu_torch"


_HYGIENE = """
import importlib, pkgutil, sys
import object_detector_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
names.remove("object_detector_tpu_torch.__main__")
assert "object_detector_tpu_torch.models.retinanet" in names
assert "object_detector_tpu_torch.parallel.mesh" in names
for new in ("utils.weights", "cli.convert_weights", "utils.profiling", "data.native_decode"):
    assert "object_detector_tpu_torch." + new in names, new
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "object_detector_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _HYGIENE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # The training, ResNet, RetinaNet and data-parallel modules among them,
    # and the weights, profiling and native decode modules.
    assert int(out.stdout.strip()) >= 59


def test_entry_points_default_to_cuda():
    from object_detector_tpu_torch.cli.predictor import Predictor
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.eval.evaluator import make_predict_fn
    from object_detector_tpu_torch.models.ssd import SSDModel

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    cfg = config.get_config("tiny_test")
    model = init_params(SSDModel(cfg), seed=0)
    anchors = priors.ssd_anchors(cfg.anchors, cfg.model.image_size)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_predict_fn(cfg, model, anchors)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, model.state_dict())
