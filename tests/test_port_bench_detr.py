"""The benchmark's DETR cell as a whole on the CPU, at a tiny size: its
closed loop (``port_bench/drivers/padded_batch.py``), its seeded canvases, the
reference and the check (``port_bench/detr_check.py``) give ``correct``
true for the program, and false with the timed path broken underneath or
with either correctness control in the program's place; its files are
found by name and its frozen counts hold."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from port_bench import counts, detr_check, detr_counts, harness
from port_bench.drivers import padded_batch

torch.set_num_threads(2)

M = harness.manifest()
CELL = "detr_dc5_int8_batch32"
# The preset cut to the tiny DETR of the CPU tests (a 128 px canvas, C5 of
# 8 x 8) and a batch of 4.
TINY = {"model.image_size": 128, "model.num_classes": 5, "eval.batch_size": 4,
        "transformer.d_model": 64, "transformer.heads": 4, "transformer.ffn": 128,
        "transformer.enc_layers": 2, "transformer.dec_layers": 2, "transformer.queries": 10}
# The tiny model's box corners are pixels of images of about a tenth of the
# cell's, so its box limit is the cell's tenth.
BOX_SCALE = 0.1


def _tiny_files(**traffic) -> dict:
    from object_detector_tpu_torch.core.config import get_config

    w = {c["name"]: c for c in M["workloads"]}[CELL]
    config = harness.load_json(harness.ROOT / "port_bench/configs/detr_r50_dc5_coco.json")
    cfg = get_config(config["preset"]).override(TINY)
    resolved = json.loads(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                      for k in config["resolved"]}))
    limits = harness.load_json(harness.BENCH / "cells" / f"{CELL}.json")
    limits = {**limits, "limits": {**limits["limits"],
                                   "box_gap": limits["limits"]["box_gap"] * BOX_SCALE,
                                   "box_median_gap": limits["limits"]["box_median_gap"]
                                   * BOX_SCALE}}
    return {"cell": w, "config": {**config, "set": TINY, "resolved": resolved},
            "traffic": {**harness.load_json(harness.BENCH / "traffic/int8_padded_batch32.json"),
                        "batch": 4, "canvas": 128, "extents": [[96, 128], [128, 96]],
                        "pool_batches": 2, "checked_batches": 2, **traffic},
            "limits": limits, "manifest": M}


def _broken(fault: str):
    def wrap(make):
        def made(*args, **kwargs):
            predict = make(*args, **kwargs)

            def broken(images, extents):
                if fault == "unmasked":  # the padding taken for the image
                    extents = np.full_like(extents, images.shape[1])
                boxes, scores, classes, valid = predict(images, extents)
                if fault == "altered":  # a score altered where it is produced
                    scores = scores.clone()
                    scores[:, 0] = (scores[:, 0] + 0.3).clamp(max=1.0)
                elif fault == "swapped":  # two images' detections swapped
                    boxes, scores, classes = (t[[1, 0, *range(2, t.shape[0])]]
                                              for t in (boxes, scores, classes))
                return type(predict(images, extents))(boxes, scores, classes, valid)
            return broken
        return made
    return wrap


@pytest.mark.parametrize("fault", [None, "altered", "unmasked", "swapped"])
def test_the_detr_cell_is_not_correct_with_its_timed_path_broken(fault, monkeypatch):
    from object_detector_tpu_torch.eval import evaluator

    if fault is not None:
        monkeypatch.setattr(evaluator, "make_int8_predict_fn",
                            _broken(fault)(evaluator.make_int8_predict_fn))
    files = _tiny_files()
    # The swap shows where the two images' extents differ.
    files["traffic"]["extent_weights"] = [0.5, 0.5]
    out = harness.execute(CELL, 2 ** 33 + 9, 1.0, False, time.perf_counter(), need_card=False,
                          files=files)
    assert out["correct"] is (fault is None), out["check"]
    assert out["metrics"]["serve_img_per_s"]["value"] > 0


@pytest.mark.parametrize("control", sorted(padded_batch.CONTROLS))
def test_each_control_is_not_correct(control):
    out = harness.execute(CELL, 2 ** 33 + 11, 1.0, False, time.perf_counter(),
                          variant="control", need_card=False, files=_tiny_files(control=control))
    assert out["correct"] is False, out["check"]


def test_the_pool_draws_extents_from_the_seed_and_pads_with_noise():
    r = harness.Run(CELL, 2 ** 40 + 1, 1.0, False, "program", 0.0, {}, {},
                    _tiny_files(pool_batches=3)["traffic"], {})
    pool, extents = padded_batch.render_pool(r, torch.device("cpu"))
    again, extents_again = padded_batch.render_pool(r, torch.device("cpu"))
    assert len(pool) == 3 and pool[0].shape == (4, 128, 128, 3) and pool[0].dtype == np.uint8
    assert all(np.array_equal(a, b) for a, b in zip(pool, again))
    assert all(np.array_equal(a, b) for a, b in zip(extents, extents_again))
    assert {tuple(e) for batch in extents for e in batch} <= {(96, 128), (128, 96)}
    for images, batch in zip(pool, extents):
        for image, (h, w) in zip(images, batch):
            pad = np.concatenate([image[h:].ravel(), image[:, w:].ravel()])
            assert pad.size and pad.std() > 50  # uniform noise, not a scene


def test_the_cells_files_are_found_and_its_metrics_listed():
    f = harness.cell_files(M, CELL)
    assert f["traffic"]["mode"] == "padded_batch" and f["cell"]["chips"] == 1
    assert set(f["limits"]["limits"]) == {"score_gap", "top_gap", "top_logit_gap", "box_gap",
                                          "slot_breaks", "box_median_gap"}
    names = {x["name"] for x in harness.reported_metrics(M, CELL, traced=True)}
    assert names == {"detr_backbone_device_ms.serve", "detr_encoder_device_ms.serve",
                     "detr_decoder_device_ms.serve", "detr_attention_roofline.serve",
                     "detr_mfu_pct.serve", "conv_device_ms.serve", "conv_roofline.serve",
                     "upload_gbps.serve"}
    for name in names:
        assert callable(harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read)
    assert {x["name"] for x in harness.reported_metrics(M, CELL, traced=False)} == {
        "serve_img_per_s", "setup_s"}
    harness.program_config(f["config"])


def test_the_frozen_counts_at_the_published_shapes():
    from object_detector_tpu_torch.models import detr

    arch = harness.cell_files(M, CELL)["config"]["resolved"]
    # The program's count of the cell's two orientations and of the canvas.
    for (h, w), n in (((800, 1066), 50 * 67), ((1066, 800), 67 * 50), ((1088, 1088), 68 * 68)):
        assert detr.valid_tokens(torch.tensor([[h, w]]), (1088, 1088), (68, 68)) == n
    n = 50 * 67
    # 6 encoder layers of n x n pairs, 6 decoder layers of 100 x 100 and
    # 100 x n, 4 * 256 operations a pair.
    assert detr_counts.attention_flops(arch, n) == 1024 * (6 * n * n + 6 * (10000 + 100 * n))
    assert 140e9 < detr_counts.trunk_int8_ops(arch) / 2 < 150e9  # 146.4 GMACs a canvas
    assert detr_counts.transformer_flops(arch, n) > detr_counts.attention_flops(arch, n)


def test_the_check_reads_a_served_copy_of_the_reference_as_exact():
    from port_bench.reference import detr

    gen = torch.Generator().manual_seed(2)
    logits = torch.randn(2, 10, 6, generator=gen) * 3
    boxes = torch.rand(2, 10, 4, generator=gen)
    extents = torch.tensor([[96, 128], [40, 70]])
    corners, scores, labels = detr.postprocess(logits, boxes, extents)
    served = (corners, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool))
    got = detr_check.worst([detr_check.image_gaps(served, logits, boxes, extents)])
    assert got == {"score_gap": 0.0, "top_gap": 0.0, "top_logit_gap": 0.0, "box_gap": 0.0,
                   "slot_breaks": 0, "box_median_gap": 0.0}
    broken = (corners, scores, labels.to(torch.int32) + 9, served[3])
    assert detr_check.worst([detr_check.image_gaps(broken, logits, boxes, extents)])[
        "slot_breaks"] == 20


def test_the_median_box_gap_is_the_middle_slots_and_the_worst_the_largest():
    from port_bench.reference import detr

    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(2, 10, 6, generator=gen) * 3
    boxes = torch.rand(2, 10, 4, generator=gen)
    extents = torch.tensor([[96, 128], [40, 70]])
    corners, scores, labels = detr.postprocess(logits, boxes, extents)
    # Every slot's x0 moved by its own amount, one slot far: the median is
    # the middle slots', the worst the far one's.
    shift = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    shift[1, 9] = 60.0
    moved = corners.clone()
    moved[..., 0] += shift
    served = (moved, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool))
    got = detr_check.worst([detr_check.image_gaps(served, logits, boxes, extents)])
    assert got["box_gap"] == pytest.approx(60.0, abs=1e-4)
    assert got["box_median_gap"] == pytest.approx(9.0, abs=1e-4)  # torch's lower middle
    assert got["score_gap"] == 0.0


def test_the_readers_take_the_programs_token_count():
    from object_detector_tpu_torch.utils import profiling

    arch = harness.cell_files(M, CELL)["config"]["resolved"]
    reader = harness.load_module(harness.BENCH / "metrics" / "detr_mfu_pct.serve.py")
    r = harness.Run(CELL, 1, 10.0, True, "program", 0.0, {}, {"resolved": arch}, {}, {})
    r.host.update(batch=32, images_untraced=320, seconds_untraced=1.0)
    profiling.reset_counters()
    try:
        assert detr_counts.traced_tokens_an_image(r) is None and reader.read(r) is None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):  # three calls of 32 images of 50 x 67 tokens
                profiling.count(detr_counts.PREDICT_CALLS, 1)
                profiling.count(detr_counts.VALID_TOKENS, 32 * 50 * 67)
        assert detr_counts.traced_tokens_an_image(r) == 50 * 67
        least = 320 * (detr_counts.trunk_int8_ops(arch) / counts.INT8_OPS_PER_S
                       + detr_counts.transformer_flops(arch, 50 * 67) / counts.BF16_FLOPS_PER_S)
        assert reader.read(r) == pytest.approx(100.0 * least)
    finally:
        profiling.reset_counters()
