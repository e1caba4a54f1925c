"""The benchmark's Deformable DETR cell as a whole on the CPU, at a tiny size:
its closed loop (``port_bench/drivers/padded_batch_deformable.py``), its
seeded canvases, the reference and the check
(``port_bench/deformable_check.py``) give ``correct`` true for the program,
and false with the timed path broken underneath or with any of its three
correctness controls in the program's place; its files are found by name,
its frozen counts hold at the published shapes, and its readers take the
program's counters."""

import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from port_bench import counts, deformable_check, harness
from port_bench import deformable_counts as dc
from port_bench.drivers import padded_batch_deformable

torch.set_num_threads(2)

M = harness.manifest()
CELL = "deformable_detr_int8_batch32"
# The preset cut to the tiny Deformable DETR of the CPU tests (a 128 px
# canvas, levels of 16 to 2 cells) and a batch of 4.
TINY = {"model.image_size": 128, "model.num_classes": 5, "eval.batch_size": 4,
        "deformable.d_model": 64, "deformable.heads": 2, "deformable.ffn": 128,
        "deformable.enc_layers": 2, "deformable.dec_layers": 2, "deformable.queries": 10,
        "deformable.gn_groups": 8, "deformable.top_k": 20}
# The tiny model's box corners are pixels of images of about a tenth of the
# cell's, so its box limits are the cell's tenth.
BOX_SCALE = 0.1
SEED = 2 ** 40 + 3


def _tiny_files(**traffic) -> dict:
    from object_detector_tpu_torch.core.config import get_config

    w = {c["name"]: c for c in M["workloads"]}[CELL]
    config = harness.load_json(harness.ROOT / "port_bench/configs/deformable_detr_r50_coco.json")
    cfg = get_config(config["preset"]).override(TINY)
    resolved = json.loads(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                      for k in config["resolved"]}))
    limits = harness.load_json(harness.BENCH / "cells" / f"{CELL}.json")
    scaled = {k: v * BOX_SCALE if k in ("box_gap", "box_median_gap") else v
              for k, v in limits["limits"].items()}
    return {"cell": w, "config": {**config, "set": TINY, "resolved": resolved},
            "traffic": {**harness.load_json(
                harness.BENCH / "traffic/int8_padded_batch32_deformable.json"),
                "batch": 4, "canvas": 128, "extents": [[96, 128], [128, 96]],
                "extent_weights": [0.5, 0.5], "pool_batches": 2, "checked_batches": 2,
                **traffic},
            "limits": {**limits, "limits": scaled}, "manifest": M}


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
def test_the_deformable_cell_is_not_correct_with_its_timed_path_broken(fault, monkeypatch):
    from object_detector_tpu_torch.eval import evaluator

    if fault is not None:
        monkeypatch.setattr(evaluator, "make_int8_predict_fn",
                            _broken(fault)(evaluator.make_int8_predict_fn))
    out = harness.execute(CELL, SEED, 1.0, False, time.perf_counter(), need_card=False,
                          files=_tiny_files())
    assert out["correct"] is (fault is None), out["check"]
    assert out["metrics"]["serve_img_per_s"]["value"] > 0


@pytest.mark.parametrize("control", sorted(padded_batch_deformable.CONTROLS))
def test_each_control_is_not_correct(control):
    out = harness.execute(CELL, SEED, 1.0, False, time.perf_counter(), variant="control",
                          need_card=False, files=_tiny_files(control=control))
    assert out["correct"] is False, out["check"]


def test_the_cells_files_are_found_and_its_metrics_listed():
    f = harness.cell_files(M, CELL)
    assert f["traffic"]["mode"] == "padded_batch_deformable" and f["cell"]["chips"] == 1
    detr_traffic = harness.load_json(harness.BENCH / "traffic/int8_padded_batch32.json")
    assert {**f["traffic"], "mode": "padded_batch"} == detr_traffic
    assert set(f["limits"]["limits"]) == {"det_gap", "top_gap", "top_logit_gap", "miss_gap",
                                          "box_gap", "slot_breaks", "box_median_gap",
                                          "box_median_ratio"}
    names = {x["name"] for x in harness.reported_metrics(M, CELL, traced=True)}
    # The cell's own six, and the accepted readers of the layers it shares
    # with RetinaNet's and DETR's cells: the trunk's kernels and steps, the
    # upload and the device's idle share.
    assert names == {"deformable_backbone_device_ms.serve", "deformable_encoder_device_ms.serve",
                     "deformable_decoder_device_ms.serve", "msda_device_ms.serve",
                     "msda_roofline.serve", "deformable_mfu_pct.serve",
                     "resnet_stem_roofline.serve", "bottleneck_roofline.serve", "idle_pct.serve",
                     "im2col_device_ms.serve", "gemm_device_ms.serve",
                     "epilogue_device_ms.serve", "epilogue_roofline.serve",
                     "upload_host_ms.serve", "conv_device_ms.serve", "conv_roofline.serve",
                     "upload_gbps.serve"}
    for name in names:
        assert callable(harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read)
    assert {x["name"] for x in harness.reported_metrics(M, CELL, traced=False)} == {
        "serve_img_per_s", "setup_s"}
    cfg = harness.program_config(f["config"])
    assert cfg.model.family == "deformable_detr" and f["config"]["reduced"] == []


def test_the_frozen_counts_at_the_published_shapes():
    from object_detector_tpu_torch.models import deformable_detr

    arch = harness.cell_files(M, CELL)["config"]["resolved"]
    assert dc.level_sides(arch) == [136, 68, 34, 17] and dc.canvas_tokens(arch) == 24565
    # The program's count of the cell's two orientations and of the canvas.
    n = 13400 + 3350 + 850 + 221
    for (h, w), want in (((800, 1066), n), ((1066, 800), n), ((1088, 1088), 24565)):
        assert deformable_detr.valid_tokens(torch.tensor([[h, w]]), (1088, 1088), 4) == want
    assert 95e9 < dc.trunk_int8_ops(arch) / 2 < 98e9  # 96.4 GMACs a canvas, undilated
    # A sample: 4 corners x 32 channels x 2 operations; 8 heads x 4 levels x
    # 4 points a query row; the encoder's n rows and the decoder's 300, 6
    # layers each.
    assert dc.sampling_ops(arch, n) == 256 * 128 * 6 * (n + 300)
    assert dc.points_a_call(arch, 32) == 32 * 128 * 6 * (24565 + 300)
    # A token costs 754k MACs in each encoder layer (value, offset and weight,
    # output projections, FFN of 1024) and 65.5k in each decoder layer's
    # value projection.
    per_token = dc.transformer_flops(arch, n + 1) - dc.transformer_flops(arch, n)
    assert per_token == pytest.approx(6 * 2 * (753664 + 256 * 256))
    least = dc.sampling_least_s(arch, n)
    ops_bound = dc.sampling_ops(arch, n) / counts.F32_OPS_PER_S
    assert ops_bound <= least < 1.2 * ops_bound  # bound by its float32 work


def test_the_check_reads_a_served_copy_of_the_reference_as_exact():
    from port_bench.reference import deformable_detr

    gen = torch.Generator().manual_seed(2)
    logits = torch.randn(2, 10, 6, generator=gen) * 3
    boxes = torch.rand(2, 10, 4, generator=gen)
    extents = torch.tensor([[96, 128], [40, 70]])
    corners, scores, labels, _ = deformable_detr.postprocess(logits, boxes, extents, 20)
    served = (corners, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool))
    exact = [deformable_check.image_gaps(served, logits, boxes, extents, 20)]
    got = deformable_check.worst(exact, exact)
    assert got == {"det_gap": 0.0, "top_gap": 0.0, "top_logit_gap": 0.0, "miss_gap": 0.0,
                   "box_gap": 0.0, "slot_breaks": 0, "box_median_gap": 0.0,
                   "box_median_ratio": 0.0}
    broken = (corners, scores, labels.to(torch.int32) + 9, served[3])
    assert deformable_check.worst([deformable_check.image_gaps(broken, logits, boxes, extents,
                                                               20)], exact)["slot_breaks"] == 40
    # Served out of order: each slot above the one before it breaks.
    flipped = tuple(t.flip(1) for t in served)
    assert deformable_check.worst([deformable_check.image_gaps(
        flipped, logits, boxes, extents, 20)], exact)["slot_breaks"] == 2 * 19


def test_the_median_ratio_is_the_served_median_over_the_yardsticks():
    from port_bench.reference import deformable_detr

    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 10, 6, generator=gen) * 3
    boxes = torch.rand(2, 10, 4, generator=gen) * 0.5 + 0.25
    extents = torch.tensor([[96, 128], [40, 70]])
    corners, scores, labels, _ = deformable_detr.postprocess(logits, boxes, extents, 20)

    def moved(px):  # every box moved right by px pixels, well inside its image
        shifted = corners.clone()
        shifted[..., 0::2] += px
        return (shifted, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool))

    def gaps(px):
        return [deformable_check.image_gaps(moved(px), logits, boxes, extents, 20)]

    got = deformable_check.worst(gaps(3.0), gaps(1.5))
    assert got["box_median_gap"] == pytest.approx(3.0, abs=1e-4)
    assert got["box_median_ratio"] == pytest.approx(2.0, rel=1e-4)


def test_a_detection_left_out_shows_as_a_miss():
    from port_bench.reference import deformable_detr

    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(1, 10, 6, generator=gen) * 3
    boxes = torch.rand(1, 10, 4, generator=gen)
    extents = torch.tensor([[96, 128]])
    corners, scores, labels, _ = deformable_detr.postprocess(logits, boxes, extents, 20)
    # The best served in place of the second best: the second is missed by
    # the score gap to the served list, which the detections do not cover.
    served = [corners.clone(), scores.clone(), labels.to(torch.int32), None]
    for t in served[:3]:
        t[:, 1] = t[:, 0]
    served[3] = torch.ones_like(scores, dtype=torch.bool)
    gaps = [deformable_check.image_gaps(served, logits, boxes, extents, 20)]
    got = deformable_check.worst(gaps, gaps)
    assert got["det_gap"] == 0.0 and got["miss_gap"] > 0.0
    assert got["slot_breaks"] == 0


def test_the_readers_take_the_programs_counters():
    from object_detector_tpu_torch.utils import profiling

    arch = harness.cell_files(M, CELL)["config"]["resolved"]
    reader = harness.load_module(harness.BENCH / "metrics" / "deformable_mfu_pct.serve.py")
    r = harness.Run(CELL, 1, 10.0, True, "program", 0.0, {}, {"resolved": arch}, {}, {})
    r.host.update(batch=32, images_untraced=320, seconds_untraced=1.0)
    n = 13400 + 3350 + 850 + 221
    profiling.reset_counters()
    try:
        assert dc.traced_tokens_an_image(r) is None and reader.read(r) is None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):  # three calls of 32 images
                profiling.count(dc.PREDICT_CALLS, 1)
                profiling.count(dc.VALID_TOKENS, 32 * n)
                profiling.count(dc.SAMPLED_POINTS, dc.points_a_call(arch, 32))
        assert dc.traced_tokens_an_image(r) == n and dc.points_agree(r)
        assert reader.read(r) == pytest.approx(100.0 * 320 * dc.least_s(arch, n))
        assert 0 < reader.read(r) < 100 * 320 * 0.2  # the least time is a few ms an image
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.count(dc.SAMPLED_POINTS, 1)  # one point more than the shapes give
        assert not dc.points_agree(r)
        roofline = harness.load_module(harness.BENCH / "metrics" / "msda_roofline.serve.py")
        assert roofline.read(r) is None  # no trace, and the counts disagree
    finally:
        profiling.reset_counters()
    assert math.isfinite(dc.least_s(arch, n))
