"""The harness as a whole: no result without a card, no JAX in a run's
process, and ``correct`` false when the timed path is broken underneath
(driven on the CPU at the tiny preset, the card's look skipped)."""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness

RUN = [sys.executable, str(harness.BENCH / "run.py")]
M = harness.manifest()


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(RUN + ["--workload", M["workloads"][0]["name"], "--seed", "3",
                                "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "no result without a card" in out.stderr


def test_a_run_with_only_the_benchmarks_files_exits_nonzero(tmp_path):
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          M["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    """Imports the harness, every driver and reader the cells name, the
    reference and the program's entry points, then compares the top-level
    name of every loaded module whole."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
import importlib
from port_bench import harness, trace, counts, kernels, weights, scenes
from port_bench.reference import detector
m = harness.manifest()
for w in m["workloads"]:
    f = harness.cell_files(m, w["name"])
    harness.program_config(f["config"])
    importlib.import_module("port_bench.drivers." + f["traffic"]["mode"])
    for x in harness.reported_metrics(m, w["name"], traced=True):
        harness.load_module(harness.BENCH / "metrics" / (x["name"] + ".py"))
import object_detector_tpu_torch.eval.evaluator, object_detector_tpu_torch.cli.predictor
import object_detector_tpu_torch.quant.engine, object_detector_tpu_torch.kernels.nms
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "object_detector_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN


CELLS = {w["name"]: w for w in M["workloads"]}


def _files(cell: str) -> dict:
    w = CELLS[cell]
    config = {c["name"]: c for c in M["configs"]}[w["config"]]
    return {"cell": w, "config": harness.load_json(harness.ROOT / config["file"]),
            "traffic": harness.load_json(harness.BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": harness.load_json(harness.BENCH / "cells" / f"{cell}.json"),
            "manifest": M}


def _tiny_files(cell: str):
    """The cell's own traffic and limits, on the tiny preset with the cell's
    NMS route (the scan runs its plain version on the CPU) and its class
    head scaled up, so that its best scores reach tenths as the full-size
    model's do and an NMS that keeps too little shows."""
    from object_detector_tpu_torch.core.config import get_config

    f = _files(cell)
    overrides = {"eval.use_pallas_nms": True}
    cfg = get_config("tiny_test").override(overrides)
    resolved = json.loads(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                      for k in ("model", "anchors", "eval")}))
    f["config"] = {**f["config"], "preset": "tiny_test", "set": overrides, "resolved": resolved,
                   "weights": {**f["config"]["weights"], "cls_gain": 2.0}}
    f["traffic"] = {**f["traffic"], "batch": cfg.eval.batch_size, "pool_batches": 2,
                    "checked_batches": 2}
    return f


def _broken_predict(fault: str):
    def wrap(predict):
        def broken(images):
            boxes, scores, classes, valid = predict(images)
            if fault == "half_batch":  # half of the batch left out
                valid = valid.clone()
                valid[valid.shape[0] // 2:] = False
            elif fault == "altered":  # an answer altered where it is produced
                scores = scores.clone()
                scores[:, 0] = (scores[:, 0] + 0.3).clamp(max=1.0)
            return type(predict(images))(boxes, scores, classes, valid)
        return broken
    return wrap


def _broken_rows(fault: str):
    """The NMS scan with a fault: it suppresses nothing (each row's best
    ``max_out`` above the threshold), or keeps each row's first survivor
    alone."""
    from object_detector_tpu_torch.kernels import nms

    def rows(coords, scores, *, max_out, iou_threshold, score_threshold):
        if fault == "suppress_nothing":
            s, c = scores.topk(max_out, dim=1)
            keep = s > score_threshold
            return torch.where(keep, s, 0.0), torch.where(keep, c, 0).to(torch.int32)
        s, c = nms.nms_rows(coords, scores, max_out=max_out, iou_threshold=iou_threshold,
                            score_threshold=score_threshold)
        return torch.cat([s[:, :1], torch.zeros_like(s[:, 1:])], 1), c
    return rows


@pytest.mark.parametrize("fault", [None, "half_batch", "altered", "suppress_nothing",
                                   "keep_top"])
def test_batch_cell_is_not_correct_with_its_timed_path_broken(fault, monkeypatch):
    from object_detector_tpu_torch.eval import evaluator
    from object_detector_tpu_torch.ops import postprocess

    if fault in ("half_batch", "altered"):
        make = evaluator.make_int8_predict_fn
        monkeypatch.setattr(evaluator, "make_int8_predict_fn",
                            lambda *a, **k: _broken_predict(fault)(make(*a, **k)))
    elif fault is not None:
        monkeypatch.setattr(postprocess, "decode_nms", functools.partial(
            postprocess.decode_nms, rows_fn=_broken_rows(fault)))
    cell = "ssd300_int8_batch64"
    out = harness.execute(cell, 2 ** 33 + 5, 1.0, False, time.perf_counter(),
                          need_card=False, files=_tiny_files(cell))
    assert out["correct"] is (fault is None), out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct_on_the_card(cell, cuda_device):
    """The cell's control in the program's place, on the card at batch 8:
    the reference fake-quantized to 4 bits."""
    f = _files(cell)
    f["config"] = {**f["config"], "set": {"eval.batch_size": 8}}
    f["config"]["resolved"] = {**f["config"]["resolved"],
                               "eval": {**f["config"]["resolved"]["eval"], "batch_size": 8}}
    f["traffic"] = {**f["traffic"], "batch": 8, "pool_batches": 2, "checked_batches": 4}
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
        out = harness.execute(cell, seed, 2.0, False, time.perf_counter(), variant="control",
                              files=dict(f))
        assert out["correct"] is False, out["check"]
