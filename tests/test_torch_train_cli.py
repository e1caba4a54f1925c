"""The port's ``train`` command, on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from object_detector_tpu_torch.cli.main import build_parser, main
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.train.loop import train

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys of the reference's train log lines (train/loop.py:129-135).
KEYS = {"ts", "kind", "step", "imgs_per_sec", "imgs_per_sec_chip", "loss", "cls_loss",
        "box_loss", "num_positives", "grad_norm"}


def test_train_cli_writes_metrics_and_a_checkpoint(tmp_path):
    metrics = tmp_path / "train.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "object_detector_tpu_torch", "train", "--preset", "tiny_test",
         "--device", "cpu", "--steps", "3", "--metrics", str(metrics),
         "--checkpoint", str(tmp_path / "ck"), "--set", "train.log_every=2",
         "--set", "model.pool_grad_kernel=True"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 3]  # every log_every steps, and the last
    for r in rows:
        assert set(r) == KEYS and r["kind"] == "train"
        assert all(isinstance(r[k], float) for k in KEYS - {"kind", "step"})
        assert r["imgs_per_sec"] > 0 and r["loss"] > 0 and r["grad_norm"] > 0
    assert os.listdir(tmp_path / "ck") == ["step_3.pt"]
    assert "train step=3" in proc.stderr


def test_train_defaults_to_cuda_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    args = build_parser().parse_args(["train", "--preset", "tiny_test"])
    assert args.device == "cuda" and not args.resume and args.steps is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--preset", "tiny_test", "--steps", "1", "--checkpoint", str(tmp_path)])
    assert not os.listdir(tmp_path)  # refused before anything was written


def test_batch_size_above_the_dataset_surfaces_the_value_error(tmp_path):
    """Not a bare StopIteration out of the prefetcher's thread."""
    with pytest.raises(ValueError, match="yields zero batches at batch_size=128"):
        main(["train", "--preset", "tiny_test", "--device", "cpu", "--steps", "1",
              "--checkpoint", str(tmp_path), "--set", "train.batch_size=128"])


def test_train_refuses_what_is_not_ported(tmp_path):
    """Data parallelism is ported: mesh.data_parallel=8 on a host without 8
    devices raises the reference's error (parallel/mesh.py:58-62), in
    train() and in the command before it reads the dataset."""
    cards = torch.cuda.device_count()
    if cards >= 8:
        pytest.skip("this host has 8 CUDA devices; this checks the refusal with fewer")
    ds = make_synthetic_dataset(num_images=8, image_size=64)
    cfg = config.get_config("tiny_test").override({"mesh.data_parallel": 8})
    message = f"requested 8-way data parallelism but only {cards} devices"
    with pytest.raises(ValueError, match=message):
        train(cfg, ds, num_steps=1, checkpoint_dir=str(tmp_path), device="cuda")
    # The preset's VOC root does not exist here: the refusal comes first.
    with pytest.raises(ValueError, match=message):
        main(["train", "--preset", "ssd300_voc_train_dp8", "--steps", "1",
              "--checkpoint", str(tmp_path)])
    assert not os.listdir(tmp_path)
    # The VOC reader runs: with no data.root it finds no split file.
    with pytest.raises(FileNotFoundError, match="trainval.txt") as exc:
        main(["train", "--preset", "ssd300_vgg16_voc", "--device", "cpu", "--steps", "1",
              "--checkpoint", str(tmp_path)])
    assert exc.traceback[-1].name == "load_voc"


def test_train_takes_a_profile_and_logs_the_steps_really_done(tmp_path):
    ds = make_synthetic_dataset(num_images=8, image_size=64)
    cfg = config.get_config("tiny_test").override(
        {"train.log_every": 2, "train.checkpoint_dir": "", "data.num_workers": 1})
    state = train(cfg, ds, num_steps=3, metrics_path=str(tmp_path / "m.jsonl"),
                  profile_dir=str(tmp_path / "trace"), device="cpu")
    assert state.step == 3
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in os.listdir(tmp_path / "trace"))
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows] == [2, 3]
    # An empty train.checkpoint_dir and no --checkpoint: nothing is saved.
    assert sorted(os.listdir(tmp_path)) == ["m.jsonl", "trace"]
