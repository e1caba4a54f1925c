"""The port's checkpoints: resume continues step for step, retention, the
stale-directory refusal, and ``predict --checkpoint`` on what ``train`` wrote."""

import json
import os

import numpy as np
import pytest
import torch

from object_detector_tpu_torch.cli import main as cli
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.train.checkpoint import CheckpointManager
from object_detector_tpu_torch.train.loop import init_model_state, train
from object_detector_tpu_torch.train.state import create_train_state
from test_torch_resnet import small_configs

torch.set_num_threads(2)


def _cfg(model="vgg", **kw):
    """tiny_test, or with ``model="resnet"`` the 64 px SSD/ResNet-50 of
    tests/test_torch_resnet.py (BatchNorm with batch statistics)."""
    base = config.get_config("tiny_test") if model == "vgg" else small_configs()[1].override(
        {"train.warmup_steps": 0, "train.base_lr": 1e-2, "data.dataset": "synthetic"})
    return base.override(
        {"model.pool_grad_kernel": model == "vgg", "train.batch_size": 4, "train.log_every": 1,
         "data.num_workers": 1, **kw})


def _dataset():
    return make_synthetic_dataset(num_images=12, image_size=64)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("optimizer,ema,model", [("sgd", 0.9, "vgg"), ("adamw", 0.0, "vgg"),
                                                 ("sgd", 0.9, "resnet")],
                         ids=["sgd-0.9", "adamw-0.0", "sgd-0.9-resnet"])
def test_resume_continues_bit_for_bit(tmp_path, optimizer, ema, model):
    """4 steps in one run equal 2 steps, a save, a restore into a fresh
    state, and 2 more: parameters, BatchNorm running statistics, optimizer
    state, EMA and the logged losses. Augmentation is on, so the draws of
    steps 3 and 4 must come out of the seed and the step alone, and the
    data cursor must be restored."""
    cfg = _cfg(model, **{"train.optimizer": optimizer, "train.ema_decay": ema})
    ds = _dataset()
    whole = train(cfg, ds, num_steps=4, checkpoint_dir=str(tmp_path / "a"), device="cpu",
                  metrics_path=str(tmp_path / "a.jsonl"))
    train(cfg, ds, num_steps=2, checkpoint_dir=str(tmp_path / "b"), device="cpu",
          metrics_path=str(tmp_path / "b.jsonl"))
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    resumed = train(cfg, ds, num_steps=4, checkpoint_dir=str(tmp_path / "b"), device="cpu",
                    resume=True, metrics_path=str(tmp_path / "b.jsonl"))
    assert whole.step == resumed.step == 4
    _same(whole.params, resumed.params)
    _same(whole.batch_stats, resumed.batch_stats)
    assert len(whole.batch_stats) == (106 if model == "resnet" else 0)
    for name in whole.opt_state:
        _same(whole.opt_state[name], resumed.opt_state[name])
    if ema:
        _same(whole.ema_params, resumed.ema_params)
        assert not torch.equal(whole.ema_params["head0.cls.weight"], whole.params["head0.cls.weight"])
    else:
        assert resumed.ema_params is None
    rows = lambda p: [json.loads(line) for line in open(p)]  # noqa: E731
    a, b = rows(tmp_path / "a.jsonl"), rows(tmp_path / "b.jsonl")
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2, 3, 4]
    assert [r["loss"] for r in a] == [r["loss"] for r in b]


def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    cfg = _cfg(**{"train.ema_decay": 0.5})
    _, state = init_model_state(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(77)
    torch.rand(5, generator=gen)  # an advanced generator keeps its state
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=2)
    assert mgr.latest_step() is None and mgr.restore(state, gen) is None
    saved = []
    for step in range(1, 8):
        state.step = step
        saved.append(mgr.save(state, gen, data_step=step * 10))
    assert saved == [False, True, False, True, False, True, False]
    assert not mgr.save(state, gen, 60, step=6)  # already on disk
    assert mgr.save(state, gen, 70, force=True) and mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == ["step_6.pt", "step_7.pt"]  # keep last 2

    _, fresh = init_model_state(cfg, seed=4, device="cpu")
    assert not torch.equal(fresh.params["head0.cls.weight"], state.params["head0.cls.weight"])
    fresh_gen = torch.Generator().manual_seed(1)
    restored, restored_gen, data_step = CheckpointManager(str(tmp_path)).restore(fresh, fresh_gen)
    assert restored.step == 7 and data_step == 70
    _same({k: v.detach() for k, v in restored.params.items()},
          {k: v.detach() for k, v in state.params.items()})
    _same(restored.ema_params, state.ema_params)
    assert all(p.requires_grad for p in restored.params.values())
    assert restored_gen.initial_seed() == 77
    assert torch.equal(torch.rand(3, generator=restored_gen), torch.rand(3, generator=gen))


def test_restore_refuses_a_checkpoint_of_another_setup(tmp_path):
    cfg = _cfg()
    _, state = init_model_state(cfg, seed=0, device="cpu")
    gen = torch.Generator()
    CheckpointManager(str(tmp_path)).save(state, gen, 0, force=True)
    other = create_train_state(_cfg(**{"train.optimizer": "adamw"}).train,
                               {k: v.detach() for k, v in state.params.items()})
    with pytest.raises(ValueError, match="optimizer state"):
        CheckpointManager(str(tmp_path)).restore(other, gen)
    with_ema = create_train_state(_cfg(**{"train.ema_decay": 0.9}).train,
                                  {k: v.detach() for k, v in state.params.items()})
    with pytest.raises(ValueError, match="EMA"):
        CheckpointManager(str(tmp_path)).restore(with_ema, gen)
    _, wider = init_model_state(_cfg(**{"model.num_classes": 5}), seed=0, device="cpu")
    with pytest.raises(RuntimeError):  # a head of another width
        CheckpointManager(str(tmp_path)).restore(wider, gen)


def test_checkpoint_without_batch_stats_restores_vgg_and_is_refused_for_resnet(tmp_path):
    """A checkpoint in the format before the statistics were kept (no
    "batch_stats" key) restores an SSD-300/VGG16 state, which has none, and
    is refused for a ResNet-50 one, which would otherwise keep fresh
    statistics."""
    for model, seed in (("vgg", 3), ("resnet", 3)):
        cfg = _cfg(model)
        _, st = init_model_state(cfg, seed=seed, device="cpu")
        d = tmp_path / model
        CheckpointManager(str(d)).save(st, torch.Generator(), 0, force=True)
        path = d / "step_0.pt"
        payload = torch.load(path, weights_only=True)
        assert set(payload["batch_stats"]) == set(st.batch_stats)
        del payload["batch_stats"]
        torch.save(payload, path)
        _, fresh = init_model_state(cfg, seed=seed + 1, device="cpu")
        if model == "vgg":
            restored = CheckpointManager(str(d)).restore(fresh, torch.Generator())[0]
            _same({k: v.detach() for k, v in restored.params.items()},
                  {k: v.detach() for k, v in st.params.items()})
        else:
            with pytest.raises(ValueError, match="no BatchNorm running statistics"):
                CheckpointManager(str(d)).restore(fresh, torch.Generator())


def test_stale_directory_raises_without_resume(tmp_path):
    cfg = _cfg()
    ds = _dataset()
    train(cfg, ds, num_steps=1, checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="already has a checkpoint at step 1; pass --resume"):
        train(cfg, ds, num_steps=2, checkpoint_dir=str(tmp_path), device="cpu")
    # Resuming a finished run takes no step and keeps the checkpoint.
    again = train(cfg, ds, num_steps=1, checkpoint_dir=str(tmp_path), device="cpu", resume=True)
    assert again.step == 1 and CheckpointManager(str(tmp_path)).latest_step() == 1


def test_predict_checkpoint_serves_the_ema_weights(tmp_path, capsys):
    """`predict --checkpoint` on a directory `train` wrote restores the EMA
    weights where the checkpoint holds them, else the parameters."""
    from PIL import Image

    from object_detector_tpu_torch.cli.predictor import Predictor

    cfg = _cfg(**{"train.ema_decay": 0.5})
    state = train(cfg, _dataset(), num_steps=2, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    served = cli._restore_variables(cfg, str(tmp_path / "ck"))
    _same(served, state.ema_params)
    assert not torch.equal(served["head0.cls.weight"], state.params["head0.cls.weight"].detach())

    rng = np.random.default_rng(0)
    image = rng.integers(0, 80, (90, 120, 3), dtype=np.uint8)
    image[20:70, 30:100] = (220, 60, 60)
    path = tmp_path / "scene.png"
    Image.fromarray(image).save(path)
    argv = ["predict", "--preset", "tiny_test", "--device", "cpu", "--image", str(path),
            "--checkpoint", str(tmp_path / "ck"), "--score-threshold", "0.0",
            "--set", "train.ema_decay=0.5", "--set", "eval.max_detections=8"]
    assert cli.main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    want = Predictor(cfg.override({"eval.max_detections": 8}), state.ema_params,
                     device="cpu").predict_array(image, 0.0)
    assert len(lines) == len(want) > 0
    assert [d["score"] for d in lines] == [round(d.score, 4) for d in want]
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli.main(argv[:7] + ["--checkpoint", str(tmp_path / "empty")])
