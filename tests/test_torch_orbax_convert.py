"""The reference's orbax checkpoints, converted for the port
(``tools/convert_orbax_checkpoint.py``).

The reference takes two steps with augmentation off and saves through its
``CheckpointManager``; the tool converts the directory; the port restores it
through its own ``CheckpointManager.restore`` (the code ``train --resume``
runs) and takes step 3, which must match the reference's step 3 within the
one-step tolerances of tests/test_torch_train_step.py (tiny_test, float32)
and tests/test_torch_resnet_train.py (SSD/ResNet-50 at 64 px, float64
compute: batch statistics and the EMA carried). The augmentations' random
draws differ by design and are off on both sides."""

import argparse
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.cli.main import _load_config as ref_load_config
from object_detector_tpu.train import state as ref_state
from object_detector_tpu.train import step as ref_step
from object_detector_tpu.train.checkpoint import CheckpointManager as RefCheckpointManager
from object_detector_tpu.train.loop import init_model_state as ref_init_model_state
from object_detector_tpu_torch.cli import main as cli
from object_detector_tpu_torch.cli.main import _load_config
from object_detector_tpu_torch.convert import flatten_tree, names_to_jax, opt_state_from_optax
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.train import step
from object_detector_tpu_torch.train.checkpoint import CheckpointManager
from object_detector_tpu_torch.train.loop import init_model_state
from test_torch_resnet_train import assert_step_matches, noise_batch, seeded_variables
from test_torch_train_step import _batch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "convert_orbax_checkpoint", os.path.join(REPO, "tools", "convert_orbax_checkpoint.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

TINY = ["train.ema_decay=0.9", "model.pool_grad_kernel=True"]
# ssd512_resnet50_coco cut to tests/test_torch_resnet.py's 64 px config,
# with the step settings of tests/test_torch_resnet_train.py.
RESNET64 = ["model.image_size=64", "model.num_classes=4", "model.compute_dtype='float64'",
            "anchors.feature_sizes=(8, 4, 2, 1, 1)",
            "anchors.sizes=((8., 16.), (16., 28.), (28., 40.), (40., 52.), (52., 62.))",
            "anchors.aspect_ratios=((2.0,), (2.0,), (2.0,), (2.0,), (2.0,))",
            "train.warmup_steps=0", "train.base_lr=1e-2", "train.ema_decay=0.9"]


def _configs(preset, sets):
    args = argparse.Namespace(preset=preset, set=sets, data_root=None)
    return ref_load_config(args), _load_config(args)


def _flax(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _run(tmp_path, preset, sets, batch, variables=None):
    """The reference's steps 1 and 2 saved and converted, and its step 3;
    the port's restore of the converted directory and its step 3."""
    ref_cfg, cfg = _configs(preset, sets)
    x64 = ref_cfg.model.compute_dtype == "float64"
    anchors = ref_priors.anchors_for_model(ref_cfg.model.family, ref_cfg.anchors,
                                           ref_cfg.model.image_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.enable_x64(x64):
        ref_model, st = ref_init_model_state(ref_cfg, jax.random.key(3))
        if variables is not None:  # seeded weights and BatchNorm statistics
            st = ref_state.create_train_state(ref_cfg.train, jax.tree.map(jnp.asarray, variables))
        ref_fn = ref_step.make_train_step(ref_cfg, ref_model, anchors, augment=False)
        mgr = RefCheckpointManager(str(tmp_path / "orbax"))
        for i in range(2):
            st, _ = ref_fn(st, jbatch, jax.random.key(i))
            mgr.save(st, jax.random.key(9), data_step=i + 1, step=i + 1, force=True)
            mgr.wait()
            if i == 0:
                step1 = _flax(st.params)
        mgr.close()
        saved = {"params": _flax(st.params), "batch_stats": _flax(st.batch_stats),
                 "ema": _flax(st.ema_params)}
        opt_state, count = opt_state_from_optax(st.opt_state)
        assert count == 2
        saved.update({f"opt {name}": names_to_jax(tree) for name, tree in opt_state.items()})
        st3, metrics3 = ref_fn(st, jbatch, jax.random.key(2))  # donates st
    argv = ["--preset", preset, "--src", str(tmp_path / "orbax"), "--dst", str(tmp_path / "port")]
    for s in sets:
        argv += ["--set", s]
    assert tool.main(argv) == 0
    assert sorted(os.listdir(tmp_path / "port")) == ["step_2.pt"]

    _, template = init_model_state(cfg, seed=5, device="cpu")
    restored = CheckpointManager(str(tmp_path / "port")).restore(template, torch.Generator())
    port, generator, data_step = restored
    assert (port.step, data_step, generator.initial_seed()) == (2, 2, cfg.train.seed)
    # Copies: names_to_jax shares the tensors' memory, which the step updates in place.
    before = {part: {k: v.copy() for k, v in names_to_jax(tree).items()} for part, tree in (
        ("params", port.params), ("batch_stats", port.batch_stats), ("ema", port.ema_params),
        *((f"opt {name}", port.opt_state[name]) for name in port.opt_state))}
    fn = step.make_train_step(cfg, build_model(cfg), anchors, device="cpu", augment=False)
    port, metrics = fn(port, {k: torch.from_numpy(v) for k, v in batch.items()}, generator)
    want = {"step": int(st3.step), "loss": float(metrics3["loss"]),
            "metrics": {k: float(v) for k, v in metrics3.items()},
            "params": _flax(st3.params), "ema": _flax(st3.ema_params),
            "batch_stats": _flax(st3.batch_stats)}
    got = {"step": port.step, "loss": float(metrics["loss"]),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "params": names_to_jax(port.params), "ema": names_to_jax(port.ema_params),
           "batch_stats": names_to_jax(port.batch_stats)}
    return want, got, before, saved, step1


def _assert_converted_exactly(before, saved):
    """The restored state is the reference's step-2 state bit for bit, in
    the port's float32 (the reference's float64-compute run keeps its
    running statistics in float64)."""
    for part, want in saved.items():
        assert set(before[part]) == set(want), part
        for k, v in want.items():
            assert before[part][k].dtype == np.float32
            np.testing.assert_array_equal(before[part][k], v.astype(np.float32),
                                          err_msg=f"{part} {k}")


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The two optimizers' runs; their checkpoints (a few hundred MB) are
    removed after the module."""
    out, roots = {}, []
    for opt, lr in (("sgd", 1e-2), ("adamw", 1e-3)):
        sets = TINY + [f"train.optimizer='{opt}'", f"train.base_lr={lr}"]
        _, cfg = _configs("tiny_test", sets)
        roots.append(tmp_path_factory.mktemp(opt))
        out[opt] = (sets, roots[-1] / "orbax",
                    _run(roots[-1], "tiny_test", sets, _batch(cfg, noise=True)))
    yield out
    for root in roots:
        shutil.rmtree(root)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_tiny_test_resumes_the_reference_step(tiny_runs, opt):
    """tiny_test (float32): the converted state is the reference's bit for
    bit, the optimizer state included (momentum trace, or Adam's moments);
    step 3's loss within 1e-5 and metrics within 1e-4 relative. sgd at 1e-2:
    params and EMA within rtol 1e-5 and atol 2e-6 (tests/test_torch_train_step.py).
    AdamW at 1e-3 divides each update by the gradient's own size, so where
    a gradient is near 1e-8 rounding moves the update by up to its whole
    size: every element within one update (lr), and no more than 1e-5 of
    them beyond 1e-5 (tests/test_torch_retinanet_train.py's class)."""
    _, _, (want, got, before, saved, _) = tiny_runs[opt]
    _assert_converted_exactly(before, saved)
    assert got["step"] == want["step"] == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    for part in ("params", "ema"):
        assert set(got[part]) == set(want[part])
        if opt == "sgd":
            for k, v in want[part].items():
                np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=2e-6,
                                           err_msg=f"{part} {k}")
            continue
        diff = np.concatenate([np.abs(got[part][k] - v).ravel() for k, v in want[part].items()])
        assert diff.max() <= 1e-3 and np.mean(diff > 1e-5) <= 1e-5, (part, diff.max())


def test_train_resume_continues_a_converted_checkpoint(tiny_runs, tmp_path, capsys):
    """`--step 1` converts the earlier checkpoint, bit for bit; `train
    --resume --device cpu` on the conversion of the latest takes one more
    step and checkpoints step 3."""
    sets, orbax, (_, _, _, _, step1) = tiny_runs["sgd"]
    argv = ["--preset", "tiny_test", "--src", str(orbax)]
    for s in sets:
        argv += ["--set", s]
    assert tool.main(argv + ["--step", "1", "--dst", str(tmp_path / "one")]) == 0
    payload = torch.load(tmp_path / "one" / "step_1.pt", weights_only=True)
    assert (payload["step"], payload["data_step"]) == (1, 1)
    got = names_to_jax(payload["params"])
    assert set(got) == set(step1)
    for k, v in step1.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    src = tmp_path / "port"
    assert tool.main(argv + ["--dst", str(src)]) == 0
    train_argv = ["train", "--preset", "tiny_test", "--device", "cpu", "--steps", "3",
                  "--checkpoint", str(src), "--resume"]
    for s in sets:
        train_argv += ["--set", s]
    assert cli.main(train_argv) == 0
    assert CheckpointManager(str(src)).latest_step() == 3
    payload = torch.load(src / "step_3.pt", weights_only=True)
    assert payload["step"] == 3 and payload["data_step"] == 3
    shutil.rmtree(tmp_path)  # a few hundred MB of checkpoints


@pytest.mark.parametrize("part", ["loss", "params", "ema", "batch_stats"])
def test_batch_norm_family_carries_statistics_and_ema(resnet_run, part):
    """SSD/ResNet-50 at 64 px in float64 compute, seeded BatchNorm
    statistics: the converted state is the reference's (106 running
    statistics, the EMA), and step 3 within tests/test_torch_resnet_train.py's
    tolerances (running statistics 1e-4, params and EMA rtol 1e-5 with
    atol 2e-6)."""
    want, got, before, saved = resnet_run
    _assert_converted_exactly(before, saved)
    assert len(saved["batch_stats"]) == 106
    if part == "loss":
        assert got["step"] == want["step"] == 3
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    else:
        assert_step_matches(want, got, part)


@pytest.fixture(scope="module")
def resnet_run(tmp_path_factory):
    _, cfg = _configs("ssd512_resnet50_coco", RESNET64)
    root = tmp_path_factory.mktemp("resnet")
    want, got, before, saved, _ = _run(root, "ssd512_resnet50_coco", RESNET64,
                                       noise_batch(cfg, 2), variables=seeded_variables(cfg, seed=3))
    shutil.rmtree(root)
    return want, got, before, saved
