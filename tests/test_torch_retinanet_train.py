"""Port vs reference: training RetinaNet/FPN with batch statistics on
`tiny_retinanet_config` (ResNet-50's depth and widths at 128 px, FPN and
heads of 32 channels, one conv a subnet): one AdamW step against the
reference's ``make_train_step(augment=False)``, and the counterpart of
tests/test_retinanet_train.py (the loss falls on a fixed batch, the
running statistics move)."""

import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu_torch.anchors.priors import retinanet_anchors
from object_detector_tpu_torch.convert import names_to_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.train import step
from object_detector_tpu_torch.train.loop import init_model_state
from test_torch_resnet_train import (
    FLOAT64, assert_step_matches, noise_batch, seeded_variables, step_against_reference,
)

torch.set_num_threads(2)

SIZE = 128


@pytest.fixture(scope="module")
def retinanet_step():
    """AdamW at 1e-3 with weight decay and clipping, no EMA, batch 2, in
    float64 (see test_torch_resnet_train.FLOAT64). The reference runs op by
    op: its jitted program on XLA:CPU gives this model gradients up to 12%
    from its own op-by-op ones (C5's blocks, then everything before them),
    where the port agrees with the op-by-op ones within 1e-7. About two
    minutes, most of it the reference's eager dispatch."""
    overrides = {**FLOAT64, "train.optimizer": "adamw", "train.base_lr": 1e-3}
    ref_cfg, cfg = (mod.tiny_retinanet_config().override(overrides)
                    for mod in (ref_config, config))
    variables = seeded_variables(cfg, seed=4)
    return step_against_reference(ref_cfg, cfg, variables, noise_batch(cfg, 2, seed=1),
                                  op_by_op=True)


@pytest.mark.parametrize("part", ["loss", "grads", "params", "batch_stats"])
def test_one_step_matches_reference(retinanet_step, part):
    """Params within 1e-5 absolute: Adam's first step moves an element by
    lr * g / (|g| + 1e-8), so where |g| is near 1e-8 a gradient 1e-10 apart
    moves it by 0.4% of lr (1e-3)."""
    want, got, _ = retinanet_step
    assert_step_matches(want, got, part, params_atol=1e-5)
    if part == "loss":
        assert want["ema"] is None and got["ema"] is None


def test_one_step_moves_every_statistic(retinanet_step):
    _, got, before = retinanet_step
    stats = got["batch_stats"]
    assert len(stats) == 106 and all(k.startswith("backbone/") for k in stats)
    old = names_to_jax(before["batch_stats"])
    assert all(not np.array_equal(stats[k], old[k]) for k in stats)


def test_overfit_fixed_batch_loss_falls_and_statistics_move():
    """The counterpart of tests/test_retinanet_train.py::test_retinanet_overfit_smoke:
    the same config, batch and 12 SGD steps at 1e-2; the loss falls and the
    state carries moved running statistics. About 8 s on 2 CPU threads."""
    cfg = config.DetectorConfig(
        name="retinanet_tiny",
        model=config.ModelConfig(family="retinanet", backbone="resnet50", image_size=SIZE,
                                 num_classes=3, fpn_channels=32, head_depth=1,
                                 compute_dtype="float32"),
        anchors=config.retinanet_anchor_config(SIZE),
        data=config.DataConfig(dataset="synthetic", max_boxes=4),
        train=config.TrainConfig(batch_size=2, num_steps=10, warmup_steps=0, base_lr=1e-2,
                                 optimizer="sgd"),
    )
    model, st = init_model_state(cfg, seed=0, device="cpu")
    anchors = retinanet_anchors(SIZE)
    assert cfg.anchors.num_anchors == anchors.shape[0]
    fn = step.make_train_step(cfg, model, anchors, device="cpu", augment=False)
    rng = np.random.default_rng(0)
    m = cfg.data.max_boxes
    batch = {
        "image": torch.from_numpy(rng.integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)),
        "boxes": torch.tensor([[[0.2, 0.2, 0.7, 0.7]]]).repeat(2, m, 1),
        "labels": torch.ones((2, m), dtype=torch.int32),
        "valid": torch.from_numpy(np.tile(np.arange(m) < 1, (2, 1))),
    }
    initial = {k: v.clone() for k, v in st.batch_stats.items()}
    losses = []
    gen = torch.Generator().manual_seed(1)
    for _ in range(12):
        st, metrics = fn(st, batch, gen)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"retinanet not learning: {losses[:3]} -> {losses[-3:]}"
    assert len(st.batch_stats) == 106
    assert all(not torch.equal(v, initial[k]) for k, v in st.batch_stats.items())
    assert all(bool((v >= 0).all()) for k, v in st.batch_stats.items() if k.endswith("var"))
