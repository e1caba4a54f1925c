"""Port vs reference: learning-rate schedules and the SGD / AdamW updates
with clipping and EMA, against optax on given gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.train import state as ref_state
from object_detector_tpu_torch.convert import (
    flatten_tree, names_to_jax, opt_state_from_optax, params_from_jax,
)
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.train import state

torch.set_num_threads(2)


@pytest.mark.parametrize("schedule", ["cosine", "step"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_optax(schedule, warmup):
    kw = dict(schedule=schedule, warmup_steps=warmup, num_steps=60, base_lr=0.02)
    want = ref_state.make_schedule(ref_config.TrainConfig(**kw))
    got = state.make_schedule(config.TrainConfig(**kw))
    steps = list(range(0, 75)) + [500]
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=1e-9)
    if warmup:
        assert got(0) == 0.0  # the first update's rate is 0 under a warmup
    if schedule == "step":  # boundaries count from the end of the warmup
        assert got(warmup + 39) == pytest.approx(0.02) and got(warmup + 40) == pytest.approx(0.002)
        assert got(warmup + 50) == pytest.approx(0.0002)


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="schedule"):
        state.make_schedule(config.TrainConfig(schedule="linear"))
    with pytest.raises(ValueError, match="optimizer"):
        state.make_optimizer(config.TrainConfig(optimizer="lamb"))


def _flax_params(rng):
    return {
        "backbone": {"conv1_1": {"kernel": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
                                 "bias": rng.normal(size=(4,)).astype(np.float32)}},
        "l2norm": {"scale": np.full((4,), 20.0, np.float32)},
        "head0": {"cls": {"kernel": rng.normal(size=(3, 3, 4, 6)).astype(np.float32),
                          "bias": np.full((6,), -4.595, np.float32)}},
    }


@pytest.mark.parametrize("optimizer,clip,ema", [
    ("sgd", 10.0, 0.0),
    ("sgd", 0.5, 0.9),  # every step clipped
    ("sgd", 0.0, 0.0),  # no clipping at all
    ("adamw", 0.5, 0.99),
    ("adamw", 100.0, 0.0),
])
def test_updates_match_optax_over_three_steps(optimizer, clip, ema):
    kw = dict(optimizer=optimizer, grad_clip_norm=clip, ema_decay=ema, base_lr=0.05,
              warmup_steps=2, num_steps=10, weight_decay=5e-3, momentum=0.9)
    ref_cfg, cfg = ref_config.TrainConfig(**kw), config.TrainConfig(**kw)
    rng = np.random.default_rng(0)
    flax_params = jax.tree.map(jnp.asarray, _flax_params(rng))
    opt = ref_state.make_optimizer(ref_cfg)
    ref = ref_state.create_train_state(ref_cfg, {"params": flax_params})
    st = state.create_train_state(cfg, params_from_jax(flatten_tree(flax_params)))
    update = state.make_optimizer(cfg)
    assert (st.ema_params is None) == (ema == 0.0)

    params, opt_state, ema_params = ref.params, ref.opt_state, ref.ema_params
    for step in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), flax_params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if ema_params is not None:
            ema_params = jax.tree.map(lambda e, p: e * ema + p * (1.0 - ema), ema_params, params)

        update(st, params_from_jax(flatten_tree(grads)))
        st.step += 1

        want = flatten_tree(params)
        got = names_to_jax(st.params)
        assert set(got) == set(want)
        for k in want:  # float32 updates in another order of roundings than XLA's
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=f"{k} step {step}")
        if ema_params is not None:
            got_ema, want_ema = names_to_jax(st.ema_params), flatten_tree(ema_params)
            for k in want_ema:
                np.testing.assert_allclose(got_ema[k], want_ema[k], rtol=1e-6, atol=1e-6)

    # The optimizer state carried across from optax equals the port's own.
    carried, count = opt_state_from_optax(opt_state)
    assert count == 3 == st.step and set(carried) == set(st.opt_state)
    for name, tree in carried.items():
        for k, v in tree.items():
            np.testing.assert_allclose(st.opt_state[name][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6)


def test_weight_decay_reaches_biases_and_the_l2norm_scale():
    cfg = config.TrainConfig(optimizer="sgd", momentum=0.0, grad_clip_norm=0.0, warmup_steps=0,
                             base_lr=0.1, weight_decay=0.5, num_steps=10)
    params = params_from_jax(flatten_tree(_flax_params(np.random.default_rng(1))))
    st = state.create_train_state(cfg, params)
    state.make_optimizer(cfg)(st, {k: torch.zeros_like(v) for k, v in params.items()})
    for k, v in params.items():  # p - lr * wd * p
        np.testing.assert_allclose(st.params[k].detach().numpy(), (v * 0.95).numpy(), rtol=1e-6)


def test_clip_has_no_epsilon_and_global_norm_is_optax():
    grads = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    assert float(state.global_norm(grads)) == 5.0
    cfg = config.TrainConfig(optimizer="sgd", momentum=0.0, weight_decay=0.0, warmup_steps=0,
                             base_lr=1.0, grad_clip_norm=2.5, num_steps=10**9)
    st = state.create_train_state(cfg, {k: torch.zeros_like(v) for k, v in grads.items()})
    state.make_optimizer(cfg)(st, grads)
    # Scaled by exactly max_norm / norm = 0.5.
    assert st.params["a"].tolist() == [-1.5, 0.0] and st.params["b"].tolist() == [[-2.0]]


def test_train_state_is_its_own_copy_of_the_params():
    cfg = config.TrainConfig(ema_decay=0.5)
    src = {"w.weight": torch.ones(2, 2, 1, 1), "w.bias": torch.zeros(2)}
    st = state.create_train_state(cfg, src)
    st.params["w.bias"].data.add_(1.0)
    assert src["w.bias"].sum() == 0 and st.ema_params["w.bias"].sum() == 0
    assert all(p.requires_grad and p.dtype == torch.float32 for p in st.params.values())
    assert dataclasses.is_dataclass(st) and st.step == 0
