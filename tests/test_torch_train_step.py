"""Port vs reference: the training path as a whole on ``tiny_test`` with
``pool_grad_kernel=True``: the same parameters and the same batch give the
same loss, the same gradients leaf by leaf and the same parameters after
the update. The reference's pool kernel runs in interpret mode, the port's
wrapper runs its plain version (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.losses.detection import detection_loss as ref_detection_loss
from object_detector_tpu.models import ssd as ref_ssd
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.train import state as ref_state
from object_detector_tpu.train import step as ref_step
from object_detector_tpu_torch.convert import flatten_tree, names_to_jax, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.kernels import pool_bwd
from object_detector_tpu_torch.models import ssd
from object_detector_tpu_torch.train import state, step

torch.set_num_threads(2)

OVERRIDES = {"model.pool_grad_kernel": True}


def _batch(cfg, n=8, noise=False):
    """A batch of the synthetic dataset. With ``noise`` the pixels are seeded
    noise under the same boxes: the rendered images hold flat rectangles,
    where a pool window's four values are equal up to the last bit of two
    frameworks' convolutions, and which of them takes the gradient is then
    decided by rounding."""
    cache = DecodedCache(make_synthetic_dataset(num_images=n, image_size=cfg.model.image_size),
                         cfg.model.image_size, cfg.data.max_boxes, num_workers=1)
    batch = cache.gather(np.arange(n))
    if noise:
        batch["image"] = np.random.default_rng(0).integers(
            0, 256, batch["image"].shape, dtype=np.uint8)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup(overrides):
    ref_cfg = ref_config.get_config("tiny_test").override(overrides)
    cfg = config.get_config("tiny_test").override(overrides)
    ref_model = ref_ssd.SSDModel(ref_cfg)
    s = cfg.model.image_size
    variables = ref_model.init(jax.random.key(0), jnp.zeros((1, s, s, 3), jnp.float32), train=True)
    anchors = ref_priors.ssd_anchors(ref_cfg.anchors, s)
    return ref_cfg, cfg, ref_model, variables, anchors


@pytest.fixture(scope="module")
def both():
    return _setup(OVERRIDES)


@pytest.mark.parametrize("use_focal", [True, False])
def test_one_step_matches_reference(both, use_focal):
    if use_focal:
        ref_cfg, cfg, ref_model, variables, anchors = both
    else:  # softmax + mining: the heads carry the background class as logit 0
        ref_cfg, cfg, ref_model, variables, anchors = _setup(
            {**OVERRIDES, "train.use_focal": False, "model.num_classes": 4})
    batch = _batch(cfg, noise=True)
    flat = {k: np.array(v) for k, v in flatten_tree(variables["params"]).items()}

    # Reference: the gradients from its own pieces, the update from its step.
    def ref_loss(params):
        images = ref_augment.normalize(jnp.asarray(batch["image"]).astype(jnp.float32) / 255.0)
        targets = ref_step.encode_batch_targets(
            jnp.asarray(batch["boxes"]), jnp.asarray(batch["labels"]), jnp.asarray(batch["valid"]),
            jnp.asarray(anchors), ref_cfg)
        cls_logits, box_preds = ref_model.apply({"params": params}, images, train=True)
        t = ref_cfg.train
        return ref_detection_loss(
            cls_logits, box_preds, targets.cls, targets.box, use_focal=t.use_focal,
            focal_alpha=t.focal_alpha, focal_gamma=t.focal_gamma, smooth_l1_beta=t.smooth_l1_beta,
            box_loss_weight=t.box_loss_weight, negatives_per_positive=t.negatives_per_positive)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss))(variables["params"])
    want_grads = flatten_tree(want_grads)
    ref_st = ref_state.create_train_state(ref_cfg.train, jax.tree.map(jnp.copy, variables))
    ref_fn = ref_step.make_train_step(ref_cfg, ref_model, anchors, augment=False)
    ref_st, want_metrics = ref_fn(ref_st, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.key(0))
    want_params = flatten_tree(ref_st.params)

    # Port.
    model = ssd.SSDModel(cfg)
    st = state.create_train_state(cfg.train, params_from_jax(flat))
    fn = step.make_train_step(cfg, model, anchors, device="cpu", augment=False)
    total, _, stats = fn.loss_fn(st.params, st.batch_stats, _tensors(batch), seed=0)
    assert st.batch_stats == stats == {}
    grads = dict(zip(st.params, torch.autograd.grad(total, list(st.params.values()))))
    st, metrics = fn(st, _tensors(batch), torch.Generator().manual_seed(0))

    assert st.step == 1 and int(ref_st.step) == 1
    np.testing.assert_allclose(float(total.detach()), float(want_loss), rtol=1e-5)
    assert set(metrics) == set(want_metrics) == {
        "loss", "cls_loss", "box_loss", "num_positives", "grad_norm"}
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=1e-4, err_msg=k)
    got_grads = names_to_jax(grads)
    assert set(got_grads) == set(want_grads)
    for k in want_grads:
        # float32 convolutions sum in another order than XLA's; 1e-4 absolute is
        # the reference's own tolerance class between two of its programs.
        np.testing.assert_allclose(got_grads[k], want_grads[k], rtol=1e-4, atol=1e-4, err_msg=k)
    got_params = names_to_jax(st.params)
    for k in want_params:
        # lr 1e-2 times a clipped gradient that agrees within 1e-4.
        np.testing.assert_allclose(got_params[k], want_params[k], rtol=1e-5, atol=2e-6, err_msg=k)
        if k.endswith("kernel"):  # the weight decay alone moves every kernel
            assert not np.array_equal(got_params[k], flat[k]), f"{k} did not move"


def test_step_with_and_without_the_pool_flag_gives_the_same_gradients(both):
    """The first-max pool backward equals the library's: the flag changes the
    route, not the numbers."""
    _, cfg, _, variables, anchors = both
    batch = _tensors(_batch(cfg))
    flat = flatten_tree(variables["params"])
    grads = {}
    for flag in (True, False):
        c = cfg.override({"model.pool_grad_kernel": flag})
        st = state.create_train_state(c.train, params_from_jax(flat))
        fn = step.make_train_step(c, ssd.SSDModel(c), anchors, device="cpu", augment=False)
        total, _, _ = fn.loss_fn(st.params, st.batch_stats, batch, seed=0)
        grads[flag] = torch.autograd.grad(total, list(st.params.values()))
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_step_runs_four_pool_backwards(both, monkeypatch):
    _, cfg, _, variables, anchors = both
    calls = []
    real = pool_bwd.max_pool_bwd_reference
    monkeypatch.setattr(pool_bwd, "max_pool_bwd_reference",
                        lambda x, y, g: calls.append(tuple(x.shape)) or real(x, y, g))
    st = state.create_train_state(cfg.train, params_from_jax(flatten_tree(variables["params"])))
    fn = step.make_train_step(cfg, ssd.SSDModel(cfg), anchors, device="cpu", augment=False)
    fn(st, _tensors(_batch(cfg)), torch.Generator().manual_seed(0))
    assert sorted(c[2] for c in calls) == [8, 16, 32, 64]


def test_augmented_step_is_finite_and_seeded_by_seed_and_step(both):
    _, cfg, _, variables, anchors = both
    batch = _tensors(_batch(cfg))
    flat = flatten_tree(variables["params"])

    def run(seed, steps):
        st = state.create_train_state(cfg.train, params_from_jax(flat))
        fn = step.make_train_step(cfg, ssd.SSDModel(cfg), anchors, device="cpu", augment=True)
        gen = torch.Generator().manual_seed(seed)
        out = []
        for _ in range(steps):
            st, m = fn(st, batch, gen)
            out.append(float(m["loss"]))
        return out, st

    a, st = run(3, 2)
    b, _ = run(3, 2)
    c, _ = run(4, 1)
    assert all(np.isfinite(a)) and a == b and a[0] != c[0] and a[0] != a[1]
    assert all(torch.isfinite(p).all() for p in st.params.values())
    assert step.fold_in(3, 0) != step.fold_in(3, 1) != step.fold_in(4, 0)
    assert 0 <= step.fold_in(2**40, 10**9) < 2**63


def test_overfit_one_batch_falls():
    """Four images, the port's own seeded init, 12 SGD steps: the loss falls
    below half (the reference's overfit check, made cheap)."""
    from object_detector_tpu_torch.train.loop import init_model_state

    cfg = config.get_config("tiny_test").override({**OVERRIDES, "train.base_lr": 5e-3})
    anchors = ref_priors.ssd_anchors(ref_config.get_config("tiny_test").anchors, 64)
    batch = _tensors(_batch(cfg, n=4))
    model, st = init_model_state(cfg, seed=0, device="cpu")
    fn = step.make_train_step(cfg, model, anchors, device="cpu", augment=False)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(12):
        st, m = fn(st, batch, gen)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and st.step == 12
    assert losses[-1] < 0.5 * losses[0], f"no learning: {losses}"


def test_unported_families_raise(both):
    """The step is built for the two BatchNorm families too (their steps
    against the reference: tests/test_torch_resnet_train.py,
    tests/test_torch_retinanet_train.py); without a card the default device
    raises."""
    _, cfg, _, _, anchors = both
    for kw in ({"model.backbone": "resnet50"}, {"model.family": "retinanet"}):
        c = cfg.override(kw)
        fn = step.make_train_step(c, torch.nn.Identity(), anchors, device="cpu")
        assert callable(fn.loss_fn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            step.make_train_step(cfg, ssd.SSDModel(cfg), anchors)


def test_remat_block1_steps_equal_the_plain_steps(both, monkeypatch):
    """model.remat_block1 (reference models/vgg.py:141-142) recomputes block
    1 in the backward under torch.utils.checkpoint. Two augmented steps with
    the pool kernel's route on: the metrics and the updated parameters bit
    for bit those without it, four pool backwards a step either way. The
    second step's parameters are the train state's, no longer the module's
    own, which the recompute must not read."""
    _, cfg, _, variables, anchors = both
    batch = _tensors(_batch(cfg))
    flat = flatten_tree(variables["params"])
    calls = []
    real = pool_bwd.max_pool_bwd_reference
    monkeypatch.setattr(pool_bwd, "max_pool_bwd_reference",
                        lambda x, y, g: calls.append(1) or real(x, y, g))
    runs = {}
    for remat in (False, True):
        c = cfg.override({"model.remat_block1": remat, "model.pool_grad_kernel": True})
        st = state.create_train_state(c.train, params_from_jax(flat))
        fn = step.make_train_step(c, ssd.SSDModel(c), anchors, device="cpu", augment=True)
        gen = torch.Generator().manual_seed(5)
        calls.clear()
        metrics = [fn(st, batch, gen)[1] for _ in range(2)]
        runs[remat] = (metrics, st.params, len(calls))
    (m0, p0, n0), (m1, p1, n1) = runs[False], runs[True]
    assert n0 == n1 == 8
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
