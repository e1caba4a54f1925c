"""Port vs reference: the detection losses, on the same logits and targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.losses import detection as ref_losses
from object_detector_tpu_torch.losses import detection as losses

torch.set_num_threads(2)

# exp/log/sigmoid round an ulp apart between XLA:CPU and torch; sums of a few
# thousand such terms stay within 1e-6 relative.
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, b=3, a=200, c=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.0, (b, a, c)).astype(np.float32)
    box_preds = rng.normal(0, 1.5, (b, a, 4)).astype(np.float32)
    box_targets = rng.normal(0, 1.0, (b, a, 4)).astype(np.float32)
    cls = rng.choice([-1, 0, 0, 0, 0, 1, 2, 3, 4][: c + 5], (b, a)).astype(np.int32)
    cls = np.minimum(cls, c)
    return logits, box_preds, cls, box_targets


def test_elementwise_losses_match_reference():
    logits, box_preds, cls, box_targets = _inputs(0)
    t = torch.from_numpy
    np.testing.assert_allclose(
        losses.sigmoid_focal_loss(t(logits), t(cls), 0.25, 2.0).numpy(),
        np.asarray(ref_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(cls), 0.25, 2.0)),
        **TOL)
    labels = (np.random.default_rng(1).random(logits.shape) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        losses.optax_sigmoid_ce(t(logits), t(labels)).numpy(),
        np.asarray(ref_losses.optax_sigmoid_ce(jnp.asarray(logits), jnp.asarray(labels))), **TOL)
    for beta in (1.0, 0.5):
        np.testing.assert_allclose(
            losses.smooth_l1(t(box_preds), t(box_targets), beta).numpy(),
            np.asarray(ref_losses.smooth_l1(jnp.asarray(box_preds), jnp.asarray(box_targets), beta)),
            **TOL)
    np.testing.assert_allclose(
        losses.softmax_ce_with_background(t(logits), t(np.minimum(cls, 3))).numpy(),
        np.asarray(ref_losses.softmax_ce_with_background(
            jnp.asarray(logits), jnp.asarray(np.minimum(cls, 3)))), **TOL)


@pytest.mark.parametrize("tied", [False, True])
def test_hard_negative_mining_mask_bit_equal(tied):
    rng = np.random.default_rng(2)
    b, a = 4, 300
    loss = rng.random((b, a)).astype(np.float32)
    if tied:  # five distinct losses: the ranks are decided by the stable order
        loss = (rng.integers(0, 5, (b, a)) / 4.0).astype(np.float32)
    positive = rng.random((b, a)) < 0.05
    positive[1] = False  # no positives: max(num_pos, 1) * 3 negatives kept
    valid = positive | (rng.random((b, a)) < 0.9)
    want = ref_losses.hard_negative_mine(jnp.asarray(loss), jnp.asarray(positive),
                                         jnp.asarray(valid), 3)
    got = losses.hard_negative_mine(torch.from_numpy(loss), torch.from_numpy(positive),
                                    torch.from_numpy(valid), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1].sum()) == 3


@pytest.mark.parametrize("use_focal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detection_loss_matches_reference(use_focal, dtype):
    """Logits in the compute dtype: both sides upcast to float32 first."""
    c = 4 if use_focal else 5  # softmax carries the background class
    logits, box_preds, cls, box_targets = _inputs(3, c=c)
    cls = np.minimum(cls, 4)
    kw = dict(use_focal=use_focal, focal_alpha=0.3, focal_gamma=1.5, smooth_l1_beta=0.8,
              box_loss_weight=1.3, negatives_per_positive=2)
    jl = jnp.asarray(logits).astype(jnp.dtype(dtype))
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype))
    want_total, want = ref_losses.detection_loss(
        jl, jnp.asarray(box_preds), jnp.asarray(cls), jnp.asarray(box_targets), **kw)
    got_total, got = losses.detection_loss(
        tl, torch.from_numpy(box_preds), torch.from_numpy(cls), torch.from_numpy(box_targets), **kw)
    assert got_total.dtype == torch.float32 and set(got) == set(want)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_detection_loss_without_positives_is_finite():
    logits, box_preds, cls, box_targets = _inputs(4)
    cls = np.minimum(cls, 0)
    total, metrics = losses.detection_loss(
        torch.from_numpy(logits), torch.from_numpy(box_preds), torch.from_numpy(cls),
        torch.from_numpy(box_targets))
    want_total, _ = ref_losses.detection_loss(
        jnp.asarray(logits), jnp.asarray(box_preds), jnp.asarray(cls), jnp.asarray(box_targets))
    assert float(metrics["num_positives"]) == 1.0 and float(metrics["box_loss"]) == 0.0
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
