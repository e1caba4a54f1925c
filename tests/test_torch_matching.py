"""Port vs reference: GT-to-anchor matching, batched in the port and mapped
over images with ``vmap`` in the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.ops import matching as ref_matching
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.ops import matching

torch.set_num_threads(2)


def _anchors():
    cfg = ref_config.get_config("tiny_test")
    return ref_priors.ssd_anchors(cfg.anchors, cfg.model.image_size)


def _gt(rng, batch, m):
    xy = rng.uniform(0, 0.6, (batch, m, 2))
    wh = rng.uniform(0.1, 0.4, (batch, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32)
    labels = rng.integers(1, 4, (batch, m)).astype(np.int32)
    valid = np.arange(m)[None, :] < rng.integers(1, m + 1, (batch, 1))
    return boxes, labels, valid


def _both(boxes, labels, valid, anchors, ref_cfg, port_cfg):
    want = jax.vmap(
        lambda b, l, v: ref_matching.match(b, l, v, jnp.asarray(anchors), ref_cfg, 0.1, 0.2)
    )(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
    got = matching.match(
        torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(anchors), port_cfg, 0.1, 0.2,
    )
    return got, want


def _assert_same(got, want):
    assert got.cls.dtype == torch.int32 and got.matched_gt.dtype == torch.int32
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(want.cls))
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    # exp/log of the encode round an ulp apart between XLA:CPU and torch.
    np.testing.assert_allclose(got.box.numpy(), np.asarray(want.box), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("defaults", {}),
        ("ignore_band", {"positive_iou": 0.5, "negative_iou": 0.3}),
        ("no_force_match", {"force_match_best": False, "negative_iou": 0.4}),
    ],
)
def test_match_equals_reference(name, kw):
    rng = np.random.default_rng(len(name))
    anchors = _anchors()
    boxes, labels, valid = _gt(rng, batch=6, m=8)
    valid[2] = False  # an image with no GT
    boxes[~valid] = 0.0  # padded rows, as the data pipeline leaves them
    labels[~valid] = 0
    got, want = _both(boxes, labels, valid, anchors,
                      ref_config.MatcherConfig(**kw), config.MatcherConfig(**kw))
    _assert_same(got, want)
    assert (got.cls[2] == 0).all() and (got.box[2] == 0).all()
    if name == "ignore_band":
        assert (got.cls == -1).any()
    assert (got.cls > 0).any()


def test_two_gts_claiming_one_anchor_last_one_wins():
    """Identical GT boxes share their best anchor; the reference's scatter
    lets the last GT win, the port's max-reduction says the same."""
    anchors = _anchors()
    box = np.array([0.2, 0.2, 0.55, 0.6], np.float32)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, :3] = box
    boxes[1, 0] = box
    boxes[1, 1] = [0.5, 0.5, 0.9, 0.9]
    boxes[1, 2] = box
    labels = np.array([[1, 2, 3, 0], [3, 1, 2, 0]], np.int32)
    valid = np.array([[True, True, True, False]] * 2)
    got, want = _both(boxes, labels, valid, anchors,
                      ref_config.MatcherConfig(positive_iou=0.99, negative_iou=0.99),
                      config.MatcherConfig(positive_iou=0.99, negative_iou=0.99))
    _assert_same(got, want)
    # Only forced anchors are positive at this threshold: the shared one
    # carries the last claimant's label.
    assert sorted(got.cls[0][got.cls[0] > 0].tolist()) == [3]
    assert sorted(got.cls[1][got.cls[1] > 0].tolist()) == [1, 2]


def test_match_takes_one_image_without_a_batch_dimension():
    rng = np.random.default_rng(3)
    anchors = _anchors()
    boxes, labels, valid = _gt(rng, batch=1, m=5)
    want = ref_matching.match(jnp.asarray(boxes[0]), jnp.asarray(labels[0]),
                              jnp.asarray(valid[0]), jnp.asarray(anchors),
                              ref_config.MatcherConfig())
    got = matching.match(torch.from_numpy(boxes[0]), torch.from_numpy(labels[0]),
                         torch.from_numpy(valid[0]), torch.from_numpy(anchors),
                         config.MatcherConfig())
    assert got.cls.shape == (anchors.shape[0],)
    _assert_same(got, want)


def test_first_argmax_takes_the_first_of_ties():
    x = torch.tensor([[-1.0, -1.0, -1.0], [0.5, 0.7, 0.7], [0.9, 0.1, 0.9]])
    assert matching.first_argmax(x, dim=1).tolist() == [0, 1, 0]
    assert matching.first_argmax(x, dim=0).tolist() == [2, 1, 2]
    np.testing.assert_array_equal(
        matching.first_argmax(x, dim=1).numpy(), np.asarray(jnp.argmax(jnp.asarray(x.numpy()), 1)))
