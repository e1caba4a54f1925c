"""Port vs reference: augmentation. The two RNG streams cannot agree, so the
applying halves are compared at fixed parameters and the drawing halves are
held to their invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.ops import augment

torch.set_num_threads(2)

RECTS = {
    "identity": [0.0, 0.0, 1.0, 1.0],
    "crop": [0.22, 0.1, 0.81, 0.67],
    "expand": [-0.7, -1.3, 1.9, 1.3],  # beyond the image on every side
    "expand_corner": [0.0, -2.0, 3.0, 1.0],
}


def _scene(rng, h, w, m=6):
    img = rng.random((h, w, 3)).astype(np.float32)
    xy = rng.uniform(0, 0.7, (m, 2))
    wh = rng.uniform(0.05, 0.3, (m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(m) < m - 2
    return img, boxes, valid


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("name", list(RECTS))
def test_apply_geometric_matches_reference(name, flip):
    rng = np.random.default_rng(5)
    out_size = 24
    img, boxes, valid = _scene(rng, 20, 28)  # not square, not the output size
    rect = np.asarray(RECTS[name], np.float32)
    want_img, want_boxes, want_valid = ref_augment.apply_geometric(
        jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(rect),
        jnp.asarray(flip), out_size)
    # A batch of two: this rect, and another one that must not leak into it.
    other = np.asarray(RECTS["crop" if name != "crop" else "expand"], np.float32)
    t = torch.from_numpy
    got_img, got_boxes, got_valid = augment.apply_geometric(
        t(np.stack([img, img[::-1].copy()])), t(np.stack([boxes, boxes])),
        t(np.stack([valid, valid])), t(np.stack([rect, other])),
        torch.tensor([flip, not flip]), out_size)
    assert got_img.shape == (2, out_size, out_size, 3)
    # float32 sums of up to 28 weighted pixels, in another order than XLA's.
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_boxes[0].numpy(), np.asarray(want_boxes), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(want_valid))
    if name.startswith("expand"):  # outside the image reads the fill colour
        fill = img.mean(axis=(0, 1))
        corner = got_img[0, -1, 0 if flip else -1].numpy()
        np.testing.assert_allclose(corner, fill, atol=1e-5)


def test_resample_weights_match_jax():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    scale = np.asarray([1.0, 0.31, 2.7, 0.5], np.float32)
    trans = np.asarray([0.0, 4.2, -9.0, 0.25], np.float32)
    got = augment.resample_weights(20, 24, torch.from_numpy(scale), torch.from_numpy(trans))
    for i in range(4):
        want = compute_weight_mat(20, 24, jnp.float32(scale[i]), jnp.float32(trans[i]),
                                  _fill_triangle_kernel, True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _reference_photometric_params(key, cfg):
    """The reference's draws, with the key splits of ops/augment.py:59-94."""
    k_b, k_c, k_s, k_h, k_order = jax.random.split(key, 5)
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo, maxval=hi))  # noqa: E731
    return (
        u(k_b, -cfg.brightness_delta, cfg.brightness_delta),
        u(k_c, *cfg.contrast_range),
        u(k_s, *cfg.saturation_range),
        u(k_h, -cfg.hue_delta, cfg.hue_delta),
        bool(jax.random.bernoulli(k_order)),
    )


def test_photometric_chain_matches_reference_in_both_orders():
    cfg = ref_config.AugmentConfig()
    rng = np.random.default_rng(6)
    img = rng.random((10, 12, 3)).astype(np.float32)
    keys, seen = [], set()
    for seed in range(64):
        key = jax.random.key(seed)
        coin = _reference_photometric_params(key, cfg)[-1]
        if coin not in seen:
            seen.add(coin)
            keys.append(key)
    assert seen == {True, False}
    drawn = [_reference_photometric_params(k, cfg) for k in keys]
    params = augment.PhotometricParams(
        *(torch.tensor([d[i] for d in drawn]) for i in range(5)))
    got = augment.apply_photometric(torch.from_numpy(np.stack([img, img])), params)
    for i, key in enumerate(keys):
        want = ref_augment.photometric_jitter(jnp.asarray(img), key, cfg)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not torch.equal(got[0], got[1])


def test_preprocess_eval_matches_reference():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (30, 45, 3), dtype=np.uint8)  # downsample one axis, upsample neither
    want = ref_augment.preprocess_eval(jnp.asarray(img), 24)
    got = augment.preprocess_eval(torch.from_numpy(img), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    up = augment.preprocess_eval(torch.from_numpy(img[None, :12, :12]), 24)
    want_up = ref_augment.preprocess_eval(jnp.asarray(img[:12, :12]), 24)
    np.testing.assert_allclose(up[0].numpy(), np.asarray(want_up), rtol=0, atol=1e-5)


def test_apply_augment_matches_reference_composition():
    """The whole example at fixed parameters: photometric, geometric,
    normalize, against the reference's three functions chained."""
    cfg = ref_config.AugmentConfig()
    rng = np.random.default_rng(8)
    img_u8 = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    _, boxes, valid = _scene(rng, 16, 16)
    labels = np.arange(1, 7, dtype=np.int32)
    key = jax.random.key(3)
    b, c, s, h, first = _reference_photometric_params(key, cfg)
    rect, flip = np.asarray(RECTS["expand"], np.float32), True
    x = ref_augment.photometric_jitter(jnp.asarray(img_u8).astype(jnp.float32) / 255.0, key, cfg)
    x, want_boxes, want_valid = ref_augment.apply_geometric(
        x, jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(rect), jnp.asarray(flip), 16)
    want_img = ref_augment.normalize(x)
    params = augment.AugmentParams(
        augment.PhotometricParams(*(torch.tensor([v]) for v in (b, c, s, h, first))),
        torch.from_numpy(rect)[None], torch.tensor([flip]))
    t = torch.from_numpy
    got = augment.apply_augment(t(img_u8)[None], t(boxes)[None], t(labels)[None], t(valid)[None],
                                params, 16)
    # Normalizing divides by a std of about 0.225: 1e-5 on pixels becomes 5e-5.
    np.testing.assert_allclose(got.image[0].numpy(), np.asarray(want_img), rtol=0, atol=5e-5)
    np.testing.assert_allclose(got.boxes[0].numpy(), np.asarray(want_boxes), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got.labels[0].numpy(), labels)


def test_sampler_invariants_under_a_generator():
    cfg = config.AugmentConfig()
    rng = np.random.default_rng(9)
    batch, m = 256, 5
    xy = rng.uniform(0, 0.6, (batch, m, 2))
    boxes = torch.from_numpy(
        np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (batch, m, 2))], -1).astype(np.float32))
    valid = torch.from_numpy(np.arange(m)[None] < rng.integers(0, m + 1, (batch, 1)))
    gen = torch.Generator().manual_seed(11)
    rects, ok = augment._sample_crop_candidates(gen, boxes, valid, cfg)
    assert rects.shape == (batch, cfg.crop_candidates, 4) and ok.shape == rects.shape[:2]
    w, h = rects[..., 2] - rects[..., 0], rects[..., 3] - rects[..., 1]
    assert (rects[..., :2] >= 0).all() and (rects[..., 2:] <= 1 + 1e-6).all()
    area, ratio = w * h, w / h
    assert (area <= cfg.crop_area_range[1] + 1e-6).all() and (w <= 1).all() and (h <= 1).all()
    unclamped = (w < 1) & (h < 1)
    assert (area[unclamped] >= cfg.crop_area_range[0] - 1e-6).all()
    assert (ratio[unclamped] >= cfg.crop_aspect_range[0] - 1e-4).all()
    assert (ratio[unclamped] <= cfg.crop_aspect_range[1] + 1e-4).all()
    assert not ok[~valid.any(dim=1)].any()  # no GT: no candidate is valid
    assert ok.any()

    rect = augment.sample_source_rect(gen, boxes, valid, cfg)
    size = rect[:, 2:] - rect[:, :2]
    identity = (rect == torch.tensor([0.0, 0.0, 1.0, 1.0])).all(dim=1)
    expand = (size[:, 0] > 1) & ~identity
    crop = ~identity & ~expand
    assert identity.any() and expand.any() and crop.any()
    # Expand rects are squares of side r in [1, max] that contain the unit square.
    e = rect[expand]
    assert torch.allclose(e[:, 2] - e[:, 0], e[:, 3] - e[:, 1], atol=1e-6)
    assert ((e[:, 2] - e[:, 0]) <= cfg.expand_max_ratio).all()
    assert (e[:, :2] <= 0).all() and (e[:, 2:] >= 1).all()
    assert (rect[crop][:, :2] >= 0).all() and (rect[crop][:, 2:] <= 1 + 1e-6).all()
    # An image with no GT is never cropped.
    assert not crop[~valid.any(dim=1)].any()

    # Seeded: the same generator state draws the same parameters.
    a = augment.draw_augment(torch.Generator().manual_seed(5), boxes, valid, cfg)
    b = augment.draw_augment(torch.Generator().manual_seed(5), boxes, valid, cfg)
    c = augment.draw_augment(torch.Generator().manual_seed(6), boxes, valid, cfg)
    assert torch.equal(a.rect, b.rect) and torch.equal(a.flip, b.flip)
    assert torch.equal(a.photometric.hue, b.photometric.hue) and not torch.equal(a.rect, c.rect)
    p = a.photometric
    assert (p.brightness.abs() <= cfg.brightness_delta).all() and (p.hue.abs() <= cfg.hue_delta).all()
    assert (p.contrast >= cfg.contrast_range[0]).all() and (p.contrast <= cfg.contrast_range[1]).all()
    assert 0.3 < a.flip.float().mean() < 0.7 and 0.3 < p.contrast_first.float().mean() < 0.7


def test_augment_batch_and_example_run_and_keep_shapes():
    cfg = config.AugmentConfig()
    rng = np.random.default_rng(10)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7], [0.0, 0.0, 0.0, 0.0]]]).repeat(4, 1, 1)
    labels = torch.tensor([[2, 0]], dtype=torch.int32).repeat(4, 1)
    valid = torch.tensor([[True, False]]).repeat(4, 1)
    ex = augment.augment_batch(images, boxes, labels, valid, torch.Generator().manual_seed(1),
                               cfg, 24)
    assert ex.image.shape == (4, 24, 24, 3) and ex.image.dtype == torch.float32
    assert torch.isfinite(ex.image).all() and ex.boxes.shape == (4, 2, 4)
    assert (ex.boxes >= 0).all() and (ex.boxes <= 1).all() and not ex.valid[:, 1].any()
    one = augment.augment_example(images[0], boxes[0], labels[0], valid[0],
                                  torch.Generator().manual_seed(1), cfg, 24)
    assert one.image.shape == (24, 24, 3) and one.valid.shape == (2,)
