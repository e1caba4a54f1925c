"""Port vs reference: the native JPEG decode pool and the decoded cache on
real JPEG files.

The port builds ``native/jpeg_decoder.cpp`` into its own build directory
and loads it through its own ``ctypes`` binding; the reference loads
``native/libodt_jpeg.so``. Both must give the same pixels bit for bit: the
port's cache fills itself through the pool as the reference's does, so
`train` and `evaluate` on VOC/COCO files see the reference's images. The
cache tests are pinned to the library loading (``cache.decoder ==
"native"``), so a silent return to PIL-only decoding fails them.
"""

import logging

import numpy as np
import pytest

from object_detector_tpu.data import native_decode as ref_native
from object_detector_tpu.data import pipeline as ref_pipeline
from object_detector_tpu.data import types as ref_types
from object_detector_tpu_torch.data import native_decode, pipeline, types

# Noisy photos at VOC's and COCO's common sizes, a grayscale and a CMYK
# JPEG (which the pool may hand to PIL), and a file that is no JPEG at all.
SIZES = [(500, 375), (375, 500), (333, 500), (640, 480), (500, 333), (480, 640), (500, 375),
         (353, 500)]


@pytest.fixture(scope="module")
def gradient_files(tmp_path_factory):
    """The fixture of tests/test_native_decode.py: smooth gradients."""
    from PIL import Image

    root = tmp_path_factory.mktemp("gradients")
    paths = []
    for i, (w, h) in enumerate([(640, 480), (123, 457), (64, 64)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 255 / w).astype(np.uint8), (yy * 255 / h).astype(np.uint8),
                        np.full((h, w), 60 + 40 * i, np.uint8)], axis=-1)
        p = str(root / f"img{i}.jpg")
        Image.fromarray(img).save(p, quality=95)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def photo_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate(SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (w + h)], -1)
        img = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
        p = str(root / f"photo{i}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    gray = str(root / "gray.jpg")
    Image.fromarray(rng.integers(0, 256, (300, 400), dtype=np.uint8), "L").save(gray)
    cmyk = str(root / "cmyk.jpg")
    Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).convert("CMYK").save(cmyk)
    bad = str(root / "corrupt.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not really a jpeg")
    return paths + [gray, cmyk, bad]


def test_native_available():
    assert native_decode.available(), native_decode.load_error()
    assert native_decode.load_error() is None


def test_decode_batch_bit_equal_to_reference(gradient_files, photo_dir):
    """Exact: the same source under the same flags."""
    for files, size in ((gradient_files, 96), (photo_dir, 300)):
        got, got_ok = native_decode.decode_batch(files, size, num_threads=2)
        want, want_ok = ref_native.decode_batch(files, size, num_threads=2)
        assert got.shape == (len(files), size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got_ok, want_ok)
        np.testing.assert_array_equal(got, want)
    assert got_ok[:len(SIZES)].all() and not got_ok[-1]


def test_decode_batch_near_pil_on_smooth_content(gradient_files):
    """The reference's own bound (tests/test_native_decode.py): area and
    bilinear resampling differ by a mean absolute difference under 8 on
    smooth gradients."""
    from PIL import Image

    out, ok = native_decode.decode_batch(gradient_files, 96, num_threads=2)
    assert ok.all()
    for i, p in enumerate(gradient_files):
        with Image.open(p) as im:
            ref = np.asarray(im.convert("RGB").resize((96, 96), Image.BILINEAR), np.int16)
        assert np.mean(np.abs(out[i].astype(np.int16) - ref)) < 8.0


def test_decode_bad_file_zero_fills(tmp_path):
    bad = str(tmp_path / "not_a_jpeg.jpg")
    with open(bad, "wb") as f:
        f.write(b"hello world")
    out, ok = native_decode.decode_batch([bad], 32)
    assert (out == 0).all() and not ok[0]


def _datasets(paths):
    rng = np.random.default_rng(1)
    port, ref = [], []
    for i, p in enumerate(paths):
        m = 1 + i % 3
        xy = rng.uniform(0, 0.5, (m, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + 0.4], 1)
        labels = (np.arange(m) % 5 + 1).astype(np.int32)
        kw = dict(image_id=f"img{i}", path=p, width=100, height=100, boxes=boxes, labels=labels,
                  difficult=np.zeros(m, bool))
        port.append(types.ImageRecord(**kw))
        ref.append(ref_types.ImageRecord(**kw))
    names = [f"c{i}" for i in range(5)]
    return types.Dataset("photos", names, port), ref_types.Dataset("photos", names, ref)


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


@pytest.mark.parametrize("spill", [False, True])
def test_cache_bit_equal_to_reference_on_jpeg_files(photo_dir, tmp_path, caplog, spill):
    """The port's DecodedCache over JPEG files (one of them corrupt, which
    both decoders reject) against the reference's at 300 px: images, boxes,
    labels and valid bit for bit, and the same warnings."""
    ds, ref_ds = _datasets(photo_dir)
    extra = dict(max_ram_bytes=1000) if spill else {}
    with caplog.at_level(logging.WARNING):
        cache = pipeline.DecodedCache(ds, 300, max_boxes=6, num_workers=2,
                                      spill_dir=str(tmp_path / "port"), **extra)
        ref_cache = ref_pipeline.DecodedCache(ref_ds, 300, max_boxes=6, num_workers=2,
                                              spill_dir=str(tmp_path / "ref"), **extra)
    assert native_decode.available() and cache.decoder == "native" and not cache.reused
    assert (cache.memmap_path is not None) == spill
    for name in ("images", "boxes", "labels", "valid"):
        got, want = getattr(cache, name), getattr(ref_cache, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert not cache.images[-1].any()  # the corrupt file, undecodable by PIL too
    got, want = _warnings(caplog, "object_detector_tpu_torch"), _warnings(caplog,
                                                                          "object_detector_tpu")
    assert got == want
    assert any(m.startswith("native JPEG decode failed for ") for m in got)
    assert any(m.startswith(f"undecodable image {photo_dir[-1]} ") for m in got)


def test_cache_without_the_library_decodes_with_pil(photo_dir, monkeypatch, caplog):
    """Where the library cannot be had, PIL decodes every file, silently as
    the reference's does, and the cache says so."""
    ds, _ = _datasets(photo_dir[:3])
    monkeypatch.setattr(native_decode, "decode_batch", lambda *a, **k: None)
    with caplog.at_level(logging.WARNING):
        cache = pipeline.DecodedCache(ds, 64, max_boxes=6, num_workers=1)
    assert cache.decoder == "pil"
    assert not _warnings(caplog, "object_detector_tpu_torch")
    for i, p in enumerate(photo_dir[:3]):
        np.testing.assert_array_equal(cache.images[i], pipeline._decode_resize(p, 64))
