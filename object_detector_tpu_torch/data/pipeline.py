"""Host-side input pipeline: decode cache -> batches -> async copy to the device.

The port's own copy of ``object_detector_tpu/data/pipeline.py``. The host
does exactly one job: deliver fixed-size uint8 image canvases plus padded
annotations to the device. Everything after (photometric/geometric
augmentation, normalization, matching) happens in the train step on the
device.

- Images are decoded once and cached as a single (N, S, S, 3) uint8 array,
  plain-resized to the canvas.
- Batches are gathered by fancy-indexing the cache (zero decode on the hot
  path) and shipped by `DevicePrefetcher` from a background thread, so the
  transfer overlaps the previous step's compute.

Files are decoded with PIL; the reference's optional native JPEG decoder is
not part of the port yet.
"""

from __future__ import annotations

import concurrent.futures as futures
import hashlib
import logging
import os
import queue
import tempfile
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from object_detector_tpu_torch.data.types import Dataset, pad_annotations

_LOG = logging.getLogger("object_detector_tpu_torch")


def _decode_resize(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        # draft() lets libjpeg decode at reduced DCT scale: much cheaper
        # than full decode + resize for large photos.
        im.draft("RGB", (size, size))
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


class DecodedCache:
    """All-images uint8 cache: (N, S, S, 3) + padded annotations.

    For COCO-scale datasets the image array no longer fits in host RAM, so
    when its size exceeds `max_ram_bytes` the cache spills to a disk-backed
    `np.memmap` (`spill_dir`, default: alongside `cache_path` or a temp
    dir). `gather` fancy-indexing is unchanged: reads ride the OS page
    cache, and a completed spill file is reused across runs (annotations
    are cheap to rebuild; only pixels are memmapped).
    """

    def __init__(
        self,
        dataset: Dataset,
        image_size: int,
        max_boxes: int = 100,
        num_workers: int = 4,
        cache_path: Optional[str] = None,
        max_ram_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
    ):
        self.dataset = dataset
        self.image_size = image_size
        n = len(dataset)
        img_shape = (n, image_size, image_size, 3)
        self.boxes = np.zeros((n, max_boxes, 4), np.float32)
        self.labels = np.zeros((n, max_boxes), np.int32)
        self.valid = np.zeros((n, max_boxes), bool)

        self.memmap_path: Optional[str] = None
        spill = max_ram_bytes is not None and int(np.prod(img_shape)) > max_ram_bytes
        reuse_memmap = False
        if spill:
            if spill_dir is None:
                spill_dir = (
                    os.path.dirname(os.path.abspath(cache_path))
                    if cache_path
                    else tempfile.mkdtemp(prefix="odt_cache_")
                )
            os.makedirs(spill_dir, exist_ok=True)
            # The filename pins the dataset's identity, not just (n, size):
            # splits of equal length sharing one spill_dir must not reuse
            # each other's pixels.
            ident = hashlib.md5(
                "\n".join(
                    [dataset.name] + [r.path or r.image_id for r in dataset.records]
                ).encode()
            ).hexdigest()[:12]
            self.memmap_path = os.path.join(spill_dir, f"images_{ident}_{n}x{image_size}.npy")
            marker = self.memmap_path + ".complete"
            if os.path.exists(self.memmap_path) and os.path.exists(marker):
                self.images = np.lib.format.open_memmap(self.memmap_path, mode="r")
                reuse_memmap = self.images.shape == img_shape
            if not reuse_memmap:
                self.images = np.lib.format.open_memmap(
                    self.memmap_path, mode="w+", dtype=np.uint8, shape=img_shape
                )
        else:
            self.images = np.zeros(img_shape, np.uint8)

        if reuse_memmap:
            # Pixels are on disk already; only rebuild the (small) host-RAM
            # annotation arrays from the dataset records.
            for i, rec in enumerate(dataset.records):
                self.boxes[i], self.labels[i], self.valid[i] = pad_annotations(rec, max_boxes)
            return

        if not spill and cache_path and os.path.exists(cache_path):
            blob = np.load(cache_path)
            self.images, self.boxes = blob["images"], blob["boxes"]
            self.labels, self.valid = blob["labels"], blob["valid"]
            return

        def fill(i: int) -> None:
            rec = dataset.records[i]
            if rec.path:
                try:
                    self.images[i] = _decode_resize(rec.path, image_size)
                except Exception as exc:  # undecodable even by PIL
                    _LOG.warning("undecodable image %s (%s); using zeros", rec.path, exc)
            else:  # synthetic record: render procedurally
                from object_detector_tpu_torch.data.synthetic import render_synthetic_image

                self.images[i] = render_synthetic_image(rec, image_size)
            self.boxes[i], self.labels[i], self.valid[i] = pad_annotations(rec, max_boxes)

        workers = max(1, num_workers)
        if workers == 1 or n < 8:
            for i in range(n):
                fill(i)
        else:
            with futures.ThreadPoolExecutor(workers) as pool:
                list(pool.map(fill, range(n)))

        if self.memmap_path is not None:
            self.images.flush()
            with open(self.memmap_path + ".complete", "w") as f:
                f.write("ok\n")
            # Reopen read-only: training must never dirty cache pages.
            self.images = np.lib.format.open_memmap(self.memmap_path, mode="r")
        elif cache_path:
            np.savez(
                cache_path,
                images=self.images,
                boxes=self.boxes,
                labels=self.labels,
                valid=self.valid,
            )

    def __len__(self) -> int:
        return len(self.dataset)

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "image": self.images[idx],
            "boxes": self.boxes[idx],
            "labels": self.labels[idx],
            "valid": self.valid[idx],
        }


def epoch_batches(
    cache: DecodedCache,
    batch_size: int,
    seed: int,
    shuffle: bool = True,
    drop_remainder: bool = True,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic, resumable index-shuffled batch stream.

    `start_step` skips already-consumed batches after checkpoint resume (the
    dataset cursor is part of the checkpoint).
    """
    n = len(cache)
    steps_per_epoch = n // batch_size if drop_remainder else -(-n // batch_size)
    # Validate eagerly (this is a plain function returning a generator, not a
    # generator function): a raise inside the generator body would fire on
    # first next() inside the prefetcher thread and surface as a bare
    # StopIteration, hiding this message.
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset of {n} images yields zero batches at batch_size="
            f"{batch_size} with drop_remainder — reduce the batch size"
        )

    def generate():
        step = start_step
        while True:
            epoch = step // steps_per_epoch
            rng = np.random.default_rng(seed + epoch)
            order = rng.permutation(n) if shuffle else np.arange(n)
            for b in range(step % steps_per_epoch, steps_per_epoch):
                idx = order[b * batch_size : (b + 1) * batch_size]
                if len(idx) < batch_size and drop_remainder:
                    break
                yield cache.gather(idx)
                step += 1

    return generate()


def make_place(device: torch.device) -> Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """The prefetcher's host->device function: each array becomes a tensor on
    ``device``. For a CUDA device the host copy is pinned and the transfer is
    ``non_blocking`` on a stream of its own, with an event that the consumer's
    stream waits on (`DevicePrefetcher.__next__`)."""
    if device.type != "cuda":
        return lambda batch: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    stream = torch.cuda.Stream(device)

    def place(batch):
        with torch.cuda.stream(stream):
            out = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                for k, v in batch.items()
            }
            out["_ready"] = stream.record_event()
        return out

    return place


class DevicePrefetcher:
    """Background thread pushing host batches to the device N steps ahead.

    `place` is any host->device function (see `make_place`). A placed batch
    may carry a CUDA event under ``"_ready"``: the consumer's current stream
    is made to wait for it, and the key is removed, before the batch is
    handed out.
    """

    def __init__(self, iterator: Iterator, place, depth: int = 2):
        self._iter = iterator
        self._place = place
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        try:
            for batch in self._iter:
                self._put(self._place(batch))
                if self._stop.is_set():
                    return
        finally:
            self._put(self._done)

    def close(self) -> None:
        """Stops the thread (the batch stream never ends by itself) and drops
        what it had queued."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, dict) and "_ready" in item:
            item = dict(item)
            ready = item.pop("_ready")
            torch.cuda.current_stream().wait_event(ready)
            for v in item.values():
                v.record_stream(torch.cuda.current_stream())
        return item
