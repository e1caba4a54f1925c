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

Files are decoded by the native JPEG pool, as the reference's cache decodes
them, and by PIL where the pool rejects a file or cannot be built.
"""

from __future__ import annotations

import concurrent.futures as futures
import contextlib
import fcntl
import hashlib
import logging
import os
import queue
import socket
import tempfile
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from object_detector_tpu_torch.data import native_decode
from object_detector_tpu_torch.data.types import Dataset, pad_annotations
from object_detector_tpu_torch.parallel.mesh import Mesh

_LOG = logging.getLogger("object_detector_tpu_torch")

# File-backed records go to the native pool this many at a time: the
# decode buffer stays bounded (about 0.75 GB at 512 px) whatever the
# dataset's size.
DECODE_CHUNK = 1024


def _decode_resize(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        # draft() lets libjpeg decode at reduced DCT scale: much cheaper
        # than full decode + resize for large photos.
        im.draft("RGB", (size, size))
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


@contextlib.contextmanager
def _locked(path: str) -> Iterator[None]:
    """An exclusive lock on ``path`` among the processes of this host
    (released when the file closes or the process ends)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def _host_spill_dir(mesh: Optional[Mesh], writer: bool) -> str:
    """A new temporary directory, made by the writer of each host; under a
    mesh every rank gets its host's writer's directory."""
    made = tempfile.mkdtemp(prefix="odt_cache_") if writer else ""
    if mesh is None:
        return made
    host = socket.gethostname()
    rows = [None] * mesh.world
    dist.all_gather_object(rows, (host, made) if writer else None, group=mesh.group)
    dirs = [row[1] for row in rows if row is not None and row[0] == host]
    if len(dirs) != 1:
        raise RuntimeError(f"{len(dirs)} cache writers on host {host}, expected one")
    return dirs[0]


class DecodedCache:
    """All-images uint8 cache: (N, S, S, 3) + padded annotations.

    File-backed records are decoded by the native pool (`native_decode`),
    as the reference's cache decodes them; files it rejects go to PIL with
    a warning, and PIL decodes everything where the library cannot be built
    or loaded. ``decoder`` records which filled the cache: "native",
    "pil", or None where this process decoded no file (synthetic records,
    or pixels read back from disk, which ``reused`` says).

    For COCO-scale datasets the image array no longer fits in host RAM, so
    when its size exceeds `max_ram_bytes` the cache spills to a disk-backed
    `np.memmap` (`spill_dir`, default: alongside `cache_path` or a temp
    dir). `gather` fancy-indexing is unchanged: reads ride the OS page
    cache, and a completed spill file is reused across runs (annotations
    are cheap to rebuild; only pixels are memmapped).

    Processes may share a spill file. It is written under a name of the
    writer's own, then renamed onto its final name, then marked complete,
    so no process ever truncates a file another has mapped (a mapped inode
    survives the rename, on a shared filesystem too). Processes of one host
    take turns on a lock file, so the first decodes and the others reuse
    its file. Under a ``mesh`` the process with local rank 0 on each host
    decodes; the host's other ranks wait for it in a collective, then map
    the finished file read-only (a writer's error is raised on every rank),
    and without ``spill_dir`` they all use the writer's temporary directory.
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
        mesh: Optional[Mesh] = None,
    ):
        self.dataset = dataset
        self.image_size = image_size
        self.decoder: Optional[str] = None
        self.reused = False
        n = len(dataset)
        img_shape = (n, image_size, image_size, 3)
        self.boxes = np.zeros((n, max_boxes, 4), np.float32)
        self.labels = np.zeros((n, max_boxes), np.int32)
        self.valid = np.zeros((n, max_boxes), bool)

        self.memmap_path: Optional[str] = None
        spill = max_ram_bytes is not None and int(np.prod(img_shape)) > max_ram_bytes
        if not spill:
            if cache_path and os.path.exists(cache_path):
                blob = np.load(cache_path)
                self.images, self.boxes = blob["images"], blob["boxes"]
                self.labels, self.valid = blob["labels"], blob["valid"]
                self.reused = True
                return
            self.images = np.zeros(img_shape, np.uint8)
            self._fill(max_boxes, num_workers)
            if cache_path:
                np.savez(cache_path, images=self.images, boxes=self.boxes, labels=self.labels,
                         valid=self.valid)
            return

        writer = mesh is None or mesh.local_rank == 0
        if spill_dir is None:
            spill_dir = (os.path.dirname(os.path.abspath(cache_path)) if cache_path
                         else _host_spill_dir(mesh, writer))
        os.makedirs(spill_dir, exist_ok=True)
        # The filename pins the dataset's identity, not just (n, size):
        # splits of equal length sharing one spill_dir must not reuse
        # each other's pixels.
        ident = hashlib.md5(
            "\n".join([dataset.name] + [r.path or r.image_id for r in dataset.records]).encode()
        ).hexdigest()[:12]
        self.memmap_path = os.path.join(spill_dir, f"images_{ident}_{n}x{image_size}.npy")
        failure: Optional[BaseException] = None
        if writer:
            try:
                with _locked(self.memmap_path + ".lock"):
                    if not self._open_spill(img_shape):
                        self._write_spill(img_shape, max_boxes, num_workers)
            except BaseException as exc:
                if mesh is None:
                    raise
                failure = exc
        if mesh is not None:
            # Every rank reaches this all_reduce (a barrier) and learns
            # whether a writer failed: an error on every rank, not a hang.
            failed = mesh.all_reduce_(torch.tensor([float(failure is not None)],
                                                   device=mesh.device))
            if failure is not None:
                raise failure
            if failed.item():
                raise RuntimeError("a cache writer of the mesh failed (see its rank's error)")
            if not writer and not self._open_spill(img_shape):
                raise RuntimeError(f"the host's cache writer left no complete {self.memmap_path}")
        if self.reused:
            # Pixels are on disk already; only rebuild the (small) host-RAM
            # annotation arrays from the dataset records.
            for i, rec in enumerate(dataset.records):
                self.boxes[i], self.labels[i], self.valid[i] = pad_annotations(rec, max_boxes)

    def _open_spill(self, img_shape) -> bool:
        """Maps a completed spill file of this shape read-only; whether there was one."""
        path = self.memmap_path
        if not (os.path.exists(path) and os.path.exists(path + ".complete")):
            return False
        images = np.lib.format.open_memmap(path, mode="r")
        if images.shape != img_shape:
            return False
        self.images, self.reused = images, True
        return True

    def _write_spill(self, img_shape, max_boxes: int, num_workers: int) -> None:
        tmp = f"{self.memmap_path}.{socket.gethostname()}.{os.getpid()}.tmp"
        self.images = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8, shape=img_shape)
        try:
            self._fill(max_boxes, num_workers)
            self.images.flush()
            del self.images
            os.replace(tmp, self.memmap_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        with open(self.memmap_path + ".complete", "w") as f:
            f.write("ok\n")
        # Reopen read-only: training must never dirty cache pages.
        self.images = np.lib.format.open_memmap(self.memmap_path, mode="r")

    def _fill(self, max_boxes: int, num_workers: int) -> None:
        """Decodes or renders every record into ``self.images`` and pads its
        annotations: file-backed records through the native pool in chunks
        of 1024 (a bounded buffer, needed on the memmap path), then PIL for
        the files the pool rejected or for all of them without the pool."""
        records = self.dataset.records
        jpeg_idx = [i for i, r in enumerate(records) if r.path]
        done = set()
        if jpeg_idx:
            self.decoder = "native"
            for lo in range(0, len(jpeg_idx), DECODE_CHUNK):
                chunk = jpeg_idx[lo:lo + DECODE_CHUNK]
                decoded = native_decode.decode_batch(
                    [records[i].path for i in chunk], self.image_size,
                    num_threads=max(1, num_workers))
                if decoded is None:  # no library: PIL decodes everything
                    self.decoder = "pil"
                    break
                images, ok = decoded
                self.images[np.asarray(chunk)] = images
                for slot, i in enumerate(chunk):
                    if ok[slot]:
                        self.boxes[i], self.labels[i], self.valid[i] = pad_annotations(
                            records[i], max_boxes)
                        done.add(i)
            if self.decoder == "native" and len(done) < len(jpeg_idx):
                _LOG.warning("native JPEG decode failed for %d/%d files; re-decoding via PIL",
                             len(jpeg_idx) - len(done), len(jpeg_idx))

        def fill(i: int) -> None:
            rec = records[i]
            if rec.path:
                try:
                    self.images[i] = _decode_resize(rec.path, self.image_size)
                except Exception as exc:  # undecodable even by PIL
                    _LOG.warning("undecodable image %s (%s); using zeros", rec.path, exc)
            else:  # synthetic record: render procedurally
                from object_detector_tpu_torch.data.synthetic import render_synthetic_image

                self.images[i] = render_synthetic_image(rec, self.image_size)
            self.boxes[i], self.labels[i], self.valid[i] = pad_annotations(rec, max_boxes)

        todo = [i for i in range(len(records)) if i not in done]
        workers = max(1, num_workers)
        if workers == 1 or len(todo) < 8:
            for i in todo:
                fill(i)
        else:
            with futures.ThreadPoolExecutor(workers) as pool:
                list(pool.map(fill, todo))

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
