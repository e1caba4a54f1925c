"""The decoded cache spilled to disk and shared by processes.

Processes that build one dataset's cache with the same ``spill_dir`` must
all survive with the same pixels: none may truncate a spill file another
has mapped (which kills that process with SIGBUS). On one host they take
turns, so one process decodes and the others map its file; under a mesh
the rank with local rank 0 decodes, and without a ``spill_dir`` the ranks
share their writer's temporary directory."""

import hashlib
import json
import multiprocessing
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.parallel import mesh as mesh_lib
from object_detector_tpu_torch.train.loop import train

NUM_IMAGES, SIZE = 300, 128


def _digest(images) -> str:
    return hashlib.sha256(np.ascontiguousarray(images).tobytes()).hexdigest()


def _lone_digest() -> str:
    return _digest(DecodedCache(make_synthetic_dataset(num_images=NUM_IMAGES, image_size=SIZE),
                                SIZE, 100, 1).images)


def _build_in_process(spill_dir: str, out: str, barrier) -> None:
    torch.set_num_threads(1)
    ds = make_synthetic_dataset(num_images=NUM_IMAGES, image_size=SIZE)
    barrier.wait(timeout=120)
    cache = DecodedCache(ds, SIZE, 100, 1, max_ram_bytes=0, spill_dir=spill_dir)
    with open(out, "w") as f:  # getattr: a cache without the flag still reports its pixels
        json.dump({"reused": getattr(cache, "reused", None), "digest": _digest(cache.images),
                   "path": cache.memmap_path}, f)


def test_processes_sharing_a_spill_dir_survive_and_one_decodes(tmp_path):
    """Four processes, started together on one spill_dir: every one exits
    0, each sees the lone process's pixels, exactly one decoded, and no
    temporary file is left behind."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(4)
    spill = str(tmp_path / "spill")
    procs = [ctx.Process(target=_build_in_process, args=(spill, str(tmp_path / f"p{i}.json"),
                                                         barrier)) for i in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert [p.exitcode for p in procs] == [0, 0, 0, 0]
    reports = [json.load(open(tmp_path / f"p{i}.json")) for i in range(4)]
    assert [r["digest"] for r in reports] == [_lone_digest()] * 4
    assert [r["reused"] for r in reports].count(False) == 1
    assert [r["reused"] for r in reports].count(True) == 3
    assert len({r["path"] for r in reports}) == 1
    assert not [n for n in os.listdir(spill) if n.endswith(".tmp")]


def _build_under_mesh(spill_dir):
    mesh = mesh_lib.make_mesh(2, "cpu")
    torch.set_num_threads(1)
    ds = make_synthetic_dataset(num_images=NUM_IMAGES, image_size=SIZE)
    cache = DecodedCache(ds, SIZE, 100, 2, max_ram_bytes=0, spill_dir=spill_dir, mesh=mesh)
    mine = {"local_rank": mesh.local_rank, "reused": cache.reused, "path": cache.memmap_path,
            "digest": _digest(cache.images), "boxes": _digest(cache.boxes)}
    rows = [None] * mesh.world
    dist.all_gather_object(rows, mine, group=mesh.group)
    return rows


@pytest.mark.parametrize("given", [True, False])
def test_under_a_mesh_local_rank_0_decodes(tmp_path, given):
    """Two gloo ranks: rank 0 (local rank 0) decodes, rank 1 maps its file,
    with the same pixels and annotations as a lone process; without a
    spill_dir both use the writer's temporary directory."""
    spill = str(tmp_path / "spill") if given else None
    ranks = mesh_lib.spawn(2, "cpu", _build_under_mesh, (spill,))
    lone = DecodedCache(make_synthetic_dataset(num_images=NUM_IMAGES, image_size=SIZE),
                        SIZE, 100, 1)
    assert [(r["local_rank"], r["reused"]) for r in ranks] == [(0, False), (1, True)]
    assert {r["digest"] for r in ranks} == {_digest(lone.images)}
    assert {r["boxes"] for r in ranks} == {_digest(lone.boxes)}
    assert len({r["path"] for r in ranks}) == 1
    if given:
        assert os.path.dirname(ranks[0]["path"]) == spill


def _writer_fails_under_mesh(spill_dir):
    """Rank 0's decode raises; returns each rank's error (type, text)."""
    mesh = mesh_lib.make_mesh(2, "cpu")
    if mesh.local_rank == 0:
        def full_disk(*args):
            raise OSError("No space left on device")
        DecodedCache._fill = full_disk
    ds = make_synthetic_dataset(num_images=8, image_size=SIZE)
    try:
        DecodedCache(ds, SIZE, 100, 1, max_ram_bytes=0, spill_dir=spill_dir, mesh=mesh)
        mine = None
    except BaseException as exc:
        mine = (type(exc).__name__, str(exc))
    rows = [None] * mesh.world
    dist.all_gather_object(rows, mine, group=mesh.group)
    return rows


def test_under_a_mesh_a_failed_writer_raises_on_every_rank(tmp_path):
    """The writer's decode fails: it raises its own error, the host's other
    rank raises that a writer failed instead of waiting for it for ever,
    and no spill file or temporary file is left."""
    spill = tmp_path / "spill"
    ranks = mesh_lib.spawn(2, "cpu", _writer_fails_under_mesh, (str(spill),))
    assert ranks[0] == ("OSError", "No space left on device")
    assert ranks[1][0] == "RuntimeError" and "writer of the mesh failed" in ranks[1][1]
    assert not [n for n in os.listdir(spill) if n.endswith((".npy", ".tmp", ".complete"))]


def test_data_parallel_training_shares_one_spilled_cache(tmp_path, monkeypatch):
    """train() at mesh.data_parallel=2 with a spill directory and no RAM for
    the cache: both ranks train on one spill file that one of them wrote."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spill = tmp_path / "spill"
    cfg = config.get_config("tiny_test").override({
        "mesh.data_parallel": 2, "train.batch_size": 4, "data.num_workers": 1,
        "data.max_cache_ram_gb": 0.0, "data.cache_spill_dir": str(spill)})
    state = train(cfg, make_synthetic_dataset(num_images=8, image_size=64), num_steps=1,
                  checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    assert state.step == 1
    names = sorted(os.listdir(spill))
    assert len([n for n in names if n.endswith(".npy")]) == 1
    assert not [n for n in names if n.endswith(".tmp")]
    assert [n for n in names if n.endswith(".complete")]
    shutil.rmtree(tmp_path / "ck")  # a 160 MB checkpoint
