"""The entry layer's staged upload (`data/upload.py`): on the CPU its chunk
plan, which depends on the byte size alone, and its bypasses (the plain
``.to`` on the CPU, below `PAGEABLE_BELOW` bytes and for a batch already on
the card), which stage nothing and count nothing; on the card
(``cuda``-marked) the device batch byte for byte against
``torch.as_tensor(x).to(dev)`` at sizes about the chunk edges, single
images, each serving cell's batch and strided views, as served and with
every size staged, its counters, and back-to-back calls that overwrite
their sources at once while the card is still busy: each call keeps its
own bytes.

    python -m pytest tests/test_torch_upload.py --noconftest -q   # on the card
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from object_detector_tpu_torch.data import upload
from object_detector_tpu_torch.data.upload import StagedUpload, chunk_plan, stages
from object_detector_tpu_torch.utils import profiling

# (B, H, W, 3) uint8 batches of the serving cells, and single images.
CELL_BATCHES = {"ssd300_bs64": (64, 300, 300, 3), "retinanet_bs64": (64, 512, 512, 3),
                "detr_bs32": (32, 1088, 1088, 3)}
ONE_IMAGE = {"ssd300_bs1": (1, 300, 300, 3), "retinanet_bs1": (1, 512, 512, 3),
             "detr_bs1": (1, 1088, 1088, 3)}
# Byte sizes about the alignment's edge.
EDGES = (1, 2, 4095, 4096, 4097)


def _nbytes(shape):
    return int(np.prod(shape))


@pytest.mark.parametrize("nbytes", [
    *EDGES,
    upload.CHUNK_BYTES - 1, upload.CHUNK_BYTES, upload.CHUNK_BYTES + 1,
    2 * upload.CHUNK_BYTES - 1, 2 * upload.CHUNK_BYTES, 2 * upload.CHUNK_BYTES + 1,
    7 * upload.CHUNK_BYTES + 12345,
    *(_nbytes(s) for s in ONE_IMAGE.values()), *(_nbytes(s) for s in CELL_BATCHES.values()),
])
def test_the_chunk_plan_covers_the_bytes_in_near_equal_aligned_ranges(nbytes):
    chunk = upload.CHUNK_BYTES
    plan = chunk_plan(nbytes)
    assert plan == chunk_plan(nbytes, chunk)
    assert len(plan) == max(1, nbytes // chunk)
    assert plan[0][0] == 0 and plan[-1][1] == nbytes
    assert all(a == b for (_, a), (b, _) in zip(plan, plan[1:]))
    assert all(0 < end - start < 2 * chunk for start, end in plan)
    assert all(start % upload.ALIGN == 0 for start, _ in plan)
    if len(plan) > 1:
        lengths = [end - start for start, end in plan]
        assert max(lengths) - min(lengths) <= 2 * upload.ALIGN


def test_a_batch_smaller_than_two_chunks_is_one_copy_and_nothing_is_none():
    chunk = 64 * 1024
    assert chunk_plan(0, chunk) == []
    assert chunk_plan(1, chunk) == [(0, 1)]
    assert chunk_plan(2 * chunk - 1, chunk) == [(0, 2 * chunk - 1)]
    assert chunk_plan(2 * chunk, chunk) == [(0, chunk), (chunk, 2 * chunk)]
    # Inner bounds at a third and two thirds, rounded down to `ALIGN`.
    assert chunk_plan(3 * chunk + 5000, chunk) == [(0, chunk), (chunk, 2 * chunk),
                                                   (2 * chunk, 3 * chunk + 5000)]


@pytest.mark.parametrize("source, target, nbytes, staged", [
    ("cpu", "cuda", upload.PAGEABLE_BELOW, True), ("cpu", "cuda:0", 10**9, True),
    ("cpu", "cuda", upload.PAGEABLE_BELOW - 1, False), ("cpu", "cuda", 270000, False),
    ("cuda", "cuda", 10**9, False), ("cuda:0", "cuda:1", 10**9, False),
    ("cpu", "cpu", 10**9, False), ("cuda", "cpu", 10**9, False), ("meta", "cuda", 10**9, False),
])
def test_only_a_host_batch_of_some_megabytes_bound_for_a_card_is_staged(source, target, nbytes,
                                                                         staged):
    assert stages(torch.device(source), torch.device(target), nbytes) is staged


@pytest.mark.parametrize("view", ["contiguous", "strided"])
def test_on_the_cpu_the_plain_copy_stays_and_counts_nothing(view):
    x = np.random.default_rng(1).integers(0, 256, (4, 640, 640, 3), dtype=np.uint8)
    x = x[::2, :, 1:] if view == "strided" else x
    up = StagedUpload(torch.device("cpu"))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = up(x)
    counted = profiling.counters()
    profiling.reset_counters()
    assert torch.equal(got, torch.as_tensor(x))
    assert not counted.get(upload.STAGED_BYTES) and not counted.get(upload.CHUNKS)
    assert up._ring is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the staged upload pins host memory and "
                    "copies to the card")
    return torch.device("cuda")


def _traced(fn):
    """fn() under a profiler, and the upload's counters it added."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counted = profiling.counters()
    profiling.reset_counters()
    return out, counted.get(upload.STAGED_BYTES, 0), counted.get(upload.CHUNKS, 0)


SHAPES = {
    **ONE_IMAGE, **CELL_BATCHES,
    # Not a multiple of the chunk, nor of the alignment.
    "ragged_batch": (7, 333, 517, 3),
    "ragged_pipelined_batch": (37, 517, 611, 3),
    "one_chunk_less_a_byte": (upload.CHUNK_BYTES - 1,),
    "two_chunks_less_a_byte": (2 * upload.CHUNK_BYTES - 1,),
    "two_chunks": (2, upload.CHUNK_BYTES),
}


@pytest.mark.cuda
@pytest.mark.parametrize("every_size", [False, True], ids=["as_served", "every_size_staged"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_staged_batch_is_the_pageable_copy_byte_for_byte(card, monkeypatch, name,
                                                             every_size):
    if every_size:
        monkeypatch.setattr(upload, "PAGEABLE_BELOW", 0)
    x = np.random.default_rng(2).integers(0, 256, SHAPES[name], dtype=np.uint8)
    got, staged, chunks = _traced(lambda: StagedUpload(card)(x))
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got, torch.as_tensor(x).to(card))
    if x.nbytes >= upload.PAGEABLE_BELOW:
        assert staged == x.nbytes and chunks == len(chunk_plan(x.nbytes))
    else:
        assert staged == 0 and chunks == 0


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["numpy_slice", "tensor_slice", "int64_extents"])
def test_a_strided_or_wider_source_is_staged_from_its_exact_bytes(card, monkeypatch, source):
    monkeypatch.setattr(upload, "PAGEABLE_BELOW", 0)
    x = np.random.default_rng(3).integers(0, 256, (32, 280, 280, 3), dtype=np.uint8)
    x = {"numpy_slice": x[1::3, :, 7:],
         "tensor_slice": torch.from_numpy(x).permute(0, 2, 1, 3)[:, ::2],
         "int64_extents": np.tile(np.array([[800, 1066]], np.int64), (32, 1))}[source]
    got, staged, _ = _traced(lambda: StagedUpload(card)(x))
    want = torch.as_tensor(x).to(card)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    assert staged == want.numel() * want.element_size()


@pytest.mark.cuda
def test_back_to_back_calls_keep_their_own_bytes_while_the_card_is_busy(card, monkeypatch):
    """With the stream held by a long sleep, the ring's slots are reused
    within and across calls before any copy has run; each source is
    overwritten as soon as its call returns."""
    monkeypatch.setattr(upload, "CHUNK_BYTES", 64 * 1024)
    monkeypatch.setattr(upload, "SLOTS", 2)
    monkeypatch.setattr(upload, "PAGEABLE_BELOW", 0)
    up = StagedUpload(card)
    rng = np.random.default_rng(4)
    sources = [rng.integers(0, 256, (5, 128, 128, 3), dtype=np.uint8) for _ in range(4)]
    wants = [x.copy() for x in sources]
    torch.cuda._sleep(200_000_000)
    outs = []
    for x in sources:
        outs.append(up(x))
        x[...] = 255 - x
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_a_batch_on_the_card_skips_the_ring_and_counts_nothing(card):
    x = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, device=card)
    up = StagedUpload(card)
    got, staged, chunks = _traced(lambda: up(x))
    assert torch.equal(got, x) and staged == 0 and chunks == 0 and up._ring is None
