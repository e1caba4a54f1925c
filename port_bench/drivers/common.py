"""What the drivers share: seeded sampling, spans, the device's peak memory,
freeing the program's state, and the reference's scores in blocks."""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from port_bench.reference import detector
from port_bench.weights import derive

# Images a block of the reference's forward holds, and of its NMS.
REFERENCE_BLOCK = 16
DETECT_BLOCK = 8


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def span(active: bool, name: str):
    return torch.profiler.record_function(name) if active else contextlib.nullcontext()


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_outputs(weights, images_u8: torch.Tensor, arch, quant=None):
    """The reference's (B, A, C) scores and (B, A, 4) boxes, in blocks."""
    scores, boxes = [], []
    for i in range(0, images_u8.shape[0], REFERENCE_BLOCK):
        s, b = detector.scores_and_boxes(weights, images_u8[i:i + REFERENCE_BLOCK], arch, quant)
        scores.append(s)
        boxes.append(b)
    return torch.cat(scores), torch.cat(boxes)


def reference_detections(scores, boxes, arch):
    """The reference's `detect` of (B, A, C) scores and (B, A, 4) boxes,
    with each detection's anchor, in blocks."""
    parts = [detector.detect(scores[i:i + DETECT_BLOCK], boxes[i:i + DETECT_BLOCK], arch,
                             with_anchors=True)
             for i in range(0, scores.shape[0], DETECT_BLOCK)]
    return tuple(torch.cat(p) for p in zip(*parts))


class Phases:
    """Seconds since the run's start at each named mark, for the earlier
    lines of a run's output."""

    def __init__(self, r):
        self.t_start = r.t_start
        self.marks = {}

    def __call__(self, name: str) -> dict:
        import time

        self.marks[name] = time.perf_counter() - self.t_start
        return self.marks


def sample(seed: int, n: int, k: int, always: int) -> list:
    """``k`` of ``n`` indices drawn from the seed, and ``always``."""
    picked = rng(seed, "sample").choice(n, size=min(k, n), replace=False).tolist()
    return sorted(set(picked) | {always})
