"""A closed loop of one caller serving padded batches, as ``closed_batch``
drives the predict function, for a model that takes each image's extent:
each batch of uint8 canvases goes from host memory to predict(images,
extents) with its (B, 2) extents (h, w), and its detections are read back
to the host before the next batch is sent. The batches are taken in turn
from a pool rendered from the seed: each image's extent drawn from the
traffic's, a scene rendered inside it at the canvas's top left, the rest of
the canvas seeded noise (which a correct program zeroes).

The program is ``make_int8_predict_fn``'s. Traffic keys: ``batch``,
``canvas``, ``extents`` ((h, w) pairs) with ``extent_weights`` (their
probabilities), ``pool_batches``,
``max_objects``, ``checked_batches`` (served batches compared with the
reference after the window, drawn from the seed, with the last one), and
``control``, the correctness control ``--variant control`` runs:
"trunk_int4" (the default: the reference with its trunk fake-quantized to
4 bits) or "transformer_fp8" (its trunk to 8 bits, every product of its
transformer on float8 e4m3 inputs).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import detr_check, scenes, trace
from port_bench.detr_weights import make_weights
from port_bench.drivers import common
from port_bench.reference import detr

# Images a block of the reference's forward holds: its float32 attention
# over 4,624 tokens takes about 2 GB an image.
REFERENCE_BLOCK = 4
CONTROLS = {"trunk_int4": (4, False), "transformer_fp8": (8, True)}


def render_pool(r, dev):
    """``pool_batches`` batches of (B, canvas, canvas, 3) uint8 canvases on
    the host and their (B, 2) int64 extents, from the seed."""
    t = r.traffic
    batch, canvas = t["batch"], t["canvas"]
    shapes = np.asarray(t["extents"], dtype=np.int64)
    draw = common.rng(r.seed, "extents").choice(
        len(shapes), size=(t["pool_batches"], batch), p=np.asarray(t["extent_weights"]))
    gen = common.generator(r.seed, "images", dev)
    pool, extents = [], []
    for picks in draw:
        images = torch.randint(0, 256, (batch, canvas, canvas, 3), generator=gen, device=dev,
                               dtype=torch.uint8)
        for k, (h, w) in enumerate(shapes):
            rows = np.flatnonzero(picks == k)
            if len(rows):
                images[torch.as_tensor(rows, device=dev), :h, :w] = scenes.render(
                    gen, len(rows), int(h), int(w), t["max_objects"])
        pool.append(images.cpu().numpy())
        extents.append(shapes[picks])
    return pool, extents


def _program(r, weights, calibration):
    from object_detector_tpu_torch.eval import evaluator

    return evaluator.make_int8_predict_fn(r.cfg, weights, None, calibration[0], device=r.device,
                                          calibration_extents=calibration[1])


def reference_outputs(weights, images_u8: torch.Tensor, extents: torch.Tensor, arch, quant=None):
    """The reference's (B, Q, C + 1) logits and (B, Q, 4) boxes, in blocks."""
    parts = [detr.outputs(weights, images_u8[i:i + REFERENCE_BLOCK],
                          extents[i:i + REFERENCE_BLOCK], arch, quant)
             for i in range(0, images_u8.shape[0], REFERENCE_BLOCK)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _control(r, weights, calibration):
    """The reference in the program's place, as the traffic's ``control``
    says."""
    bits, fp8 = CONTROLS[r.traffic.get("control", "trunk_int4")]
    images, extents = (torch.as_tensor(x).to(r.device) for x in calibration)
    quant = detr.calibrate(weights, images, extents, r.arch, bits, fp8)

    def predict(images_u8, extents_hw):
        x = torch.as_tensor(images_u8).to(r.device)
        ext = torch.as_tensor(extents_hw).to(r.device)
        boxes, scores, labels = detr.postprocess(*reference_outputs(weights, x, ext, r.arch,
                                                                    quant), ext)
        return boxes, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool)

    return predict


def run(r) -> dict:
    t, dev, cfg = r.traffic, r.device, r.cfg
    batch = t["batch"]
    if batch != cfg.eval.batch_size or t["canvas"] != cfg.model.image_size:
        raise ValueError("traffic batch and canvas are not the configuration's eval.batch_size "
                         "and model.image_size")
    mark = common.Phases(r)
    pool, pool_extents = render_pool(r, dev)
    weights = make_weights(r.arch, r.config["weights"], r.seed, dev)
    mark("inputs")

    results = []
    with contextlib.ExitStack() as profiling:
        build = _control if r.variant == "control" else _program
        predict = build(r, weights, (pool[0], pool_extents[0]))
        mark("build")
        for _ in range(2):  # every shape the window uses, twice
            for images, extents in zip(pool, pool_extents):
                [x.cpu().numpy() for x in predict(images, extents)]
        common.synchronize(dev)
        if r.traced:
            trace.warm(dev)
        mark("warmup")

        prof = None
        n = 0
        t0 = time.perf_counter()
        trace_from = r.seconds - r.trace_seconds if r.traced else float("inf")
        r.host["setup_s"] = t0 - r.t_start
        r.host["batch"] = batch
        r.host["seconds_untraced"] = r.seconds
        untraced = None
        end_at = r.seconds
        while True:
            now = time.perf_counter() - t0
            if now >= end_at:
                break
            if prof is None and now >= trace_from:
                # The traced part: TRACE_SECONDS of work after the profiler is up.
                untraced, r.host["seconds_untraced"] = n, now
                prof = profiling.enter_context(trace.Profile())
                end_at = time.perf_counter() - t0 + r.trace_seconds
            i = n % len(pool)
            if prof is not None:
                prof.mark()
            with common.span(prof is not None, "batch"):
                det = predict(pool[i], pool_extents[i])
                with common.span(prof is not None, "readback"):
                    results.append((i, [x.cpu().numpy() for x in det]))
            n += 1
        window = time.perf_counter() - t0
        profiling.close()
        if prof is not None:
            r.trace = prof.trace
    r.host["images_untraced"] = (n if untraced is None else untraced) * batch
    peak = common.memory_peak(dev)
    del predict
    common.free(dev)

    picked = common.sample(r.seed, len(results), t["checked_batches"], len(results) - 1)
    reference = {}
    gaps = []
    for j in picked:
        i, out = results[j]
        extents = torch.as_tensor(pool_extents[i]).to(dev)
        if i not in reference:
            reference[i] = reference_outputs(weights, torch.as_tensor(pool[i]).to(dev), extents,
                                             r.arch)
        served = [torch.as_tensor(x).to(dev) for x in out]
        gaps.append(detr_check.image_gaps(served, *reference[i], extents))
    scores = np.concatenate([out[1].ravel() for _, out in results])
    return {"attempted": n * batch, "failed": 0, "memory_peak_bytes": peak,
            "numbers": detr_check.worst(gaps), "spread": detr_check.spread(gaps),
            "phases": mark("reference"),
            "served": {"score_quantiles": [float(x) for x in
                                           np.quantile(scores, [0.05, 0.5, 0.95])]},
            "e2e": {"serve_img_per_s": n * batch / window, "setup_s": r.host["setup_s"]}}
