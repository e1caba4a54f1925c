"""The closed loop of ``padded_batch`` for Deformable DETR: one caller
serving padded batches of uint8 canvases with their (B, 2) extents (h, w)
through predict(images, extents), each batch's detections read back before
the next is sent; the pool rendered from the seed by
`padded_batch.render_pool`. After the window the served detections of the
checked batches are held against the reference (`reference.deformable_
detr`, in blocks) by `port_bench.deformable_check`, beside the detections of
the check's yardstick (`reference.deformable_detr.yardstick`) on the same
canvases.

The program is ``make_int8_predict_fn``'s. Traffic keys are
``padded_batch``'s, and ``control``, the correctness control ``--variant
control`` runs: "trunk_int4" (the default: the reference with its trunk
fake-quantized to 4 bits), "transformer_fp8" (its trunk to 8 bits, every
product of its transformer on float8 e4m3 inputs) or "sampling_nearest"
(the yardstick, the configuration's precision: its trunk to 8 bits and
every product of its transformer on bfloat16 inputs, with each bilinear
sample replaced by its nearest cell, so that it differs from a sound
program by the sampling's arithmetic alone).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import deformable_check, trace
from port_bench.deformable_weights import make_weights
from port_bench.drivers import common
from port_bench.drivers.padded_batch import render_pool
from port_bench.reference import deformable_detr

# Images a block of the reference's forward holds: its float32 levels and
# sampling over 24,565 tokens take about 2 GB an image.
REFERENCE_BLOCK = 4
# Control -> (trunk bits, the transformer's product inputs, nearest sampling).
CONTROLS = {"trunk_int4": (4, None, False), "transformer_fp8": (8, torch.float8_e4m3fn, False),
            "sampling_nearest": (8, torch.bfloat16, True)}


def _program(r, weights, calibration):
    from object_detector_tpu_torch.eval import evaluator

    return evaluator.make_int8_predict_fn(r.cfg, weights, None, calibration[0], device=r.device,
                                          calibration_extents=calibration[1])


def reference_outputs(weights, images_u8: torch.Tensor, extents: torch.Tensor, arch, quant=None):
    """The reference's (B, Q, C) logits and (B, Q, 4) boxes, in blocks."""
    parts = [deformable_detr.outputs(weights, images_u8[i:i + REFERENCE_BLOCK],
                                     extents[i:i + REFERENCE_BLOCK], arch, quant)
             for i in range(0, images_u8.shape[0], REFERENCE_BLOCK)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _served(logits, boxes, extents, top_k):
    """The reference's top ``top_k`` as a predict function serves them."""
    boxes, scores, labels, _ = deformable_detr.postprocess(logits, boxes, extents, top_k)
    return boxes, scores, labels.to(torch.int32), torch.ones_like(scores, dtype=torch.bool)


def _control(r, weights, calibration):
    """The reference in the program's place, as the traffic's ``control``
    says."""
    bits, products, nearest = CONTROLS[r.traffic.get("control", "trunk_int4")]
    images, extents = (torch.as_tensor(x).to(r.device) for x in calibration)
    quant = deformable_detr.calibrate(weights, images, extents, r.arch, bits, products, nearest)
    top_k = r.arch["deformable"]["top_k"]

    def predict(images_u8, extents_hw):
        x = torch.as_tensor(images_u8).to(r.device)
        ext = torch.as_tensor(extents_hw).to(r.device)
        return _served(*reference_outputs(weights, x, ext, r.arch, quant), ext, top_k)

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

    top_k = r.arch["deformable"]["top_k"]
    picked = common.sample(r.seed, len(results), t["checked_batches"], len(results) - 1)
    yard_quant = deformable_detr.yardstick(weights, torch.as_tensor(pool[0]).to(dev),
                                           torch.as_tensor(pool_extents[0]).to(dev), r.arch)
    reference, yardstick = {}, {}
    gaps, yard_gaps = [], []
    for j in picked:
        i, out = results[j]
        extents = torch.as_tensor(pool_extents[i]).to(dev)
        if i not in reference:
            images = torch.as_tensor(pool[i]).to(dev)
            reference[i] = reference_outputs(weights, images, extents, r.arch)
            yardstick[i] = _served(*reference_outputs(weights, images, extents, r.arch,
                                                      yard_quant), extents, top_k)
        served = [torch.as_tensor(x).to(dev) for x in out]
        gaps.append(deformable_check.image_gaps(served, *reference[i], extents, top_k))
        yard_gaps.append(deformable_check.image_gaps(yardstick[i], *reference[i], extents, top_k))
    scores = np.concatenate([out[1].ravel() for _, out in results])
    return {"attempted": n * batch, "failed": 0, "memory_peak_bytes": peak,
            "numbers": deformable_check.worst(gaps, yard_gaps),
            "spread": deformable_check.spread(gaps),
            "phases": mark("reference"),
            "served": {"score_quantiles": [float(x) for x in
                                           np.quantile(scores, [0.05, 0.5, 0.95])]},
            "e2e": {"serve_img_per_s": n * batch / window, "setup_s": r.host["setup_s"]}}
