"""A closed loop of one caller serving batches, as ``evaluate_dataset``
drives the predict function: each batch of uint8 images goes from host
memory to the predict function, and its detections are read back to the
host before the next batch is sent. The batches are taken in turn from a
pool rendered from the seed.

Traffic keys: ``path`` ("int8": ``make_int8_predict_fn``; "float":
``make_predict_fn``), ``batch``, ``pool_batches``, ``max_objects``,
``checked_batches`` (served batches compared with the reference after the
window, drawn from the seed, with the last one).
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from port_bench import check, scenes, trace
from port_bench.drivers import common
from port_bench.reference import detector
from port_bench.weights import make_weights

@contextlib.contextmanager
def _patched(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    try:
        for obj, name, value in pairs:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _spanned(fn, name):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def _spans(capture: dict):
    """Spans around the engine's forward and the postprocess, and a capture
    of the NMS scan's rows and outputs while the profiler runs, installed
    before the predict function is built (it looks the forward up then)."""
    from object_detector_tpu_torch.eval import evaluator
    from object_detector_tpu_torch.kernels import nms
    from object_detector_tpu_torch.ops import postprocess
    from object_detector_tpu_torch.quant import engine

    def rows(coords, scores, **kw):
        out = nms.nms_rows(coords, scores, **kw)
        if capture["on"]:
            capture["calls"].append((out[0], scores.shape[0], scores.shape[1], kw["max_out"],
                                     coords.element_size()))
        return out

    return _patched([
        (engine, "int8_forward", _spanned(engine.int8_forward, "forward")),
        (engine, "retinanet_int8_forward", _spanned(engine.retinanet_int8_forward, "forward")),
        (evaluator, "postprocess", _spanned(evaluator.postprocess, "postprocess")),
        (postprocess, "decode_nms", functools.partial(postprocess.decode_nms, rows_fn=rows)),
    ])


def _program(r, weights, calibration):
    from object_detector_tpu_torch.anchors.priors import anchors_for_model
    from object_detector_tpu_torch.eval import evaluator
    from object_detector_tpu_torch.models.retinanet import build_model

    cfg = r.cfg
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    if r.traffic["path"] == "int8":
        return evaluator.make_int8_predict_fn(cfg, weights, anchors, calibration, device=r.device)
    model = build_model(cfg)
    model.load_state_dict(weights)
    if r.traced:
        model.forward = _spanned(model.forward, "forward")
    return evaluator.make_predict_fn(cfg, model, anchors, device=r.device)


def _control(r, weights, calibration):
    """The reference in the program's place, fake-quantized to 4 bits."""
    quant = detector.calibrate(weights, torch.as_tensor(calibration).to(r.device), r.arch, 4)

    def predict(images_u8):
        x = torch.as_tensor(images_u8).to(r.device)
        scores, boxes = common.reference_outputs(weights, x, r.arch, quant)
        return common.reference_detections(scores, boxes, r.arch)[:4]

    return predict


def run(r) -> dict:
    t, dev, cfg = r.traffic, r.device, r.cfg
    batch, size = t["batch"], cfg.model.image_size
    if batch != cfg.eval.batch_size:
        raise ValueError(f"traffic batch {batch} is not the configuration's eval.batch_size")
    mark = common.Phases(r)
    gen = common.generator(r.seed, "images", dev)
    rendered = [scenes.render(gen, batch, size, size, t["max_objects"])
                for _ in range(t["pool_batches"])]
    weights = make_weights(r.arch, r.config["weights"], r.seed, dev)
    pool = [x.cpu().numpy() for x in rendered]
    del rendered
    mark("inputs")

    capture = {"on": False, "calls": []}
    spans = _spans(capture) if r.traced and r.variant == "program" else contextlib.nullcontext()
    results = []
    with spans, contextlib.ExitStack() as profiling:
        build = _control if r.variant == "control" else _program
        predict = build(r, weights, pool[0])
        mark("build")
        for _ in range(2):  # every shape the window uses, twice
            for images in pool:
                [x.cpu().numpy() for x in predict(images)]
        common.synchronize(dev)
        if r.traced:
            trace.warm(dev)
        mark("warmup")

        prof = None
        n = 0
        t0 = time.perf_counter()
        trace_from = r.seconds - r.trace_seconds if r.traced else float("inf")
        r.host["setup_s"] = t0 - r.t_start
        r.host["seconds_untraced"] = r.seconds
        end_at = r.seconds
        while True:
            now = time.perf_counter() - t0
            if now >= end_at:
                break
            if prof is None and now >= trace_from:
                # The traced part: TRACE_SECONDS of work after the profiler is up.
                r.host["images_untraced"], r.host["seconds_untraced"] = n * batch, now
                prof = profiling.enter_context(trace.Profile())
                capture["on"] = True
                end_at = time.perf_counter() - t0 + r.trace_seconds
            i = n % len(pool)
            if prof is not None:
                prof.mark()
            with common.span(prof is not None, "batch"):
                det = predict(pool[i])
                with common.span(prof is not None, "readback"):
                    results.append((i, [x.cpu().numpy() for x in det]))
            n += 1
        window = time.perf_counter() - t0
        capture["on"] = False
        profiling.close()
        if prof is not None:
            r.trace = prof.trace
        r.host.setdefault("images_untraced", n * batch)
    r.host["batch"] = batch
    r.host["nms_calls"] = [((out > 0).sum(1).add(1).clamp(max=max_out).sum().item(),
                            rows, k, max_out, nbytes)
                           for out, rows, k, max_out, nbytes in capture["calls"]]
    peak = common.memory_peak(dev)
    del predict, capture
    common.free(dev)

    picked = common.sample(r.seed, len(results), t["checked_batches"], len(results) - 1)
    reference = {}
    gaps, nms = [], []
    for j in picked:
        i, out = results[j]
        if i not in reference:
            ref_scores, ref_boxes = common.reference_outputs(
                weights, torch.as_tensor(pool[i]).to(dev), r.arch)
            reference[i] = ref_scores, ref_boxes, common.reference_detections(
                ref_scores, ref_boxes, r.arch)
        ref_scores, ref_boxes, ref_det = reference[i]
        served = [torch.as_tensor(x).to(dev) for x in out]
        boxes, scores, classes, valid = served
        served_ref = torch.zeros(scores.shape, dtype=torch.float32, device=dev)
        for row in range(batch):
            keep = valid[row]
            gaps.append(check.image_gaps(boxes[row][keep], scores[row][keep],
                                         classes[row][keep], ref_scores[row], ref_boxes[row],
                                         cfg.eval.score_threshold))
            served_ref[row][keep] = gaps[-1]["ref_score"]
        nms.append(check.nms_gaps(served, served_ref, ref_det, ref_scores, r.arch["eval"]))
    return {"attempted": n * batch, "failed": 0, "memory_peak_bytes": peak,
            "numbers": check.worst(gaps, nms), "spread": check.spread(gaps, nms),
            "phases": mark("reference"),
            "served": {"detections_an_image":
                       float(np.mean([out[3].sum(1).mean() for _, out in results]))},
            "e2e": {"serve_img_per_s": n * batch / window, "setup_s": r.host["setup_s"]}}
