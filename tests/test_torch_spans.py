"""The program's own spans and counters (`utils.profiling.span`, `count`) on
the int8 serving path, on the CPU: nothing recorded without a profiler,
every span of the path and its nesting under one, one call of the epilogue
wrapper under each epilogue span and nothing beside it, the epilogue's byte
count and the one-kernel convs' operation and byte counts against the shapes
of the float path, the epilogue's against its fixed total, and the same
detections either way; for DETR its ``odt.detr.*`` spans, each operation of
its forward under one leaf, and its valid-token counter; for Deformable DETR
its ``odt.deformable.*`` spans and its two counters."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.convert import init_params
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.upload import StagedUpload
from object_detector_tpu_torch.eval.evaluator import PREDICT_CALLS, make_int8_predict_fn
from object_detector_tpu_torch.kernels import requant_epilogue
from object_detector_tpu_torch.models import detr
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.quant import engine
from object_detector_tpu_torch.utils import profiling

torch.set_num_threads(2)

CHILDREN = ("odt.int8.", "odt.kernel.")
# The spans of the kernel wrappers whose plain versions, on the CPU only, run
# engine steps inside them: the hand kernels' and the one-kernel 3x3 conv's.
WRAPPED = ("odt.kernel.", "odt.int8.conv")
# The spans one int8 predict of each family reaches on the CPU. The hand
# kernels' wrappers run their plain versions here: RetinaNet's pool is the
# ResNet stem's.
COMMON = {"odt.predict", "odt.upload", "odt.normalize", "odt.forward", "odt.int8.input",
          "odt.int8.im2col", "odt.int8.gemm", "odt.int8.epilogue", "odt.int8.conv",
          "odt.int8.pool", "odt.int8.concat", "odt.postprocess", "odt.kernel.nms"}
SPANS = {
    "ssd": COMMON | {"odt.kernel.stem_fp", "odt.kernel.l2norm"},
    "retinanet": COMMON | {"odt.kernel.resnet_stem", "odt.kernel.bottleneck"},
}
# Operations that only make a view, or return their input as it is.
VIEWS = {"aten::view", "aten::reshape", "aten::_reshape_alias", "aten::to"}
CONFIGS = {"ssd": config.tiny_test_config, "retinanet": config.tiny_retinanet_config}
# A range the traced call opens around each call of the epilogue wrapper.
EPILOGUE_CALL = "test.requant_epilogue"
# `EPILOGUE_BYTES` of one traced predict of two images, as the engine's
# eager epilogue chain counted it before the one-pass epilogue, less the 3x3
# stride-1 steps that the one-kernel conv took over (before it: 6179840 and
# 15790960): tiny_test (64 px; fc7 alone is left) and tiny_retinanet_config
# (128 px).
EPILOGUE_BYTES_OF_TWO = {"ssd": 163840, "retinanet": 14466112}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    """One family's int8 predict fn, called once to warm it, then once
    without a profiler (``plain``, ``counters_off``: the counters after it)
    and once under one (``traced``, ``events``, ``counters``), with each call
    of the epilogue wrapper inside an `EPILOGUE_CALL` range."""
    cfg = CONFIGS[request.param]()
    s = cfg.model.image_size
    params = init_params(build_model(cfg), seed=3, random_batch_stats=True).state_dict()
    rng = np.random.default_rng(4)
    calib = rng.integers(0, 256, (4, s, s, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, s)
    predict = make_int8_predict_fn(cfg, params, anchors, calib, use_pallas=True, device="cpu")
    predict(images)
    profiling.reset_counters()
    plain = predict(images)
    counters_off = profiling.counters()
    wrapper = requant_epilogue.epilogue

    def marked(*args, **kwargs):
        with torch.profiler.record_function(EPILOGUE_CALL):
            return wrapper(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(requant_epilogue, "epilogue", marked)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = predict(images)
    finally:
        mp.undo()
    counters = profiling.counters()
    profiling.reset_counters()
    return types.SimpleNamespace(
        family=request.param, cfg=cfg, params=params, predict=predict, plain=plain,
        counters_off=counters_off, traced=traced, events=list(prof.events()), counters=counters)


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def _inside(rng, ranges) -> int:
    """How many of ``ranges`` hold ``rng``."""
    return sum(a <= rng[0] and rng[1] <= b for a, b in ranges)


def test_a_span_is_the_shared_noop_without_a_profiler(served):
    assert served.counters_off == {}
    assert profiling.span("odt.a") is profiling.span("odt.b", args=3)
    with profiling.span("odt.a") as entered:
        assert entered is None
    profiling.count("odt.a", 5)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("odt.a") is not profiling.span("odt.a")
        profiling.count("odt.a", 5)
        profiling.count("odt.a", 2)
    assert profiling.counters() == {"odt.a": 7}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_a_tensor_count_is_read_with_the_counters():
    """A count made as an integer tensor (on the card: no host sync where it
    is made) adds up with the plain counts when the counters are read, and
    only while a profiler records."""
    profiling.count("odt.t", torch.tensor(4))
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("odt.t", torch.tensor(4))
        profiling.count("odt.t", 1)
        profiling.count("odt.u", torch.ones(3, dtype=torch.bool).sum())
    assert profiling.counters() == {"odt.t": 5, "odt.u": 3}
    assert profiling.counters() == {"odt.t": 5, "odt.u": 3}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("odt.t", torch.tensor(2))
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_a_traced_predict_emits_every_span_of_its_path_nested_once(served):
    family, events = served.family, served.events
    names = {e.name for e in events if e.name.startswith("odt.")}
    assert names == SPANS[family]
    assert served.counters[PREDICT_CALLS] == 1
    (predict_range,) = _ranges(events, "odt.predict")
    (forward_range,) = _ranges(events, "odt.forward")
    for name in names:
        ranges = _ranges(events, name)
        for rng in ranges:
            assert _inside(rng, [predict_range]), name
            assert _inside(rng, ranges) == 1, f"{name} nests inside itself"
    # Every operation of the forward that can move data lies under one engine
    # step, or under a kernel's wrapper (whose plain version runs engine steps
    # inside it on the CPU only). A reshape or a cast that copies does so in
    # an operation of its own, which is held here too.
    steps = {n: _ranges(events, n) for n in names if n.startswith(CHILDREN)}
    kernels = [r for n, rs in steps.items() if n.startswith(WRAPPED) for r in rs]
    engine_steps = [r for n, rs in steps.items() if n.startswith("odt.int8.") for r in rs]
    ops = [(e.name, (e.time_range.start, e.time_range.end)) for e in events
           if e.name.startswith("aten::") and e.name not in VIEWS]
    ops = [(op, rng) for op, rng in ops if _inside(rng, [forward_range])]
    assert len(ops) > 20
    for op, rng in ops:
        assert _inside(rng, kernels) or _inside(rng, engine_steps) == 1, op


def test_each_epilogue_span_holds_one_wrapper_call_and_nothing_beside_it(served):
    """On the card the wrapper is one kernel launch, so this is that launch
    alone under ``odt.int8.epilogue``. The hand kernels' plain versions,
    which run on the CPU only, call the epilogue's plain version under their
    ``odt.kernel.*`` spans and open no epilogue span of their own."""
    kernels = [r for e in served.events if e.name.startswith("odt.kernel.")
               for r in _ranges([e], e.name)]
    epilogues = [r for r in _ranges(served.events, "odt.int8.epilogue")
                 if not _inside(r, kernels)]
    calls = _ranges(served.events, EPILOGUE_CALL)
    assert len(epilogues) == len(calls) > 0
    assert all(_inside(rng, calls) == 0 for rng in epilogues)
    assert all(_inside(rng, epilogues) == 1 for rng in calls)
    assert all(sum(_inside(call, [rng]) for call in calls) == 1 for rng in epilogues)
    ops = [(e.name, (e.time_range.start, e.time_range.end)) for e in served.events
           if e.name.startswith("aten::")]
    for op, rng in ops:
        if _inside(rng, epilogues):
            assert _inside(rng, calls) == 1, op


def test_the_epilogue_byte_count_is_the_eager_chains_at_a_fixed_shape(served):
    assert served.plain.scores.shape[0] == 2
    assert served.counters[engine.EPILOGUE_BYTES] == EPILOGUE_BYTES_OF_TWO[served.family]


def _float_conv_sizes(family, cfg, params, predict, batch):
    """(path, output elements, input elements, kernel elements, output
    channels, routed) of every conv the float trunk, FPN and heads run on a
    batch of ``batch`` images, in order: the shapes of the int8 path's steps,
    found on another path. ``routed``: a 3x3 stride-1 conv over a multiple
    of 32 channels without a residual, a step of the one-kernel conv."""
    sizes = []
    conv = engine._conv_float

    def recording(x, weight, op):
        y = conv(x, weight, op)
        routed = (tuple(weight.shape[-2:]) == (3, 3) and op.stride == 1
                  and x.shape[-1] % 32 == 0 and op.add_register is None)
        sizes.append((op.path, y.numel(), x.numel(), weight.numel(), y.shape[-1], routed))
        return y

    s = cfg.model.image_size
    images = torch.zeros((batch, s, s, 3))
    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "_conv_float", recording)
    try:
        with torch.inference_mode():
            if family == "retinanet":
                folded = engine.fold_resnet50(params)
                taps, _ = engine.run_float(folded, predict.spec, images)
                engine.run_float_fpn_heads(folded, cfg, taps)
            else:
                taps, _ = engine.run_float(params, predict.spec, images)
                engine.apply_heads(params, taps, cfg)
    finally:
        mp.undo()
    return sizes


def test_the_epilogue_byte_count_is_the_least_bytes_of_the_shapes(served):
    """The accumulator read once (4 B), a residual (1 B) or an upsampled
    coarser level (4 B) read once, the output written once (codes 1 B,
    logits in their dtype, offsets 4 B), at every epilogue of the engine
    (those inside the hand kernels are theirs). A step of the one-kernel
    conv counts no epilogue bytes: its 2 M K N operations and its codes in,
    kernel and output, each moved once, go to the conv's two counters."""
    family, cfg = served.family, served.cfg
    sizes = _float_conv_sizes(family, cfg, served.params, served.predict,
                              served.plain.scores.shape[0])
    logit = (torch.bfloat16 if cfg.eval.int8_logits_bf16 else torch.float32).itemsize
    trunk = {op.path: op for op in served.predict.spec if isinstance(op, engine.ConvOp)}
    want = ops = moved = heads = 0
    for path, n, x_n, w_n, cout, routed in sizes:
        if path in trunk:
            out, read = 1, 4 + (trunk[path].add_register is not None)
        elif path == "head":  # SSD: cls, then box, of each level
            out, read = (logit if heads % 2 == 0 else 4), 4
            heads += 1
        elif path.startswith("fpn/") or "_head/" in path:
            out, read = 1, 4
            if path.endswith("/out"):
                out = logit if path.startswith("cls_head") else 4
        else:
            continue  # inside a hand kernel
        if routed:
            ops += 2 * n * (w_n // cout)
            moved += x_n + w_n + n * out
        else:
            want += n * (read + out)
    if family == "ssd":
        assert heads == 2 * len(cfg.anchors.feature_sizes)
    else:
        fpn = {path: n for path, n, *_ in sizes if path.startswith("fpn/")}
        want += 4 * (fpn["fpn/lateral5"] + fpn["fpn/lateral4"])  # the upsampled addends
        want += 2 * fpn["fpn/p6"]  # ReLU on P6's codes, in and out
    assert want > 0 and served.counters[engine.EPILOGUE_BYTES] == want
    assert ops > 0 and served.counters[engine.CONV_OPS] == ops
    assert served.counters[engine.CONV_BYTES] == moved


def test_detections_are_bit_identical_with_and_without_a_profiler(served):
    for got, want in zip(served.traced, served.plain):
        assert got.dtype == want.dtype and torch.equal(got, want)


# DETR (`models.detr`, `engine.detr_int8_forward`): the trunk's steps lie
# under ``odt.detr.backbone``, the attention cores under ``odt.detr.attention``
# inside the encoder or the decoder, and every operation of the forward under
# exactly one of its four stages.
DETR_STAGES = ("odt.detr.backbone", "odt.detr.encoder", "odt.detr.decoder", "odt.detr.heads")
DETR_SPANS = {"odt.predict", "odt.upload", "odt.normalize", "odt.forward", "odt.int8.input",
              "odt.int8.im2col", "odt.int8.gemm", "odt.int8.epilogue", "odt.int8.conv",
              "odt.int8.pool",
              "odt.kernel.resnet_stem", "odt.kernel.bottleneck", "odt.detr.attention",
              "odt.detr.postprocess", *DETR_STAGES}
# (h, w) of the two images of the traced call on the 128 px canvas.
DETR_EXTENTS = np.array([[96, 128], [40, 70]])


@pytest.fixture(scope="module")
def detr_served():
    from port_bench.detr_weights import make_weights

    cfg = config.tiny_detr_config()
    arch = {k: json.loads(json.dumps(dataclasses.asdict(getattr(cfg, k))))
            for k in ("model", "eval", "transformer")}
    weights = make_weights(arch, {"cls_gain": 3.0, "box_gain": 1.0, "bias_std": 0.1,
                                  "qk_gain": 2.0}, 5, "cpu")
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    predict = make_int8_predict_fn(cfg, weights, None, images, device="cpu",
                                   calibration_extents=DETR_EXTENTS)
    predict(images, DETR_EXTENTS)
    profiling.reset_counters()
    plain = predict(images, DETR_EXTENTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = predict(images, DETR_EXTENTS)
    counters = profiling.counters()
    profiling.reset_counters()
    return types.SimpleNamespace(plain=plain, traced=traced, events=list(prof.events()),
                                 counters=counters)


def test_a_traced_detr_predict_emits_its_spans_nested_as_stated(detr_served):
    events = detr_served.events
    names = {e.name for e in events if e.name.startswith("odt.")}
    assert names == DETR_SPANS
    (predict_range,) = _ranges(events, "odt.predict")
    (forward_range,) = _ranges(events, "odt.forward")
    stages = {n: _ranges(events, n) for n in DETR_STAGES}
    assert all(len(r) == 1 and _inside(r[0], [forward_range]) for r in stages.values())
    for name in names:
        for rng in _ranges(events, name):
            assert _inside(rng, [predict_range]), name
            assert _inside(rng, _ranges(events, name)) == 1, f"{name} nests inside itself"
            if name.startswith(CHILDREN):
                assert _inside(rng, stages["odt.detr.backbone"]), name
            if name == "odt.detr.attention":
                assert _inside(rng, stages["odt.detr.encoder"] + stages["odt.detr.decoder"])
    cfg = config.tiny_detr_config().transformer
    assert len(_ranges(events, "odt.detr.attention")) == cfg.enc_layers + 2 * cfg.dec_layers
    (post,) = _ranges(events, "odt.detr.postprocess")
    assert not _inside(post, [forward_range])


def test_every_detr_operation_lies_under_one_leaf(detr_served):
    """Every operation of the forward that can move data lies under exactly
    one of the four stages; in the backbone under one engine step, a hand
    kernel's wrapper, or the input projection's product (the stage's own);
    in the encoder and decoder under at most one attention core."""
    events = detr_served.events
    (forward_range,) = _ranges(events, "odt.forward")
    stages = [r for n in DETR_STAGES for r in _ranges(events, n)]
    backbone = _ranges(events, "odt.detr.backbone")
    attention = _ranges(events, "odt.detr.attention")
    kernels = [r for e in events if e.name.startswith(WRAPPED) for r in _ranges([e], e.name)]
    engine_steps = [r for e in events if e.name.startswith("odt.int8.")
                    for r in _ranges([e], e.name)]
    ops = [(e.name, (e.time_range.start, e.time_range.end)) for e in events
           if e.name.startswith("aten::") and e.name not in VIEWS]
    ops = [(op, rng) for op, rng in ops if _inside(rng, [forward_range])]
    assert len(ops) > 50
    in_proj = 0
    for op, rng in ops:
        assert _inside(rng, stages) == 1, op
        assert _inside(rng, attention) <= 1, op
        if _inside(rng, backbone) and not _inside(rng, kernels):
            steps = _inside(rng, engine_steps)
            in_proj += steps == 0
            assert steps <= 1, op
    assert in_proj > 0  # the projection of C5 into d_model, in the backbone's own range


def test_the_valid_token_counter_is_the_extents_token_count(detr_served):
    # A C5 cell samples the 128 px canvas at 16 i: 96 rows keep 6 of 8 and
    # 128 columns 8; 40 rows keep 3, 70 columns 5.
    assert detr_served.counters[detr.VALID_TOKENS] == 6 * 8 + 3 * 5
    assert detr_served.counters[PREDICT_CALLS] == 1


def test_detr_detections_are_bit_identical_with_and_without_a_profiler(detr_served):
    for got, want in zip(detr_served.traced, detr_served.plain):
        assert got.dtype == want.dtype and torch.equal(got, want)


# Deformable DETR (`models.deformable_detr`, `engine.deformable_detr_int8_forward`):
# the trunk's steps and the levels lie under ``odt.deformable.backbone``, each
# launch of the sampling core under ``odt.deformable.sampling`` inside the
# encoder or the decoder, the decoder's self-attention under DETR's
# ``odt.detr.attention``.
DEFORMABLE_STAGES = ("odt.deformable.backbone", "odt.deformable.encoder",
                     "odt.deformable.decoder", "odt.deformable.heads")
DEFORMABLE_SPANS = {"odt.predict", "odt.upload", "odt.normalize", "odt.forward",
                    "odt.int8.input", "odt.int8.im2col", "odt.int8.gemm", "odt.int8.epilogue",
                    "odt.int8.conv", "odt.int8.pool", "odt.kernel.resnet_stem",
                    "odt.kernel.bottleneck", "odt.deformable.sampling", "odt.detr.attention",
                    "odt.deformable.postprocess", *DEFORMABLE_STAGES}


@pytest.fixture(scope="module")
def deformable_served():
    from port_bench.deformable_weights import make_weights

    cfg = config.tiny_deformable_detr_config()
    arch = {k: json.loads(json.dumps(dataclasses.asdict(getattr(cfg, k))))
            for k in ("model", "eval", "deformable")}
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "port_bench", "configs", "deformable_detr_r50_coco.json")) as f:
        weights = make_weights(arch, json.load(f)["weights"], 5, "cpu")
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    predict = make_int8_predict_fn(cfg, weights, None, images, device="cpu",
                                   calibration_extents=DETR_EXTENTS)
    predict(images, DETR_EXTENTS)
    profiling.reset_counters()
    plain = predict(images, DETR_EXTENTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = predict(images, DETR_EXTENTS)
    counters = profiling.counters()
    profiling.reset_counters()
    return types.SimpleNamespace(cfg=cfg, plain=plain, traced=traced,
                                 events=list(prof.events()), counters=counters)


def test_a_traced_deformable_predict_emits_its_spans_nested_as_stated(deformable_served):
    events = deformable_served.events
    names = {e.name for e in events if e.name.startswith("odt.")}
    assert names == DEFORMABLE_SPANS
    (predict_range,) = _ranges(events, "odt.predict")
    (forward_range,) = _ranges(events, "odt.forward")
    stages = {n: _ranges(events, n) for n in DEFORMABLE_STAGES}
    assert all(len(r) == 1 and _inside(r[0], [forward_range]) for r in stages.values())
    for name in names:
        for rng in _ranges(events, name):
            assert _inside(rng, [predict_range]), name
            assert _inside(rng, _ranges(events, name)) == 1, f"{name} nests inside itself"
            if name.startswith(CHILDREN):
                assert _inside(rng, stages["odt.deformable.backbone"]), name
    c = deformable_served.cfg.deformable
    sampling = _ranges(events, "odt.deformable.sampling")
    assert len(sampling) == c.enc_layers + c.dec_layers
    assert sum(_inside(r, stages["odt.deformable.encoder"]) for r in sampling) == c.enc_layers
    assert sum(_inside(r, stages["odt.deformable.decoder"]) for r in sampling) == c.dec_layers
    (post,) = _ranges(events, "odt.deformable.postprocess")
    assert not _inside(post, [forward_range])


def test_the_deformable_counters_are_the_extents_tokens_and_the_sampled_points(
        deformable_served):
    from object_detector_tpu_torch.kernels import msda
    from object_detector_tpu_torch.models import deformable_detr

    # Levels of 16, 8, 4, 2 cells a side, a cell every 8, 16, 32, 64 px:
    # 96 x 128 keeps 12 x 16, 6 x 8, 3 x 4, 2 x 2; 40 x 70 keeps 5 x 9,
    # 3 x 5, 2 x 3, 1 x 2.
    assert deformable_served.counters[deformable_detr.VALID_TOKENS] == (
        192 + 48 + 12 + 4) + (45 + 15 + 6 + 2)
    c = deformable_served.cfg.deformable
    rows = 2 * (c.enc_layers * (256 + 64 + 16 + 4) + c.dec_layers * c.queries)
    assert deformable_served.counters[msda.SAMPLED_POINTS] == rows * c.heads * 4 * 4
    assert deformable_served.counters[PREDICT_CALLS] == 1


def test_deformable_detections_are_bit_identical_with_and_without_a_profiler(
        deformable_served):
    for got, want in zip(deformable_served.traced, deformable_served.plain):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("family", ["detr", "deformable_detr"])
def test_a_padded_predict_uploads_canvases_and_extents_in_one_span(family, request):
    """One ``odt.upload`` range a call, which holds both uploads (on the CPU
    each is the plain ``.to``): the canvases', then the extents'."""
    served = request.getfixturevalue(
        {"detr": "detr_served", "deformable_detr": "deformable_served"}[family])
    events = served.events
    (upload_range,) = _ranges(events, "odt.upload")
    (predict_range,) = _ranges(events, "odt.predict")
    assert _inside(upload_range, [predict_range])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        StagedUpload(torch.device("cpu"))(np.zeros(3, np.uint8))
    one_upload = sum(e.name == "aten::to" for e in prof.events())
    copies = [rng for rng in _ranges(events, "aten::to") if _inside(rng, [upload_range])]
    assert one_upload and len(copies) == 2 * one_upload
    assert served.counters[PREDICT_CALLS] == 1
