"""The port's int8 engine on an SSD/ResNet-50 against the reference's, on the
small config of test_torch_resnet.py: op lists for every knob, scale keys,
weight quantization, calibration, tap codes at every tap, the two kernel ops
against the unfused chain, and the slice as a whole (`make_int8_predict_fn`,
`Predictor(int8=True)`, ``predict --int8``)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.cli.predictor import Predictor as RefPredictor
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.anchors.priors import ssd_anchors
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import quant_params_from_jax, variables_from_jax
from object_detector_tpu_torch.eval.evaluator import make_int8_predict_fn, make_predict_fn
from object_detector_tpu_torch.kernels import bottleneck, resnet_stem
from object_detector_tpu_torch.models.ssd import SSDModel
from object_detector_tpu_torch.quant import engine
from test_torch_resnet import SIZE, small_configs, small_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("ODT_STEM_KERNEL", "ODT_FUSED_BOTTLENECK", "ODT_IMG_PACK")


def _with_env(fn, **env):
    """fn() with the three knobs set as given (unset where not given)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in KNOBS:
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        return fn()


def _unfused_spec(cfg):
    return _with_env(lambda: engine.build_resnet_ssd_spec(cfg, fused_bottleneck=False),
                     ODT_STEM_KERNEL="0")


@pytest.fixture(scope="module")
def quant():
    """The reference's QuantParams of the small model on a seeded calibration
    batch, and its eager int8 tap codes on that batch."""
    ref_cfg, cfg = small_configs()
    variables = small_variables(ref_cfg, seed=5)
    state = variables_from_jax(variables)
    x = np.random.default_rng(6).uniform(-2.0, 2.0, (2, SIZE, SIZE, 3)).astype(np.float32)
    folded = ref_engine.fold_resnet50(variables["params"], variables["batch_stats"])
    ref_spec = _with_env(lambda: ref_engine.build_spec(ref_cfg))
    scales = ref_engine.calibrate_scales(folded, ref_spec, [jnp.asarray(x)], use_l2norm=False)
    ref_qp = ref_engine.quantize_params(folded, ref_spec, scales)
    # Op by op, as the reference's own tests run it: its requant divides.
    ref_taps = ref_engine.run_int8(ref_qp, ref_spec, jnp.asarray(x), dequantize_taps=False)
    ref_taps = [(np.asarray(q), s) for q, s in ref_taps]
    return dict(ref_cfg=ref_cfg, cfg=cfg, variables=variables, state=state, x=x,
                ref_spec=ref_spec, ref_qp=ref_qp, ref_taps=ref_taps)


def _same_op(port_op, ref_op):
    """Same class name and the same value in every field the port has. The
    reference's ``img_pack`` must be off; its ``algo`` is a layout choice the
    port computes in the direct form."""
    assert type(port_op).__name__ == type(ref_op).__name__
    port_fields = dataclasses.asdict(port_op)
    for field in dataclasses.fields(ref_op):
        value = getattr(ref_op, field.name)
        if field.name in port_fields:
            assert port_fields[field.name] == value, (port_op, ref_op)
        elif field.name != "algo":
            assert value == field.default, (field.name, ref_op)


@pytest.mark.parametrize("stem_algo", ["direct", "s2d"])
@pytest.mark.parametrize("fused_bottleneck", [False, True])
@pytest.mark.parametrize("stem_kernel", ["0", "1"])
def test_trunk_spec_matches_reference(stem_kernel, fused_bottleneck, stem_algo):
    build = lambda mod: mod.build_resnet_trunk_spec(  # noqa: E731
        stem_algo=stem_algo, fused_bottleneck=fused_bottleneck, img_pack=False)
    ref_spec = _with_env(lambda: build(ref_engine), ODT_STEM_KERNEL=stem_kernel)
    spec = _with_env(lambda: build(engine), ODT_STEM_KERNEL=stem_kernel)
    assert len(spec) == len(ref_spec)
    for port_op, ref_op in zip(spec, ref_spec):
        _same_op(port_op, ref_op)
    names = [type(op).__name__ for op in spec]
    assert names.count("BottleneckOp") == (12 if fused_bottleneck else 0)
    assert (names[0] == "StemPoolPallasOp") == (stem_kernel == "1" and stem_algo == "direct")
    assert engine.required_scale_keys(spec) == ref_engine.required_scale_keys(ref_spec)
    assert [type(o).__name__ for o in engine._expand_spec(spec)] == \
        [type(o).__name__ for o in ref_engine._expand_spec(ref_spec)]


def test_both_kernels_are_on_by_default_and_img_pack_changes_nothing():
    """The reference leaves both kernels off unless the environment asks; the
    port turns them on on every device. Image-pair packing is a TPU layout:
    the port builds the unpacked list, where stage 1's later blocks are
    bottleneck ops too (2 + 3 + 5 + 2 = 12)."""
    ref_cfg, cfg = small_configs()
    spec = _with_env(lambda: engine.build_spec(cfg))
    names = [type(op).__name__ for op in spec]
    assert names[0] == "StemPoolPallasOp" and names.count("BottleneckOp") == 12
    assert [op.base for op in spec if isinstance(op, engine.BottleneckOp)][:2] == [
        "backbone/stage1_block2", "backbone/stage1_block3"]
    assert spec == _with_env(lambda: engine.build_resnet_ssd_spec(cfg))
    assert spec == _with_env(lambda: engine.build_spec(cfg), ODT_IMG_PACK="1")
    assert spec == _with_env(lambda: engine.build_resnet_ssd_spec(cfg, img_pack=True))
    assert spec == _with_env(lambda: engine.build_spec(cfg), ODT_STEM_KERNEL="auto",
                             ODT_FUSED_BOTTLENECK="1")
    ref_names = [type(op).__name__ for op in _with_env(lambda: ref_engine.build_spec(ref_cfg))]
    assert "BottleneckOp" not in ref_names and "StemPoolPallasOp" not in ref_names
    off = _with_env(lambda: engine.build_spec(cfg), ODT_STEM_KERNEL="0", ODT_FUSED_BOTTLENECK="0")
    assert off == _unfused_spec(cfg) and len(off) == len(ref_names)
    with pytest.raises(ValueError, match="stem_algo"):
        engine.build_resnet_trunk_spec(stem_algo="im2col")
    with pytest.raises(NotImplementedError):
        engine.build_spec(cfg.override({"model.backbone": "mobilenet"}))


@pytest.mark.parametrize("value,auto,want", [
    (None, True, True), (None, False, False), ("auto", True, True), ("auto", False, False),
    ("1", False, True), ("0", True, False), ("true", True, ValueError), ("", False, ValueError),
])
def test_env_tristate_grammar_is_the_reference_s(monkeypatch, value, auto, want):
    if value is None:
        monkeypatch.delenv("ODT_TEST_KNOB", raising=False)
    else:
        monkeypatch.setenv("ODT_TEST_KNOB", value)
    for mod in (engine, ref_engine):
        if want is ValueError:
            with pytest.raises(ValueError, match="ODT_TEST_KNOB"):
                mod._env_tristate("ODT_TEST_KNOB", auto=auto)
        else:
            assert mod._env_tristate("ODT_TEST_KNOB", auto=auto) is want
    if want is ValueError:  # a knob of the spec is checked even where its value changes nothing
        monkeypatch.setenv("ODT_IMG_PACK", value)
        with pytest.raises(ValueError, match="ODT_IMG_PACK"):
            engine.build_resnet_trunk_spec()


def test_quantize_params_bit_equal_and_scales_match(quant):
    """Weights, weight scales and folded biases exact; activation scales
    within rtol 1e-5 (the float32 convs sum in another order than XLA's)."""
    cfg, ref_qp = quant["cfg"], quant["ref_qp"]
    folded = engine.fold_resnet50(quant["state"])
    spec = _with_env(lambda: engine.build_spec(cfg))  # the kernel ops expand to their convs
    qp = engine.quantize_params(folded, spec, ref_qp.act_scale)
    assert set(qp.w_int8) == set(ref_qp.w_int8) and "backbone/stage1_block1/proj" in qp.w_int8
    for path in ref_qp.w_int8:
        np.testing.assert_array_equal(qp.w_int8[path].numpy(), np.asarray(ref_qp.w_int8[path]))
        np.testing.assert_array_equal(qp.w_scale[path].numpy(), np.asarray(ref_qp.w_scale[path]))
        np.testing.assert_array_equal(qp.bias[path].numpy(), np.asarray(ref_qp.bias[path]))
    got = engine.calibrate_scales(folded, spec, [torch.from_numpy(quant["x"])], use_l2norm=False)
    assert set(got) == set(ref_qp.act_scale) == engine.required_scale_keys(spec)
    assert "__l2norm__" not in got
    for key, want in ref_qp.act_scale.items():
        assert got[key] == pytest.approx(want, rel=1e-5), key


def test_run_int8_tap_codes_bit_equal_to_reference(quant):
    """Every tap (C3, C4, C5 and the two extras) of the port's unfused spec
    against the reference's eager run_int8 on the same QuantParams. The
    projection shortcuts' codes are signed (no ReLU) and the residual joins
    conv3's epilogue as codes times their scale."""
    qp = quant_params_from_jax(quant["ref_qp"])
    got = engine.run_int8(qp, _unfused_spec(quant["cfg"]), torch.from_numpy(quant["x"]),
                          dequantize_taps=False)
    assert len(got) == len(quant["ref_taps"]) == 5
    for (q, s), (q_ref, s_ref) in zip(got, quant["ref_taps"]):
        assert q.dtype == torch.int8 and s == s_ref and (q_ref > 0).mean() > 0.05
        np.testing.assert_array_equal(q.numpy(), q_ref)
    deq = engine.run_int8(qp, _unfused_spec(quant["cfg"]), torch.from_numpy(quant["x"]))
    assert all(t.dtype == torch.bfloat16 for t in deq)


def test_kernel_specs_against_the_unfused_spec(quant):
    """On one QuantParams: the fused bottleneck's spec gives the unfused
    spec's codes at every tap, bit for bit; the fused stem's output is within
    one code of the unfused chain's on at most 1e-4 of the elements (its
    requant multiplies by the reciprocal of the scale); with both on, the
    taps agree on 99.9% of the codes or more (a flipped stem code moves what
    follows). Each kernel op calls its function with the packed weights."""
    cfg, x = quant["cfg"], torch.from_numpy(quant["x"])
    qp = quant_params_from_jax(quant["ref_qp"])
    want = [q for q, _ in quant["ref_taps"]]
    calls = {"stem": 0, "bottleneck": 0}

    def stem_fn(*args, packed=None):
        calls["stem"] += 1
        assert torch.equal(packed, resnet_stem.pack_weights(args[1]))
        return resnet_stem.resnet_stem_reference(*args)

    def bottleneck_fn(*args, packed=None, **scales):
        calls["bottleneck"] += 1
        assert len(packed) == 3 and all(p.dtype == torch.int8 for p in packed)
        return bottleneck.fused_bottleneck(*args, **scales)

    spec_b = _with_env(lambda: engine.build_resnet_ssd_spec(cfg, fused_bottleneck=True),
                       ODT_STEM_KERNEL="0")
    got = engine.run_int8(qp, spec_b, x, dequantize_taps=False, bottleneck_fn=bottleneck_fn)
    assert calls == {"stem": 0, "bottleneck": 12}
    for (q, _), q_ref in zip(got, want):
        np.testing.assert_array_equal(q.numpy(), q_ref)

    stem_only = [engine.StemPoolPallasOp(), engine.TapOp(0)]
    (fused, s_f), = engine.run_int8(qp, stem_only, x, dequantize_taps=False, resnet_stem_fn=stem_fn)
    (chain, s_c), = engine.run_int8(qp, engine._expand_spec(stem_only), x, dequantize_taps=False)
    assert calls["stem"] == 1 and s_f == s_c and fused.shape == (2, SIZE // 4, SIZE // 4, 64)
    diff = (fused.int() - chain.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-4

    both = engine.run_int8(qp, _with_env(lambda: engine.build_spec(cfg)), x, dequantize_taps=False)
    for (q, _), q_ref in zip(both, want):
        assert (q.numpy() == q_ref).mean() >= 0.999


@pytest.mark.parametrize("int8_heads,atol", [(True, 1e-5), (False, 1e-4)])
def test_int8_forward_matches_reference(quant, int8_heads, atol):
    """Int8 heads: the same codes and the same float32 epilogue, and no
    L2Norm on a ResNet's first tap. Float heads over bf16 taps: atol 1e-4,
    the convs sum in another order."""
    ref_cfg, cfg = quant["ref_cfg"], quant["cfg"]
    want = ref_engine.int8_forward(quant["ref_qp"], quant["ref_spec"], ref_cfg,
                                   jnp.asarray(quant["x"]), int8_heads=int8_heads)
    qp = quant_params_from_jax(quant["ref_qp"])
    got = engine.int8_forward(qp, _unfused_spec(cfg), cfg, torch.from_numpy(quant["x"]),
                              int8_heads=int8_heads)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    if int8_heads:  # the full-width preset asks for bf16 class logits
        cfg16 = cfg.override({"eval.int8_logits_bf16": True})
        cls16, box16 = engine.int8_forward(qp, _unfused_spec(cfg), cfg16,
                                           torch.from_numpy(quant["x"]))
        assert cls16.dtype == torch.bfloat16 and torch.equal(cls16, got[0].to(torch.bfloat16))
        assert torch.equal(box16, got[1])


def test_quantize_ssd_folds_batch_norm_and_takes_a_spec(quant):
    cfg = quant["cfg"]
    x = torch.from_numpy(quant["x"])
    qp, spec = _with_env(lambda: engine.quantize_ssd(cfg, quant["state"], [x]))
    assert isinstance(spec[0], engine.StemPoolPallasOp)
    assert "backbone.stem_conv.bias" in qp.float_params  # the folded tree rides along
    assert "backbone.stem_bn.weight" not in qp.float_params
    assert set(qp.act_scale) == set(quant["ref_qp"].act_scale)
    override = _unfused_spec(cfg)
    qp2, spec2 = engine.quantize_ssd(cfg, quant["state"], [x], spec=override)
    assert spec2 is override and qp2.act_scale == qp.act_scale
    assert all(torch.equal(qp2.w_int8[k], qp.w_int8[k]) for k in qp.w_int8)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _scene(h=90, w=120):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    img[20:60, 30:90] = (220, 40, 40)
    return img


@pytest.fixture(scope="module")
def served():
    """The reference's int8 Predictor of the small model (calibrated on its
    default batch), the reference's activation scales for that batch, and
    the port's state_dict of the same weights."""
    ref_cfg, cfg = small_configs()
    variables = small_variables(ref_cfg, seed=8)
    calib = np.random.default_rng(0).integers(0, 255, (8, SIZE, SIZE, 3), dtype=np.uint8)
    x = ref_augment.normalize(jnp.asarray(calib).astype(jnp.float32) / 255.0)
    folded = ref_engine.fold_resnet50(variables["params"], variables["batch_stats"])
    spec = _with_env(lambda: ref_engine.build_spec(ref_cfg))
    scales = ref_engine.calibrate_scales(folded, spec, [x], use_l2norm=False)
    ref_predictor = _with_env(lambda: RefPredictor(ref_cfg, variables, int8=True))
    return ref_cfg, cfg, variables, variables_from_jax(variables), scales, ref_predictor


def _assert_detections_match(got, want):
    """valid and classes equal; scores and boxes within 1e-4 (both engines on
    the same scales; the reference's jitted program rounds its requant
    another way, see test_torch_int8_predict.py)."""
    valid = got.valid.numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=1e-4)


def test_int8_predict_fn_matches_reference(served, monkeypatch):
    """uint8 images in, detections out, on the reference's scales, with both
    kernel ops selected (their plain versions, on the CPU)."""
    ref_cfg, cfg, variables, state, scales, ref_predictor = served
    images = np.random.default_rng(10).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    want = ref_predictor._predict(None, jnp.asarray(images))
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    anchors = ssd_anchors(cfg.anchors, SIZE)
    predict = _with_env(lambda: make_int8_predict_fn(
        cfg, state, anchors, np.zeros((1, SIZE, SIZE, 3), np.uint8), device="cpu"))
    assert predict.qp.act_scale == scales
    assert sum(isinstance(op, engine.BottleneckOp) for op in predict.spec) == 12
    _assert_detections_match(predict(images), want)


def test_int8_predictor_matches_reference_predictor(served, monkeypatch):
    ref_cfg, cfg, variables, state, scales, ref_predictor = served
    img = _scene()
    want = ref_predictor.predict_array(img, score_threshold=0.0)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    predictor = _with_env(lambda: Predictor(cfg, state, device="cpu", int8=True))
    got = predictor.predict_array(img, score_threshold=0.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        assert abs(g.score - w.score) <= 1e-4
        np.testing.assert_allclose(g.box, w.box, atol=1e-4 * 120)


def test_int8_own_calibration_close_to_float(served):
    """Each path of the port on its own: the int8 engine calibrating itself
    stays within the reference's int8-vs-float band on this model (p99 of the
    logit error below 0.25, tests/test_quant.py:189)."""
    ref_cfg, cfg, variables, state, scales, ref_predictor = served
    images = np.random.default_rng(11).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    anchors = ssd_anchors(cfg.anchors, SIZE)
    predict = _with_env(lambda: make_int8_predict_fn(cfg, state, anchors, images, device="cpu"))
    for key, want in scales.items():
        assert key in predict.qp.act_scale
    model = SSDModel(cfg)
    model.load_state_dict(state)
    x = torch.from_numpy(np.array(
        ref_augment.normalize(jnp.asarray(images).astype(jnp.float32) / 255.0)))
    with torch.no_grad():
        f_cls, f_box = model.eval()(x)
    q_cls, q_box = engine.int8_forward(predict.qp, predict.spec, cfg, x)
    assert np.percentile((q_cls - f_cls).abs().numpy(), 99) < 0.25
    assert np.percentile((q_box - f_box).abs().numpy(), 99) < 0.25
    det, det_f = predict(images), make_predict_fn(cfg, model, anchors, device="cpu")(images)
    assert det.boxes.shape == det_f.boxes.shape == (2, cfg.eval.max_detections, 4)
    assert torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()


_SMALL_OVERRIDES = [
    "model.image_size=64", "model.num_classes=4", "anchors.feature_sizes=(8,4,2,1,1)",
    "anchors.sizes=((8.,16.),(16.,28.),(28.,40.),(40.,52.),(52.,62.))",
    "anchors.aspect_ratios=((2.0,),(2.0,),(2.0,),(2.0,),(2.0,))", "eval.max_detections=8",
]


@pytest.mark.parametrize("int8", [False, True])
def test_cli_predict_serves_the_resnet_preset_on_cpu(tmp_path, int8):
    """``predict --preset ssd512_resnet50_coco [--int8] --device cpu`` in
    smoke mode, cut to 64 px through ``--set`` (at 512 px the same command
    takes several seconds of eight cores)."""
    from PIL import Image

    image = tmp_path / "scene.png"
    Image.fromarray(_scene()).save(image)
    cmd = [sys.executable, "-m", "object_detector_tpu_torch", "predict", "--preset",
           "ssd512_resnet50_coco", "--device", "cpu", "--image", str(image),
           "--score-threshold", "0.0"]
    for pair in _SMALL_OVERRIDES:
        cmd += ["--set", pair]
    proc = subprocess.run(cmd + (["--int8"] if int8 else []), cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert 0 < len(lines) <= 8
    assert set(lines[0]) == {"class", "score", "box"} and len(lines[0]["box"]) == 4


def test_resnet_entry_points_default_to_cuda(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    ref_cfg, cfg, variables, state, scales, ref_predictor = served
    anchors = ssd_anchors(cfg.anchors, SIZE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_int8_predict_fn(cfg, state, anchors, np.zeros((1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, state, int8=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, state)
