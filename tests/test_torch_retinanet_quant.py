"""The port's int8 engine on RetinaNet/FPN against the reference's, on
`tiny_retinanet_config` (128 px, FPN and heads of 32 channels, one conv a
subnet): the float calibration runner, the int8 FPN and heads code for code
at every requant point, the float-FPN branch, quantization with its own
calibration, and the serving entry points (`make_int8_predict_fn`,
`Predictor(int8=True)`, `evaluate_dataset`, ``predict`` through the CLI)."""

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
from object_detector_tpu.data.pipeline import DecodedCache as RefDecodedCache
from object_detector_tpu.data.synthetic import make_synthetic_dataset as ref_synthetic
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.models import retinanet as ref_retinanet
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.ops.postprocess import postprocess as ref_postprocess
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.anchors.priors import retinanet_anchors
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import (
    flatten_tree, names_to_jax, quant_params_from_jax, variables_from_jax,
)
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.eval import evaluator
from object_detector_tpu_torch.quant import engine
from test_torch_resnet_quant import _with_env
from test_torch_resnet import _seeded_batch_norm
from test_torch_retinanet import SIZE, tiny_configs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unfused_trunk_spec():
    return _with_env(lambda: engine.build_resnet_trunk_spec(fused_bottleneck=False),
                     ODT_STEM_KERNEL="0")


def _normalized(images_u8):
    return np.asarray(ref_augment.normalize(jnp.asarray(images_u8).astype(jnp.float32) / 255.0))


class _RecordingJnp:
    """``jax.numpy`` with ``clip`` recorded: the reference's int8 FPN and
    heads requant through ``jnp.clip(jnp.round(y / s), -127, 127)`` and
    nothing else of theirs clips, so the records, in call order, are the
    codes at each requant point."""

    def __init__(self):
        self.clipped = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def clip(self, *args, **kwargs):
        out = jnp.clip(*args, **kwargs)
        self.clipped.append(np.asarray(out).astype(np.int8))
        return out


def numpy_variables(seed, head_depth=1):
    """flax ``variables`` of the tiny RetinaNet drawn from a numpy seed, in
    the tree `model.init` gives (traced for its shapes only): kernels normal
    with variance 1 / fan-in, biases normal with stddev 0.1, every BatchNorm
    as `test_torch_resnet._seeded_batch_norm` draws it."""
    ref_cfg, _ = tiny_configs(head_depth)
    model = ref_retinanet.RetinaNetModel(ref_cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = draw(value)
            elif key == "kernel":
                fan_in = int(np.prod(value.shape[:-1]))
                out[key] = rng.normal(0, fan_in ** -0.5, value.shape).astype(np.float32)
            else:
                out[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        return out

    return {name: _seeded_batch_norm(draw(shapes[name]), rng)
            for name in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def quant():
    """The reference's QuantParams of the tiny model (both ResNet kernels off,
    its default off a TPU) on a seeded calibration batch, its float32 FPN and
    heads with their absmax on the folded trunk's taps, its eager int8 trunk
    taps and the codes of its eager int8 FPN and heads at every requant
    point, in call order."""
    ref_cfg, cfg = tiny_configs(1)
    variables = numpy_variables(seed=5)
    x = np.random.default_rng(6).uniform(-2.0, 2.0, (1, SIZE, SIZE, 3)).astype(np.float32)
    ref_qp, ref_spec = _with_env(lambda: ref_engine.quantize_retinanet(
        ref_cfg, variables, [jnp.asarray(x)]))
    folded = ref_engine.fold_resnet50(variables["params"], variables["batch_stats"])
    float_taps, float_out = jax.jit(lambda p, i: _float_fpn_heads(ref_cfg, ref_spec, p, i))(
        folded, jnp.asarray(x))
    # Op by op, as the reference's own tests run it: its requant divides.
    taps_q = ref_engine.run_int8(ref_qp, ref_spec, jnp.asarray(x), dequantize_taps=False)
    recording = _RecordingJnp()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine, "jnp", recording)
        heads32 = ref_engine.run_int8_fpn_heads(ref_qp, ref_cfg, taps_q)
    return dict(
        ref_cfg=ref_cfg, cfg=cfg, variables=variables, state=variables_from_jax(variables), x=x,
        ref_qp=ref_qp, ref_spec=ref_spec, float_taps=[np.asarray(t) for t in float_taps],
        float_out=float_out, taps_q=[(np.asarray(q), s) for q, s in taps_q],
        codes=recording.clipped, heads32=[np.asarray(t) for t in heads32])


def _float_fpn_heads(ref_cfg, ref_spec, folded, x):
    taps, _ = ref_engine.run_float(folded, ref_spec, x)
    return taps, ref_engine.run_float_fpn_heads(folded, ref_cfg, taps)


def test_fpn_head_conv_paths_and_trunk_spec_match_reference(quant):
    for depth in (1, 4):
        ref_cfg, cfg = tiny_configs(depth)
        assert engine.fpn_head_conv_paths(cfg) == ref_engine.fpn_head_conv_paths(ref_cfg)
    assert len(engine.fpn_head_conv_paths(cfg)) == 8 + 2 * 5
    assert [type(op).__name__ for op in _unfused_trunk_spec()] == [
        type(op).__name__ for op in quant["ref_spec"]]


def test_run_float_fpn_heads_matches_reference(quant):
    """The same absmax keys as the reference's, each within 1e-5 relative,
    and the float32 logits within 1e-4, on the reference's float taps."""
    folded = engine.fold_resnet50(quant["state"])
    taps = [torch.tensor(t) for t in quant["float_taps"]]
    cls, box, absmax = engine.run_float_fpn_heads(folded, quant["cfg"], taps)
    want_cls, want_box, want_absmax = quant["float_out"]
    assert set(absmax) == set(want_absmax)
    assert {"fpn/pre3", "fpn/P7", "cls_head/conv0@P3", "box_head/conv0@P7"} <= set(absmax)
    for key, want in want_absmax.items():
        assert float(absmax[key]) == pytest.approx(float(want), rel=1e-5), key
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=0, atol=1e-4)
    np.testing.assert_allclose(box.numpy(), np.asarray(want_box), rtol=0, atol=1e-4)


def test_calibration_and_quantization_match_reference(quant):
    """Scales at every trunk and FPN requant point within 1e-5 relative (the
    float32 convs sum in another order than XLA's); on the reference's
    scales every int8 weight, weight scale and bias bit-equal."""
    cfg, ref_qp = quant["cfg"], quant["ref_qp"]
    folded = engine.fold_resnet50(quant["state"])
    spec = _unfused_trunk_spec()
    scales = engine.calibrate_scales(folded, spec, [torch.from_numpy(quant["x"])],
                                     use_l2norm=False, fpn_cfg=cfg)
    assert set(scales) == set(ref_qp.act_scale)
    for key, want in ref_qp.act_scale.items():
        assert scales[key] == pytest.approx(want, rel=1e-5), key
    qp = engine.quantize_params(folded, spec, ref_qp.act_scale,
                                head_paths=engine.fpn_head_conv_paths(cfg))
    assert set(qp.w_int8) == set(ref_qp.w_int8) and "cls_head/out" in qp.w_int8
    assert not any(k.startswith("head") for k in qp.w_int8)
    for path in ref_qp.w_int8:
        np.testing.assert_array_equal(qp.w_int8[path].numpy(), np.asarray(ref_qp.w_int8[path]))
        np.testing.assert_array_equal(qp.w_scale[path].numpy(), np.asarray(ref_qp.w_scale[path]))
        np.testing.assert_array_equal(qp.bias[path].numpy(), np.asarray(ref_qp.bias[path]))


def test_int8_trunk_and_fpn_codes_bit_equal_to_reference(quant):
    """On the reference's QuantParams and the port's unfused spec: the three
    trunk taps, then the codes at every requant point of the FPN and heads
    (fed the reference's taps), bit for bit; the float32 logits within
    1e-5, and the bfloat16 class logits within one bfloat16 step."""
    cfg = quant["cfg"]
    qp = quant_params_from_jax(quant["ref_qp"])
    taps = engine.run_int8(qp, _unfused_trunk_spec(), torch.from_numpy(quant["x"]),
                           dequantize_taps=False)
    for (q, s), (q_ref, s_ref) in zip(taps, quant["taps_q"]):
        assert s == s_ref and (q_ref > 0).mean() > 0.05
        np.testing.assert_array_equal(q.numpy(), q_ref)
    taps_q = [(torch.tensor(q), s) for q, s in quant["taps_q"]]
    codes = {}
    got = engine.run_int8_fpn_heads(qp, cfg, taps_q, codes=codes)
    assert list(codes) == [
        "fpn/pre3", "fpn/P3", "fpn/pre4", "fpn/P4", "fpn/pre5", "fpn/P5", "fpn/P6", "fpn/P7",
        *[f"{h}/conv0@P{i}" for h in ("cls_head", "box_head") for i in range(3, 8)]]
    assert len(codes) == len(quant["codes"])
    for (key, q), q_ref in zip(codes.items(), quant["codes"]):
        assert q.dtype == torch.int8 and q.shape == q_ref.shape, key
        np.testing.assert_array_equal(q.numpy(), q_ref, err_msg=key)
        assert (q_ref != 0).mean() > 0.05, key
    for g, w in zip(got, quant["heads32"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    cls16, box16 = engine.run_int8_fpn_heads(qp, cfg, taps_q, logits_dtype=torch.bfloat16)
    assert cls16.dtype == torch.bfloat16 and torch.equal(box16, got[1])
    # The reference casts the same float32 logits (quant/engine.py:1529-1532).
    want16 = np.asarray(jnp.asarray(quant["heads32"][0]).astype(jnp.bfloat16).astype(jnp.float32))
    step = np.abs(want16) * 2.0 ** -7 + 1e-30
    assert (np.abs(cls16.float().numpy() - want16) <= step).all()


@pytest.mark.parametrize("logits_bf16", [False, True])
def test_retinanet_int8_forward_matches_reference(quant, logits_bf16):
    """The whole forward on the unfused spec: the trunk, FPN and heads in
    int8, logits as in the test above."""
    ref_cfg, cfg = (c.override({"eval.int8_logits_bf16": logits_bf16})
                    for c in (quant["ref_cfg"], quant["cfg"]))
    qp = quant_params_from_jax(quant["ref_qp"])
    want = ref_engine.retinanet_int8_forward(quant["ref_qp"], quant["ref_spec"], ref_cfg,
                                             jnp.asarray(quant["x"]))
    got = engine.retinanet_int8_forward(qp, _unfused_trunk_spec(), cfg,
                                        torch.from_numpy(quant["x"]))
    assert got[0].dtype == (torch.bfloat16 if logits_bf16 else torch.float32)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
    want_cls = np.asarray(want[0].astype(jnp.float32))
    tol = np.abs(want_cls) * 2.0 ** -7 + 1e-5 if logits_bf16 else 1e-5
    assert (np.abs(got[0].float().numpy() - want_cls) <= tol).all()


def test_float_fpn_branch_matches_reference(quant):
    """quantize_fpn_heads=False: the int8 trunk's dequantized taps through the
    model's float FPN and heads (float32 here), within 1e-4 of the
    reference's flax modules."""
    ref_cfg, cfg, x = quant["ref_cfg"], quant["cfg"], quant["x"]
    ref_qp, ref_spec = _with_env(lambda: ref_engine.quantize_retinanet(
        ref_cfg, quant["variables"], [jnp.asarray(x)], quantize_fpn_heads=False))
    assert "fpn/lateral3" not in ref_qp.w_int8
    want = ref_engine.retinanet_int8_forward(ref_qp, ref_spec, ref_cfg, jnp.asarray(x),
                                             dtype=jnp.float32)
    qp = quant_params_from_jax(ref_qp)
    got = engine.retinanet_int8_forward(qp, _unfused_trunk_spec(), cfg, torch.from_numpy(x),
                                        dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    bf16 = engine.retinanet_int8_forward(qp, _unfused_trunk_spec(), cfg, torch.from_numpy(x))
    assert all(torch.isfinite(t).all() and t.dtype == torch.float32 for t in bf16)


def test_default_spec_against_the_unfused_spec(quant):
    """Both kernel ops on (their plain versions on the CPU), on one
    QuantParams: the bottleneck op alone gives the unfused spec's codes at
    every trunk tap and every FPN requant point; with the stem op too, at
    least 99.9% of them."""
    cfg, x = quant["cfg"], torch.from_numpy(quant["x"])
    qp = quant_params_from_jax(quant["ref_qp"])
    specs = {
        "unfused": _unfused_trunk_spec(),
        "bottleneck": _with_env(lambda: engine.build_resnet_trunk_spec(fused_bottleneck=True),
                                ODT_STEM_KERNEL="0"),
        "both": _with_env(engine.build_resnet_trunk_spec),
    }
    assert isinstance(specs["both"][0], engine.StemPoolPallasOp)
    codes = {}
    for name, spec in specs.items():
        taps = engine.run_int8(qp, spec, x, dequantize_taps=False)
        codes[name] = {f"tap{i}": q for i, (q, _) in enumerate(taps)}
        engine.run_int8_fpn_heads(qp, cfg, taps, codes=codes[name])
    assert len(codes["unfused"]) == 3 + 8 + 10
    for key, want in codes["unfused"].items():
        assert torch.equal(codes["bottleneck"][key], want), key
        assert float((codes["both"][key] == want).float().mean()) >= 0.999, key


def test_quantize_retinanet_own_calibration_close_to_float(quant):
    """The port calibrating itself, both kernel ops on: int8 against the
    float model within the reference's 99th-percentile band of 0.3
    (tests/test_quant.py:165), with the int8 FPN and heads and with the
    float-FPN fallback."""
    cfg, x = quant["cfg"], torch.from_numpy(quant["x"])
    from object_detector_tpu_torch.models.retinanet import RetinaNetModel

    model = RetinaNetModel(cfg)
    model.load_state_dict(quant["state"])
    with torch.no_grad():
        f_cls, f_box = model.eval()(x)
    qp, spec = _with_env(lambda: engine.quantize_retinanet(cfg, quant["state"], [x]))
    assert isinstance(spec[0], engine.StemPoolPallasOp)
    assert set(qp.act_scale) == set(quant["ref_qp"].act_scale)
    assert "backbone.stem_bn.weight" not in qp.float_params
    q_cls, q_box = engine.retinanet_int8_forward(qp, spec, cfg, x)
    assert q_cls.shape == f_cls.shape and q_box.shape == f_box.shape
    assert np.percentile((q_cls - f_cls).abs().numpy(), 99) < 0.3
    assert np.percentile((q_box - f_box).abs().numpy(), 99) < 0.3
    qp_f, spec_f = _with_env(lambda: engine.quantize_retinanet(
        cfg, quant["state"], [x], quantize_fpn_heads=False))
    assert "fpn/lateral3" not in qp_f.w_int8 and "fpn/P3" not in qp_f.act_scale
    l_cls, _ = engine.retinanet_int8_forward(qp_f, spec_f, cfg, x, dtype=torch.float32)
    assert np.percentile((l_cls - f_cls).abs().numpy(), 99) < 0.3
    override = _unfused_trunk_spec()
    qp2, spec2 = engine.quantize_retinanet(cfg, quant["state"], [x], spec=override)
    assert spec2 is override and qp2.act_scale == qp.act_scale


def test_per_level_outputs_still_raise(quant):
    cfg = quant["cfg"]
    qp = quant_params_from_jax(quant["ref_qp"])
    x = torch.from_numpy(quant["x"][:1])
    with pytest.raises(NotImplementedError, match="concat"):
        engine.retinanet_int8_forward(qp, _unfused_trunk_spec(), cfg, x, concat_heads=False)
    taps_q = [(torch.tensor(q), s) for q, s in quant["taps_q"]]
    with pytest.raises(NotImplementedError, match="concat"):
        engine.run_int8_fpn_heads(qp, cfg, taps_q, concat=False)
    per_level = cfg.override({"eval.per_level_heads": True})
    with pytest.raises(NotImplementedError, match="per_level_heads"):
        evaluator.make_int8_predict_fn(per_level, quant["state"], retinanet_anchors(SIZE),
                                       np.zeros((1, SIZE, SIZE, 3), np.uint8), use_pallas=True,
                                       device="cpu")


# ---------------------------------------------------------------------------
# The serving entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(quant):
    """The reference's QuantParams on its scales for the Predictor's default
    calibration batch (both ResNet kernels off, its default off a TPU), and
    its detections through its op-by-op int8 forward and postprocess: the
    jitted program rounds its requant another way (ROADMAP.md §C), which at
    this depth and width moves scores by up to 5e-4."""
    ref_cfg, variables = quant["ref_cfg"], quant["variables"]
    calib = np.random.default_rng(0).integers(0, 255, (8, SIZE, SIZE, 3), dtype=np.uint8)
    ref_qp, ref_spec = _with_env(lambda: ref_engine.quantize_retinanet(
        ref_cfg, variables, [jnp.asarray(_normalized(calib))]))
    anchors = jnp.asarray(retinanet_anchors(SIZE))

    def ref_predict(_variables, images_u8):
        x = jnp.asarray(_normalized(images_u8))
        heads = ref_engine.retinanet_int8_forward(ref_qp, ref_spec, ref_cfg, x)
        return ref_postprocess(*heads, anchors, ref_cfg)

    return ref_qp.act_scale, ref_predict


def _assert_detections_match(got, want):
    """valid and classes equal; scores and boxes within 1e-5 (the port's
    postprocess may round a sigmoid or a decode an ulp apart)."""
    valid = got.valid.numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=1e-5)


def test_int8_predict_fn_matches_reference(quant, served, monkeypatch):
    """uint8 images in, detections out, on the reference's scales: on the
    unfused spec, and on the default spec with both kernel ops (their plain
    versions on the CPU), whose stem may move a code (held in
    test_default_spec_against_the_unfused_spec) and so is held to valid
    slots and classes only where its logits differ."""
    scales, ref_predict = served
    cfg = quant["cfg"]
    images = np.random.default_rng(10).integers(0, 256, quant["x"].shape, dtype=np.uint8)
    want = ref_predict(None, images)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    anchors = retinanet_anchors(SIZE)
    calib = np.zeros((1, SIZE, SIZE, 3), np.uint8)
    for env in ({"ODT_STEM_KERNEL": "0", "ODT_FUSED_BOTTLENECK": "0"}, {}):
        predict = _with_env(lambda: evaluator.make_int8_predict_fn(
            cfg, quant["state"], anchors, calib, device="cpu"), **env)
        assert predict.qp.act_scale == scales and "cls_head/out" in predict.qp.w_int8
        assert sum(isinstance(op, engine.BottleneckOp) for op in predict.spec) == (
            0 if env else 12)
        _assert_detections_match(predict(images), want)


def test_int8_predictor_matches_reference_predictor(quant, served, monkeypatch):
    """The reference's Predictor.predict_array (resize, pixel boxes) around
    the reference's op-by-op predict, against the port's Predictor."""
    scales, ref_predict = served
    scene = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    scene[20:60, 30:90] = (220, 40, 40)
    ref_predictor = object.__new__(RefPredictor)
    ref_predictor.cfg, ref_predictor.variables = quant["ref_cfg"], None
    ref_predictor.class_names = [f"class_{i}" for i in range(quant["cfg"].model.num_classes)]
    ref_predictor._predict = ref_predict
    want = ref_predictor.predict_array(scene, score_threshold=0.0)
    monkeypatch.setattr(engine, "calibrate_scales", lambda *args, **kwargs: dict(scales))
    predictor = _with_env(lambda: Predictor(quant["cfg"], quant["state"], device="cpu",
                                            int8=True))
    assert predictor.model is None
    got = predictor.predict_array(scene, score_threshold=0.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.box, w.box, atol=1e-5 * 120)


def test_int8_sweep_matches_reference_on_its_scales(quant, monkeypatch):
    """`evaluate_dataset(int8=True)` over 12 synthetic images at batch 8, the
    COCO dict within 1e-3 of the reference's on the reference's scales for
    the first batch (what both calibrate on)."""
    ref_cfg, cfg = (c.override({"eval.map_style": "coco"})
                    for c in (quant["ref_cfg"], quant["cfg"]))
    dataset = make_synthetic_dataset(num_images=12, image_size=SIZE, seed=5)
    ref_dataset = ref_synthetic(num_images=12, image_size=SIZE, seed=5)
    cache = DecodedCache(dataset, SIZE, cfg.data.max_boxes, 1)
    ref_cache = RefDecodedCache(ref_dataset, SIZE, ref_cfg.data.max_boxes, 1)
    want = _with_env(lambda: ref_evaluator.evaluate_dataset(
        ref_cfg, ref_retinanet.RetinaNetModel(ref_cfg), quant["variables"], ref_dataset,
        cache=ref_cache, int8=True))
    ref_qp, _ = _with_env(lambda: ref_engine.quantize_retinanet(
        ref_cfg, quant["variables"], [jnp.asarray(_normalized(ref_cache.images[:8]))]))
    monkeypatch.setattr(engine, "calibrate_scales",
                        lambda *args, **kwargs: dict(ref_qp.act_scale))
    got = _with_env(lambda: evaluator.evaluate_dataset(cfg, quant["state"], dataset, cache=cache,
                                                       int8=True, device="cpu"))
    assert set(got) == set(want) and "mAP" in got
    for key, value in want.items():
        assert np.isfinite(got[key]) and abs(got[key] - value) <= 1e-3, (key, got[key], value)


_TINY_OVERRIDES = ["model.image_size=128", "model.fpn_channels=32", "model.head_depth=1",
                   "eval.max_detections=8"]


@pytest.mark.parametrize("int8", [False, True])
def test_cli_predict_serves_the_retinanet_preset_on_cpu(tmp_path, int8):
    """``predict --preset retinanet_fpn_coco [--int8] --device cpu`` in smoke
    mode, cut to 128 px and 32 channels through ``--set``."""
    from PIL import Image

    image = tmp_path / "scene.png"
    Image.fromarray(np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
                    ).save(image)
    cmd = [sys.executable, "-m", "object_detector_tpu_torch", "predict", "--preset",
           "retinanet_fpn_coco", "--device", "cpu", "--image", str(image),
           "--score-threshold", "0.0"]
    for pair in _TINY_OVERRIDES:
        cmd += ["--set", pair]
    proc = subprocess.run(cmd + (["--int8"] if int8 else []), cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert 0 < len(lines) <= 8
    assert set(lines[0]) == {"class", "score", "box"} and len(lines[0]["box"]) == 4


def test_predict_checkpoint_refuses_the_family(tmp_path, capsys):
    """``predict --checkpoint`` serves a RetinaNet checkpoint that `train`
    wrote, with its running statistics: the Predictor's detections on the
    restored state_dict. A checkpoint without the statistics (the format
    before they were kept) is refused rather than served with fresh
    ones."""
    from PIL import Image

    from object_detector_tpu_torch.cli.main import (
        _load_config, _restore_variables, build_parser, main,
    )

    image = tmp_path / "scene.png"
    pixels = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(image)
    ck = str(tmp_path / "ck")
    flags = ["--preset", "retinanet_fpn_coco", "--device", "cpu"]
    for pair in _TINY_OVERRIDES + ["mesh.data_parallel=1", "data.dataset=synthetic",
                                   "train.batch_size=2", "data.num_workers=1"]:
        flags += ["--set", pair]
    assert main(["train", *flags, "--steps", "1", "--checkpoint", ck]) == 0
    capsys.readouterr()
    argv = ["predict", *flags, "--image", str(image), "--checkpoint", ck, "--score-threshold", "0.0"]
    assert main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cfg = _load_config(build_parser().parse_args(argv))
    served = _restore_variables(cfg, ck)
    assert "backbone.stem_bn.running_var" in served
    want = Predictor(cfg, served, device="cpu").predict_array(pixels, 0.0)
    assert [d["score"] for d in lines] == [round(d.score, 4) for d in want] and want
    path = os.path.join(ck, "step_1.pt")
    payload = torch.load(path, weights_only=True)
    del payload["batch_stats"]
    torch.save(payload, path)
    with pytest.raises(ValueError, match="no BatchNorm running statistics"):
        main(argv)


def test_int8_entry_points_default_to_cuda(quant):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    cfg, state = quant["cfg"], quant["state"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluator.make_int8_predict_fn(cfg, state, retinanet_anchors(SIZE),
                                       np.zeros((1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, state, int8=True)
    assert set(names_to_jax(state)) == {**flatten_tree(quant["variables"]["params"]),
                                        **flatten_tree(quant["variables"]["batch_stats"])}.keys()
