"""The port's int8 engine (`quant.engine`) against the reference's on the
tiny config: op lists, weight quantization, calibration, the int8 trunk's
tap codes and the int8 forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.convert import flatten_tree, params_from_jax, quant_params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)


def _setup(name, seed):
    ref_cfg, cfg = ref_config.get_config(name), config.get_config(name)
    s = cfg.model.image_size
    init = jax.jit(lambda k, x: RefSSDModel(ref_cfg).init(k, x, train=False))
    params = init(jax.random.key(seed), jnp.zeros((1, s, s, 3)))["params"]
    return ref_cfg, cfg, params, params_from_jax(flatten_tree(params))


@pytest.fixture(scope="module")
def tiny():
    ref_cfg, cfg, params, state = _setup("tiny_test", seed=1)
    x = np.random.default_rng(2).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    spec = ref_engine.build_ssd_spec(ref_cfg)
    scales = ref_engine.calibrate_scales(params, spec, [jnp.asarray(x)])
    ref_qp = ref_engine.quantize_params(params, spec, scales)
    return ref_cfg, cfg, params, state, x, ref_qp


def _same_op(port_op, ref_op):
    """Same class name and the same value in every field the port has; the
    reference's other fields (residuals, TPU layouts) sit at their defaults."""
    assert type(port_op).__name__ == type(ref_op).__name__
    port_fields = dataclasses.asdict(port_op)
    for field in dataclasses.fields(ref_op):
        value = getattr(ref_op, field.name)
        if field.name in port_fields:
            assert port_fields[field.name] == value, (port_op, ref_op)
        else:
            assert value == field.default, (field.name, ref_op)


@pytest.mark.parametrize("name", ["tiny_test", "ssd300_vgg16_voc"])
@pytest.mark.parametrize("fused_stem", [False, True])
def test_spec_matches_reference(name, fused_stem):
    ref_spec = ref_engine.build_ssd_spec(ref_config.get_config(name), fused_stem=fused_stem)
    spec = engine.build_ssd_spec(config.get_config(name), fused_stem=fused_stem)
    assert len(spec) == len(ref_spec)
    for port_op, ref_op in zip(spec, ref_spec):
        _same_op(port_op, ref_op)
    for use_l2norm in (False, True):
        assert engine.required_scale_keys(spec, use_l2norm) == \
            ref_engine.required_scale_keys(ref_spec, use_l2norm)


def test_build_spec_resolves_the_fused_stem_on_every_device():
    """The reference fuses block 1 only on a TPU; the port wherever the image
    size is even. Both specs give the same codes (test_run_int8_...)."""
    cfg = config.get_config("tiny_test")
    assert isinstance(engine.build_spec(cfg)[0], engine.FusedStemOp)
    odd = cfg.override({"model.image_size": 63})
    assert isinstance(engine.build_spec(odd)[0], engine.ConvOp)
    # The ResNet-50 preset has a trunk of its own (test_torch_resnet_quant.py).
    assert not any(isinstance(op, engine.FusedStemOp)
                   for op in engine.build_spec(config.get_config("ssd512_resnet50_coco")))
    with pytest.raises(NotImplementedError):
        engine.build_spec(cfg.override({"model.backbone": "mobilenet"}))


def test_quantize_params_bit_equal(tiny):
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    qp = engine.quantize_params(state, engine.build_ssd_spec(cfg), ref_qp.act_scale)
    assert set(qp.w_int8) == set(ref_qp.w_int8)
    for path in ref_qp.w_int8:
        assert qp.w_int8[path].dtype == torch.int8
        np.testing.assert_array_equal(qp.w_int8[path].numpy(), np.asarray(ref_qp.w_int8[path]))
        np.testing.assert_array_equal(qp.w_scale[path].numpy(), np.asarray(ref_qp.w_scale[path]))
        np.testing.assert_array_equal(qp.bias[path].numpy(), np.asarray(ref_qp.bias[path]))


def test_calibrate_scales_match_reference(tiny):
    """rtol 1e-5: the float32 convs sum in another order than XLA's."""
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    got = engine.calibrate_scales(state, engine.build_ssd_spec(cfg), [torch.from_numpy(x)])
    assert set(got) == set(ref_qp.act_scale) and "__l2norm__" in got
    for key, want in ref_qp.act_scale.items():
        assert got[key] == pytest.approx(want, rel=1e-5), key


def test_quant_params_from_jax_takes_the_plain_stem_kernels(tiny):
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    fused = ref_engine.quantize_params(
        params, ref_engine.build_ssd_spec(ref_cfg, fused_stem=True), ref_qp.act_scale
    )
    qp = quant_params_from_jax(fused)
    assert not any(k.endswith("#plain") for k in qp.w_int8)
    for path in ("backbone/conv1_1", "backbone/conv1_2"):
        assert tuple(qp.w_int8[path].shape) == (3, 3, 3 if path.endswith("1_1") else 64, 64)
        np.testing.assert_array_equal(qp.w_int8[path].numpy(), np.asarray(ref_qp.w_int8[path]))
        np.testing.assert_array_equal(qp.w_scale[path].numpy(), np.asarray(ref_qp.w_scale[path]))
    assert qp.act_scale == ref_qp.act_scale
    assert torch.equal(qp.float_params["l2norm.scale"], state["l2norm.scale"])


@pytest.mark.parametrize("fused_stem", [False, True])
def test_run_int8_tap_codes_bit_equal(tiny, fused_stem):
    """The reference runs op by op, as its own tests do: its requant divides
    by the scale, as the port's does."""
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    want = ref_engine.run_int8(ref_qp, ref_engine.build_ssd_spec(ref_cfg), jnp.asarray(x),
                               dequantize_taps=False)
    got = engine.run_int8(quant_params_from_jax(ref_qp),
                          engine.build_ssd_spec(cfg, fused_stem=fused_stem),
                          torch.from_numpy(x), dequantize_taps=False)
    assert len(got) == len(want) == 2
    for (q, s), (q_ref, s_ref) in zip(got, want):
        assert q.dtype == torch.int8 and s == s_ref
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    deq = engine.run_int8(quant_params_from_jax(ref_qp), engine.build_ssd_spec(cfg),
                          torch.from_numpy(x))
    deq_ref = ref_engine.run_int8(ref_qp, ref_engine.build_ssd_spec(ref_cfg), jnp.asarray(x))
    for t, t_ref in zip(deq, deq_ref):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(t_ref, np.float32))


def test_run_int8_lays_out_constants_once(tiny):
    """The first call fills the QuantParams' cache of laid-out constants;
    the fused and unfused specs share it and still give the reference's
    codes, a repeated call adds nothing, and `to` starts a new cache."""
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    want = ref_engine.run_int8(ref_qp, ref_engine.build_ssd_spec(ref_cfg), jnp.asarray(x),
                               dequantize_taps=False)
    qp = quant_params_from_jax(ref_qp)
    sizes = []
    for fused_stem in (True, False, True):
        got = engine.run_int8(qp, engine.build_ssd_spec(cfg, fused_stem=fused_stem),
                              torch.from_numpy(x), dequantize_taps=False)
        for (q, _), (q_ref, _) in zip(got, want):
            np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        sizes.append(len(qp._derived))
    assert 0 < sizes[0] < sizes[1] == sizes[2]
    assert not qp.to("cpu")._derived


@pytest.mark.parametrize("int8_heads,atol", [(True, 1e-5), (False, 1e-4)])
def test_int8_forward_matches_reference(tiny, int8_heads, atol):
    """Int8 heads: the same codes and the same float32 epilogue. Float heads
    (bf16 taps): atol 1e-4, the convs sum in another order and the reference
    takes XLA's rsqrt for the L2Norm."""
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    want = ref_engine.int8_forward(ref_qp, ref_engine.build_ssd_spec(ref_cfg), ref_cfg,
                                   jnp.asarray(x), int8_heads=int8_heads)
    got = engine.int8_forward(quant_params_from_jax(ref_qp), engine.build_spec(cfg), cfg,
                              torch.from_numpy(x), int8_heads=int8_heads)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


def test_int8_logits_bf16_casts_only_the_class_logits(tiny):
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    qp, spec = quant_params_from_jax(ref_qp), engine.build_spec(cfg)
    cls32, box32 = engine.int8_forward(qp, spec, cfg, torch.from_numpy(x))
    cfg16 = cfg.override({"eval.int8_logits_bf16": True})
    cls16, box16 = engine.int8_forward(qp, spec, cfg16, torch.from_numpy(x))
    assert cls16.dtype == torch.bfloat16 and torch.equal(box16, box32)
    assert torch.equal(cls16, cls32.to(torch.bfloat16))


def test_unported_options_raise(tiny):
    """A backbone the engine has no op list for raises. The per-level head
    outputs, once refused here, run (tests/test_torch_per_level.py holds
    them): one (B, H, W, a*C) class tensor a level."""
    ref_cfg, cfg, params, state, x, ref_qp = tiny
    qp, spec = quant_params_from_jax(ref_qp), engine.build_spec(cfg)
    cls_levels, _ = engine.int8_forward(qp, spec, cfg, torch.from_numpy(x), concat_heads=False)
    assert [tuple(t.shape[1:]) for t in cls_levels] == [
        (f, f, a * cfg.model.num_classes)
        for f, a in zip(cfg.anchors.feature_sizes, cfg.anchors.anchors_per_level)]
    with pytest.raises(NotImplementedError):
        engine.quantize_ssd(cfg.override({"model.backbone": "mobilenet"}), state, [])
