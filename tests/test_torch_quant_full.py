"""The port's int8 engine against the reference's at full width:
ssd300_vgg16_voc, batch 1, every tap and every one of the 8732 anchors,
with the reference's quantized weights and scales carried over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.convert import quant_params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def full_width():
    name = "ssd300_vgg16_voc"
    ref_cfg, cfg = ref_config.get_config(name), config.get_config(name)
    init = jax.jit(lambda k, x: RefSSDModel(ref_cfg).init(k, x, train=False))
    params = init(jax.random.key(1), jnp.zeros((1, 300, 300, 3)))["params"]
    x = np.random.default_rng(2).normal(0, 1, (1, 300, 300, 3)).astype(np.float32)
    ref_spec = ref_engine.build_ssd_spec(ref_cfg)
    scales = ref_engine.calibrate_scales(params, ref_spec, [jnp.asarray(x)])
    ref_qp = ref_engine.quantize_params(params, ref_spec, scales)
    # Op by op, as the reference's own tests run it (its requant divides).
    ref_taps = ref_engine.run_int8(ref_qp, ref_spec, jnp.asarray(x), dequantize_taps=False)
    qp = quant_params_from_jax(ref_qp)
    taps = engine.run_int8(qp, engine.build_spec(cfg), torch.from_numpy(x), dequantize_taps=False)
    return ref_cfg, cfg, ref_qp, qp, ref_taps, taps, x


def test_full_width_tap_codes_bit_equal(full_width):
    ref_cfg, cfg, ref_qp, qp, ref_taps, taps, x = full_width
    shapes = [tuple(q.shape) for q, _ in taps]
    assert shapes == [(1, 38, 38, 512), (1, 19, 19, 1024), (1, 10, 10, 512), (1, 5, 5, 256),
                      (1, 3, 3, 256), (1, 1, 1, 256)]
    for (q, s), (q_ref, s_ref) in zip(taps, ref_taps):
        assert s == s_ref
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))


def test_full_width_int8_forward_matches_reference(full_width):
    """The port's whole int8_forward against the reference's trunk codes
    through its heads: logits and offsets within 1e-5."""
    ref_cfg, cfg, ref_qp, qp, ref_taps, taps, x = full_width
    want = ref_engine.apply_heads_int8(ref_qp, ref_taps, ref_cfg)
    got = engine.int8_forward(qp, engine.build_spec(cfg), cfg, torch.from_numpy(x))
    assert tuple(got[0].shape) == (1, 8732, 20) and tuple(got[1].shape) == (1, 8732, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
