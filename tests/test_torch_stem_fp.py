"""All of VGG block 1 in one kernel (`kernels.stem_fp`): its plain version
against the Pallas `stem_fused_producer` in interpret mode and against the
reference's unfused int8 chain, the kernel's weight layout, and the
engine's ``ODT_STEM_FP`` route on `tiny_test` against the reference. Every
comparison is of int8 codes, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.kernels import stem_pallas
from object_detector_tpu.models.ssd import SSDModel as RefSSDModel
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.convert import flatten_tree, params_from_jax, quant_params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.kernels import stem, stem_fp
from object_detector_tpu_torch.kernels.requant_epilogue import epilogue_reference
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.quant import engine

torch.set_num_threads(2)


def _ref_conv(x, w):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME", dimension_numbers=dn,
        preferred_element_type=jnp.int32,
    )


def _ref_requant(acc, deq, b, s):
    y = jnp.maximum(acc.astype(jnp.float32) * deq + b, 0.0)
    return jnp.clip(jnp.round(y / s), -127, 127).astype(jnp.int8)


def _ref_block1(x_q, w1, deq1, b1, s1, w2, deq2, b2, s2):
    """The reference's unfused int8 block 1 (tests/test_quant.py:463-480)."""
    q1 = _ref_requant(_ref_conv(x_q, w1), deq1, b1, s1)
    q2 = _ref_requant(_ref_conv(q1, w2), deq2, b2, s2)
    return np.asarray(jax.lax.reduce_window(
        q2, jnp.int8(-128), jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"))


def _case(kind, seed=7):
    """(x_q, w1, deq1, b1, s1, w2, deq2, b2, s2) as numpy arrays and floats."""
    rng = np.random.default_rng(seed)
    b, h, w = {"ragged": (2, 12, 28), "bs1": (1, 20, 20)}.get(kind, (2, 20, 20))
    lim = 128 if kind == "saturating" else 10
    x_q = rng.integers(-lim + 1, lim, (b, h, w, 3), dtype=np.int8)
    w1 = rng.integers(-lim + 1, lim, (3, 3, 3, 64)).astype(np.int8)
    w2 = rng.integers(-lim + 1, lim, (3, 3, 64, 64)).astype(np.int8)
    deq1 = ((rng.random(64) + 0.5) * 1e-2).astype(np.float32)
    b1 = (rng.normal(size=64) * 0.1).astype(np.float32)
    deq2 = ((rng.random(64) + 0.5) * 1e-2).astype(np.float32)
    b2 = (rng.normal(size=64) * 0.1).astype(np.float32)
    s1, s2 = 0.043, 0.021
    if kind == "saturating":  # large sums: most codes of both convs clip at +127
        deq1 *= 20.0
        deq2 *= 20.0
    elif kind == "negative_bias":  # both convs' outputs all below zero
        b1 = -np.abs(b1) - 100.0
        b2 = -np.abs(b2) - 100.0
    elif kind == "large_bias1":  # rq(relu(b1)) well above 0: an unzeroed halo would show
        b1 = np.abs(b1) + 3.0
    elif kind == "zero_input":
        x_q[:] = 0
    return x_q, w1, deq1, b1, s1, w2, deq2, b2, s2


def _torch_args(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("band_rows", [20, 10])
def test_reference_bit_equal_to_pallas_interpret(band_rows):
    """The TPU kernel in interpret mode, fed as tests/test_quant.py:482-508
    feeds it: pre-paired input codes, flat odd-pair conv1_1 weights, packed
    conv1_2 weights and every vector tiled twice."""
    x_q, w1, deq1, b1, s1, w2, deq2, b2, s2 = _case("random")
    b, h, w, _ = x_q.shape
    want = np.asarray(stem_pallas.stem_fused_producer(
        jnp.asarray(x_q).reshape(b, h, w // 2, 6),
        jnp.asarray(stem_pallas.pack_conv11_flat(stem_pallas.pack_conv11_pair(w1))),
        jnp.asarray(np.tile(deq1, 2)), jnp.asarray(np.tile(b1, 2)), jnp.float32(s1),
        jnp.asarray(stem_pallas.pack_conv12_pair(w2)),
        jnp.asarray(np.tile(deq2, 2)), jnp.asarray(np.tile(b2, 2)), jnp.float32(s2),
        out_width=w // 2, interpret=True, band_rows=band_rows,
    ))
    got = stem_fp.stem_fused_producer_reference(*_torch_args(_case("random"))).numpy()
    assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "large_bias1", "saturating", "negative_bias",
                                  "zero_input", "ragged", "bs1"])
def test_reference_bit_equal_to_unfused_chain(kind):
    """Against the reference's unfused chain; "ragged" is (12, 28), whose
    pooled 6 x 14 leaves the kernel's 8 x 8 tiles partial."""
    args = _case(kind)
    want = _ref_block1(*args)
    got = stem_fp.stem_fused_producer_reference(*_torch_args(args)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "saturating":
        assert (got == 127).mean() > 0.5
    if kind in ("negative_bias",):
        assert not got.any()
    if kind == "large_bias1":
        # conv1_1 computed over the one-pixel halo and not zeroed there (the
        # trap a halo'd tile sets) gives other codes on this case.
        x_q, w1, deq1, b1, s1, w2, deq2, b2, s2 = _torch_args(args)
        padded = torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1))
        halo = epilogue_reference(int8_ops.conv_int8(padded, w1), deq1, b1, s1,
                                  relu=True).codes
        unzeroed = int8_ops.max_pool(epilogue_reference(
            int8_ops.conv_int8(halo, w2, padding="VALID"), deq2, b2, s2, relu=True).codes, 2, 2)
        assert (unzeroed.numpy() != got).any()
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = stem_fp.stem_fused_producer.launches
    np.testing.assert_array_equal(stem_fp.stem_fused_producer(*_torch_args(args)).numpy(), want)
    assert stem_fp.stem_fused_producer.launches == before


def test_pack_weights_is_the_kernels_dp4a_layout():
    """The operands csrc/stem_fp.cu reads, now for mma.sync rather than
    __dp4a: w1 as the (32, 64) matrix of row 3 * tap + cin with zero rows
    27..31, w2 as the (576, 64) matrix of row 64 * tap + cin, each in the
    packed B layout; both convs rebuilt from what the kernel reads equal
    the int8 convs they stand for (the A rows of conv1_1 as the kernel
    builds them; tests/test_torch_int8_pack.py has the case by case
    version)."""
    from test_torch_int8_pack import _conv11_rows, _taps, kernel_b_matrix

    x_q, w1, _, _, _, w2, _, _, _ = _torch_args(_case("saturating"))
    w1_packed, w2_packed = stem_fp.pack_weights(w1, w2)
    assert tuple(w1_packed.shape) == (1, 1, 4, 32, 16)
    assert tuple(w2_packed.shape) == (1, 18, 4, 32, 16)
    assert w1_packed.dtype == w2_packed.dtype == torch.int8
    m1, m2 = kernel_b_matrix(w1_packed, 32, 64), kernel_b_matrix(w2_packed, 576, 64)
    np.testing.assert_array_equal(m1[:27], w1.reshape(27, 64).numpy())
    assert not m1[27:].any()
    acc1 = _conv11_rows(x_q.numpy()).astype(np.int64) @ m1
    np.testing.assert_array_equal(acc1, int8_ops.conv_int8(x_q, w1).numpy())
    q1 = torch.randint(-127, 128, (1, 6, 8, 64), generator=torch.Generator().manual_seed(0),
                       dtype=torch.int8)
    acc2 = sum(win.astype(np.int64) @ m2[64 * t: 64 * (t + 1)]
               for t, win in enumerate(_taps(q1.numpy())))
    np.testing.assert_array_equal(acc2, int8_ops.conv_int8(q1, w2).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x_q, w1, deq1, b1, s1, w2, deq2, b2, s2 = _torch_args(_case("random"))
    with pytest.raises(ValueError):
        stem_fp.stem_fused_producer(x_q[:, :19], w1, deq1, b1, s1, w2, deq2, b2, s2)  # odd H
    with pytest.raises(ValueError):
        stem_fp.stem_fused_producer(x_q, w2, deq1, b1, s1, w2, deq2, b2, s2)
    with pytest.raises(ValueError):
        stem_fp.stem_fused_producer(x_q, w1, deq1[:32], b1, s1, w2, deq2, b2, s2)
    with pytest.raises(TypeError):
        stem_fp.stem_fused_producer(x_q.float(), w1, deq1, b1, s1, w2, deq2, b2, s2)
    with pytest.raises(TypeError):
        stem_fp.stem_fused_producer(x_q, w1, deq1.double(), b1, s1, w2, deq2, b2, s2)


@pytest.fixture(scope="module")
def tiny():
    ref_cfg, cfg = ref_config.get_config("tiny_test"), config.get_config("tiny_test")
    init = jax.jit(lambda k, x: RefSSDModel(ref_cfg).init(k, x, train=False))
    params = init(jax.random.key(4), jnp.zeros((1, 64, 64, 3)))["params"]
    x = np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    spec = ref_engine.build_ssd_spec(ref_cfg)
    ref_qp = ref_engine.quantize_params(params, spec, ref_engine.calibrate_scales(
        params, spec, [jnp.asarray(x)]))
    return ref_cfg, cfg, x, ref_qp


def test_engine_route_bit_equal_to_b2_route_and_reference(tiny, monkeypatch):
    """``ODT_STEM_FP=1`` against ``=0`` on the same QuantParams: tap codes
    and int8-head logits equal; the taps equal to the reference's op-by-op
    `run_int8` on its default (unfused) route, which its own
    tests/test_quant.py:443 holds equal to its fully-fused kernel."""
    ref_cfg, cfg, x, ref_qp = tiny
    qp, spec = quant_params_from_jax(ref_qp), engine.build_spec(cfg)
    assert isinstance(spec[0], engine.FusedStemOp)
    want = ref_engine.run_int8(ref_qp, ref_engine.build_ssd_spec(ref_cfg), jnp.asarray(x),
                               dequantize_taps=False)
    out = {}
    for value in ("0", "1"):
        monkeypatch.setenv("ODT_STEM_FP", value)
        seen = []

        def stem_fp_fn(*args, **kwargs):
            seen.append(args[0].shape)
            return stem_fp.stem_fused_producer(*args, **kwargs)

        taps = engine.run_int8(qp, spec, torch.from_numpy(x), dequantize_taps=False,
                               stem_fp_fn=stem_fp_fn)
        heads = engine.int8_forward(qp, spec, cfg, torch.from_numpy(x), stem_fp_fn=stem_fp_fn)
        assert seen == ([] if value == "0" else [(2, 64, 64, 3)] * 2)
        out[value] = (taps, heads)
        for (q, s), (q_ref, s_ref) in zip(taps, want):
            assert s == s_ref
            np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    for a, b in zip(out["0"][1], out["1"][1]):
        assert torch.equal(a, b)
    assert ("stem_fp", "backbone/conv1_1") in qp._derived


def test_engine_b2_route_packs_conv1_2_once_and_passes_it(tiny, monkeypatch):
    """On the B2 route (``ODT_STEM_FP=0``) the engine lays out conv1_2's
    packed operand once per QuantParams (`stem.pack_weights`, cached through
    ``qp.derived``) and hands the same tensor to every ``stem_fn`` call,
    where the wrapper used to re-lay out the kernel on every call."""
    _, cfg, x, ref_qp = tiny
    qp, spec = quant_params_from_jax(ref_qp), engine.build_spec(cfg)
    monkeypatch.setenv("ODT_STEM_FP", "0")
    packs, seen = [], []
    real_pack = stem.pack_weights

    def counting_pack(w2):
        packs.append(w2)
        return real_pack(w2)

    def stem_fn(*args, **kwargs):
        seen.append(kwargs["packed"])
        return stem.stem_conv12_pool(*args, **kwargs)

    monkeypatch.setattr(stem, "pack_weights", counting_pack)
    first = engine.int8_forward(qp, spec, cfg, torch.from_numpy(x), stem_fn=stem_fn)
    second = engine.int8_forward(qp, spec, cfg, torch.from_numpy(x), stem_fn=stem_fn)
    assert len(packs) == 1 and len(seen) == 2 and seen[0] is seen[1]
    w2 = qp.w_int8["backbone/conv1_2"]
    assert packs[0] is w2 and torch.equal(seen[0], real_pack(w2))
    assert qp._derived[("stem", "backbone/conv1_2")] is seen[0]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_stem_fp_is_on_by_default_and_the_grammar_is_strict(monkeypatch):
    """On unless ODT_STEM_FP=0, where the reference is off unless =1
    (quant/engine.py:1069-1072): the card's times decide (PERF.md)."""
    monkeypatch.delenv("ODT_STEM_FP", raising=False)
    assert engine.stem_fp_on() is True
    for value, want in (("auto", True), ("0", False), ("1", True)):
        monkeypatch.setenv("ODT_STEM_FP", value)
        assert engine.stem_fp_on() is want
    monkeypatch.setenv("ODT_STEM_FP", "yes")
    with pytest.raises(ValueError, match="ODT_STEM_FP"):
        engine.stem_fp_on()
