"""The plain versions of the port's two ResNet kernels against the
reference: the fused stem (`kernels.resnet_stem`) against the Pallas
``resnet_stem_int8`` in interpret mode and against the unfused int8 chain,
and the fused bottleneck (`kernels.bottleneck`) against the Pallas
``fused_bottleneck`` in interpret mode and the reference's eager unfused
chain. Also the layouts the CUDA kernels read, and what the wrappers refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.kernels import bottleneck_pallas, resnet_stem_pallas
from object_detector_tpu_torch.kernels import bottleneck, resnet_stem
from object_detector_tpu_torch.kernels.requant_epilogue import epilogue_reference
from object_detector_tpu_torch.ops import int8 as int8_ops

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _stem_case(kind):
    """The three cases of tests/test_resnet_stem_pallas.py: images, w_q,
    w_scale, bias, in_scale, out_scale."""
    rng = np.random.default_rng(0)
    if kind == "edge":  # saturated inputs and extreme biases
        images = rng.choice([-2.6, -0.02, 0.0, 0.02, 2.6], (1, 32, 32, 3)).astype(np.float32)
        w_q = rng.choice([-127, -1, 0, 1, 127], (7, 7, 3, 64)).astype(np.int8)
        w_scale = np.full(64, 0.01, np.float32)
        bias = rng.normal(0, 3.0, 64).astype(np.float32)
        return images, w_q, w_scale, bias, 0.02, 0.05
    size = int(kind)
    images = rng.normal(0, 1.2, (2, size, size, 3)).astype(np.float32)
    w_q = rng.integers(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    w_scale = rng.uniform(0.005, 0.02, 64).astype(np.float32)
    bias = rng.normal(0, 0.5, 64).astype(np.float32)
    return images, w_q, w_scale, bias, 0.02, 0.07


@pytest.mark.parametrize("kind", ["32", "64", "edge"])
def test_resnet_stem_reference_bit_equal_to_pallas_interpret(kind):
    images, w_q, w_scale, bias, s_in, s_out = _stem_case(kind)
    want = np.asarray(resnet_stem_pallas.resnet_stem_int8(
        jnp.asarray(images), jnp.asarray(w_q), jnp.asarray(w_scale), jnp.asarray(bias),
        s_in, s_out, interpret=True))
    deq = np.float32(s_in) * w_scale  # as the engine forms it
    args = (_t(images), _t(w_q), _t(deq), _t(bias), s_in, s_out)
    got = resnet_stem.resnet_stem_reference(*args).numpy()
    assert got.dtype == np.int8 and got.shape == (images.shape[0], images.shape[1] // 4,
                                                  images.shape[2] // 4, 64)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.05
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = resnet_stem.resnet_stem.launches
    np.testing.assert_array_equal(resnet_stem.resnet_stem(*args).numpy(), want)
    assert resnet_stem.resnet_stem.launches == before


@pytest.mark.parametrize("kind", ["64", "edge"])
def test_resnet_stem_reference_within_one_code_of_the_unfused_chain(kind):
    """The kernel multiplies by float32(1 / out_scale) where the chain divides
    by out_scale: a quotient that lies within an ulp of a rounding boundary
    can land on the other side, so a code may differ by one, on a vanishing
    share of the elements (the reference says 1e-6 of itself; allowed here:
    1e-4 of the pre-pool codes). Everything else is equal: input codes,
    sums, bias, ReLU, the pool."""
    images, w_q, w_scale, bias, s_in, s_out = _stem_case(kind)
    deq = _t(np.float32(s_in) * w_scale)
    x = int8_ops.quantize(_t(images).clone(), int8_ops.scale_tensor(s_in, torch.device("cpu")))
    acc = int8_ops.conv_int8(x, _t(w_q), stride=2, padding=3)
    q = epilogue_reference(acc, deq, _t(bias), s_out, relu=True).codes
    want = int8_ops.max_pool(q, 3, 2, explicit_pad=1).numpy().astype(np.int32)
    got = resnet_stem.resnet_stem_reference(_t(images), _t(w_q), deq, _t(bias), s_in, s_out)
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_resnet_stem_pool_pads_with_the_minimum_and_input_with_zero_codes():
    """A bias so negative that every conv code is 0: the pooled border must be
    0 too (the pad is -128, never a conv value), and a constant image must
    give smaller sums at the border, where the taps fall on zero codes."""
    w_q = np.ones((7, 7, 3, 64), np.int8)
    deq, s_in, s_out = np.full(64, 0.01, np.float32), 0.02, 0.05
    images = np.full((1, 16, 16, 3), 0.2, np.float32)  # every code 10
    low = resnet_stem.resnet_stem_reference(_t(images), _t(w_q), _t(deq),
                                            _t(np.full(64, -1e4, np.float32)), s_in, s_out)
    assert not low.any()
    out = resnet_stem.resnet_stem_reference(_t(images), _t(w_q), _t(deq),
                                            _t(np.zeros(64, np.float32)), s_in, s_out).numpy()
    # interior conv sum 147 * 10 = 1470 -> 14.7 / 0.05 = 294 -> clipped 127;
    # the corner conv output sees 4 x 4 taps: 480 -> 4.8 / 0.05 = 96, and the
    # pool's corner window reaches conv (1, 1) with 5 x 5 taps: 750 -> 127.
    assert out[0, 1, 1, 0] == 127 and out[0, 0, 0, 0] == 127
    tiny = resnet_stem.resnet_stem_reference(_t(images[:, :4, :4]), _t(w_q), _t(deq),
                                             _t(np.zeros(64, np.float32)), s_in, s_out).numpy()
    assert tiny.shape == (1, 1, 1, 64) and tiny[0, 0, 0, 0] == 96  # 4 x 4 x 3 x 10 = 480


def _bottleneck_case(kind):
    """"reference": the case of tests/test_quant.py:526. "large_b1": a conv1
    bias large enough that rq(relu(b1)) is far from 0, so padding the 3x3
    with conv1's value at a zero input, not with zero codes, would show."""
    rng = np.random.default_rng(7)
    b, h, w, c, cm = 2, 12, 16, 32, 16
    x = rng.integers(-31, 32, (b, h, w, c), dtype=np.int8)
    w1 = rng.integers(-9, 10, (c, cm)).astype(np.int8)
    w2 = rng.integers(-9, 10, (3, 3, cm, cm)).astype(np.int8)
    w3 = rng.integers(-9, 10, (cm, c)).astype(np.int8)
    deq1 = (rng.random(cm).astype(np.float32) + 0.5) * 1e-2
    b1 = rng.normal(size=cm).astype(np.float32) * 0.1
    deq2 = (rng.random(cm).astype(np.float32) + 0.5) * 1e-2
    b2 = rng.normal(size=cm).astype(np.float32) * 0.1
    deq3 = (rng.random(c).astype(np.float32) + 0.5) * 1e-2
    b3 = rng.normal(size=c).astype(np.float32) * 0.1
    if kind == "large_b1":
        b1 = b1 + 2.0  # rq(relu(b1)) is about 2 / 0.043 = 47 codes
    scales = dict(s1=0.043, s2=0.021, s3=0.037, resid_scale=0.029)
    return (x, w1, deq1, b1, w2, deq2, b2, w3, deq3, b3), scales


def _ref_unfused_chain(ops, scales):
    """The reference's eager unfused chain (tests/test_quant.py:548-568)."""
    x, w1, deq1, b1, w2, deq2, b2, w3, deq3, b3 = ops
    c, cm = w1.shape

    def conv(a, k):
        dn = jax.lax.conv_dimension_numbers(a.shape, k.shape, ("NHWC", "HWIO", "NHWC"))
        return jax.lax.conv_general_dilated(a, jnp.asarray(k), (1, 1), "SAME",
                                            dimension_numbers=dn,
                                            preferred_element_type=jnp.int32)

    def requant(acc, deq, bias, s, extra=None):
        y = acc.astype(jnp.float32) * deq + bias
        if extra is not None:
            y = y + extra
        return jnp.clip(jnp.round(jnp.maximum(y, 0.0) / s), -127, 127).astype(jnp.int8)

    xq = jnp.asarray(x)
    q1 = requant(conv(xq, w1.reshape(1, 1, c, cm)), deq1, b1, scales["s1"])
    q2 = requant(conv(q1, w2), deq2, b2, scales["s2"])
    return np.asarray(requant(conv(q2, w3.reshape(1, 1, cm, c)), deq3, b3, scales["s3"],
                              extra=xq.astype(jnp.float32) * scales["resid_scale"]))


@pytest.mark.parametrize("kind", ["reference", "large_b1"])
@pytest.mark.parametrize("band_rows", [4, None])
def test_bottleneck_reference_bit_equal_to_pallas_interpret(kind, band_rows):
    """Against the jitted TPU kernel in interpret mode (three bands of four
    rows, and its own choice) and against the reference's eager chain."""
    ops, scales = _bottleneck_case(kind)
    want = np.asarray(bottleneck_pallas.fused_bottleneck(
        *(jnp.asarray(a) for a in ops), **scales, band_rows=band_rows, interpret=True))
    got = bottleneck.fused_bottleneck_reference(*(_t(a) for a in ops), **scales).numpy()
    assert got.dtype == np.int8 and got.shape == ops[0].shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_unfused_chain(ops, scales))
    assert 0.05 < (got > 0).mean() < 0.95
    before = bottleneck.fused_bottleneck.launches
    wrapped = bottleneck.fused_bottleneck(*(_t(a) for a in ops), **scales)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert bottleneck.fused_bottleneck.launches == before


def test_bottleneck_pads_the_3x3_with_zero_codes_of_mid1():
    """With a zero input and zero conv weights mid1 is rq(relu(b1)) at every
    pixel, so conv2 sees how many of its taps fall inside the image: the
    corner's sum is 4/9 of the interior's."""
    c, cm = 16, 16
    z = lambda *s: torch.zeros(*s, dtype=torch.int8)  # noqa: E731
    f = lambda n, v: torch.full((n,), v, dtype=torch.float32)  # noqa: E731
    w2 = torch.ones(3, 3, cm, cm, dtype=torch.int8)
    w3 = torch.zeros(cm, c, dtype=torch.int8)
    w3[0, :] = 1
    out = bottleneck.fused_bottleneck_reference(
        z(1, 5, 5, c), z(c, cm), f(cm, 1.0), f(cm, 3.0),  # mid1 = 3 everywhere
        w2, f(cm, 1.0), f(cm, 0.0), w3, f(c, 1.0), f(c, 0.0),
        s1=1.0, s2=16.0, s3=1.0, resid_scale=1.0)
    # conv2 = taps * 16 channels * 3 -> / 16 = 3 * taps; conv3 passes channel 0.
    assert out[0, 2, 2, 0] == 27 and out[0, 0, 0, 0] == 12 and out[0, 0, 2, 0] == 18


def test_packed_weights_hold_four_input_channels_a_word():
    """The layouts the CUDA kernels read, checked where they are made: the
    bottleneck's three kernels as (K, N) matrices (w2 tap-major) in the
    tensor cores' packed B layout, and the ResNet stem's kernel as the
    (192, 64) space-to-depth matrix in the same layout, from which the 7x7/s2
    conv is rebuilt as the kernel's fragments read it
    (tests/test_torch_int8_pack.py rebuilds the convs at more widths and
    sizes)."""
    from test_torch_int8_pack import kernel_b_matrix, resnet_stem_conv_from_packed

    rng = np.random.default_rng(1)
    w1 = _t(rng.integers(-127, 128, (128, 64)).astype(np.int8))
    w2 = _t(rng.integers(-127, 128, (3, 3, 64, 64)).astype(np.int8))
    w3 = _t(rng.integers(-127, 128, (64, 128)).astype(np.int8))
    p1, p2, p3 = bottleneck.pack_weights(w1, w2, w3)
    assert all(p.dtype == torch.int8 and p.is_contiguous() for p in (p1, p2, p3))
    assert p1.shape == (1, 4, 4, 32, 16) and p2.shape == (1, 18, 4, 32, 16)
    assert p3.shape == (2, 2, 4, 32, 16)
    np.testing.assert_array_equal(kernel_b_matrix(p1, 128, 64), w1.numpy())
    np.testing.assert_array_equal(kernel_b_matrix(p2, 576, 64), w2.reshape(576, 64).numpy())
    np.testing.assert_array_equal(kernel_b_matrix(p3, 64, 128), w3.numpy())
    w_q = rng.integers(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    packed = resnet_stem.pack_weights(_t(w_q))
    assert packed.dtype == torch.int8 and packed.shape == (1, 6, 4, 32, 16)
    assert packed.is_contiguous()
    x_q = rng.integers(-127, 128, (2, 16, 12, 3)).astype(np.int8)
    want = int8_ops.conv_int8(_t(x_q), _t(w_q), stride=2, padding=3).numpy()
    np.testing.assert_array_equal(resnet_stem_conv_from_packed(x_q, packed),
                                  want[..., list(resnet_stem.COLUMN_CHANNELS)])


def test_wrappers_reject_wrong_types_shapes_and_devices():
    images, w_q, w_scale, bias, s_in, s_out = _stem_case("32")
    args = [_t(images), _t(w_q), _t(w_scale), _t(bias)]
    with pytest.raises(ValueError, match="multiples of 4"):
        resnet_stem.resnet_stem(args[0][:, :30], *args[1:], s_in, s_out)
    with pytest.raises(ValueError, match="w_q"):
        resnet_stem.resnet_stem(args[0], args[1][:5], *args[2:], s_in, s_out)
    with pytest.raises(TypeError):
        resnet_stem.resnet_stem(args[0].double(), *args[1:], s_in, s_out)
    with pytest.raises(TypeError):
        resnet_stem.resnet_stem(args[0], args[1].int(), *args[2:], s_in, s_out)
    with pytest.raises(ValueError, match="cuda or cpu"):
        resnet_stem.resnet_stem(*(a.to("meta") for a in args), s_in, s_out)
    with pytest.raises(ValueError, match="on cpu"):
        resnet_stem.resnet_stem(args[0], args[1].to("meta"), *args[2:], s_in, s_out)

    ops, scales = _bottleneck_case("reference")
    ops = [_t(a) for a in ops]
    with pytest.raises(ValueError, match="bottleneck"):
        bottleneck.fused_bottleneck(ops[0][..., :16], *ops[1:], **scales)
    with pytest.raises(ValueError, match="deq3"):
        bottleneck.fused_bottleneck(*ops[:8], ops[8][:8], ops[9], **scales)
    with pytest.raises(TypeError, match="x must be int8"):
        bottleneck.fused_bottleneck(ops[0].float(), *ops[1:], **scales)
    with pytest.raises(TypeError, match="bias1"):
        bottleneck.fused_bottleneck(*ops[:3], ops[3].double(), *ops[4:], **scales)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bottleneck.fused_bottleneck(*(a.to("meta") for a in ops), **scales)
