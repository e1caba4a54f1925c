"""The plain versions of the port's int8 kernels against the reference: the
fused VGG stem (`kernels.stem`) against the unfused int8 chain and the
Pallas `conv12_pool_pair` in interpret mode, and the int8 L2Norm
(`kernels.l2norm`) against the jnp form and the Pallas `l2norm_requant`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.kernels import l2norm_pallas, stem_pallas
from object_detector_tpu_torch.kernels import l2norm, stem

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


def _ref_stem_chain(q1, w2, deq, b, s):
    """The reference's unfused int8 block-1 tail (tests/test_quant.py:309-324):
    conv, requant, then the int8 max pool."""
    q2 = _ref_requant(_ref_conv(q1, w2), deq, b, s)
    return np.asarray(jax.lax.reduce_window(
        q2, jnp.int8(-128), jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"
    ))


def _stem_case(kind, seed=3):
    """conv1_1 codes q1 (B, H, W, 64), w2, deq, bias, out_scale."""
    rng = np.random.default_rng(seed)
    h, w = (12, 20) if kind == "non_square" else (20, 20)
    lim = 128 if kind == "saturating" else 10
    q1 = rng.integers(-lim + 1, lim, (2, h, w, 64), dtype=np.int8)
    w2 = rng.integers(-lim + 1, lim, (3, 3, 64, 64)).astype(np.int8)
    deq = ((rng.random(64) + 0.5) * 1e-2).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    s2 = 0.021
    if kind == "saturating":  # large sums: most codes clip at +127
        deq *= 20.0
    elif kind == "negative_bias":  # everything below zero: all-zero ReLU output
        w2 = np.abs(w2).astype(np.int8)
        q1 = np.minimum(q1, 0).astype(np.int8)
        bias = -np.abs(bias) - 0.05
    return q1, w2, deq, bias, s2


@pytest.mark.parametrize("kind", ["random", "saturating", "negative_bias", "non_square"])
def test_stem_reference_bit_equal_to_unfused_chain(kind):
    q1, w2, deq, bias, s2 = _stem_case(kind)
    want = _ref_stem_chain(q1, w2, deq, bias, s2)
    args = [torch.from_numpy(a) for a in (q1, w2, deq, bias)]
    got = stem.stem_conv12_pool_reference(*args, s2).numpy()
    assert got.shape == (q1.shape[0], q1.shape[1] // 2, q1.shape[2] // 2, 64)
    np.testing.assert_array_equal(got, want)
    if kind == "saturating":
        assert (got == 127).mean() > 0.5
    if kind == "negative_bias":
        assert not got.any()
    # On CPU tensors the wrapper is the plain version and launches nothing.
    before = stem.stem_conv12_pool.launches
    np.testing.assert_array_equal(stem.stem_conv12_pool(*args, s2).numpy(), want)
    assert stem.stem_conv12_pool.launches == before


@pytest.mark.parametrize("band_rows", [20, 10])
def test_stem_reference_bit_equal_to_pallas_interpret(band_rows):
    """Against the TPU kernel in interpret mode, fed the odd-pair layout its
    producer builds (as in tests/test_quant.py:326-355)."""
    rng = np.random.default_rng(3)
    b, h, w = 2, 20, 20
    x_q = jnp.asarray(rng.integers(-9, 10, (b, h, w, 3), dtype=np.int8))
    w1 = rng.integers(-9, 10, (3, 3, 3, 64)).astype(np.int8)
    w2 = rng.integers(-9, 10, (3, 3, 64, 64)).astype(np.int8)
    deq1 = (rng.random(64).astype(np.float32) + 0.5) * 1e-2
    b1 = rng.normal(size=64).astype(np.float32) * 0.1
    deq2 = (rng.random(64).astype(np.float32) + 0.5) * 1e-2
    b2 = rng.normal(size=64).astype(np.float32) * 0.1
    s1, s2 = 0.043, 0.021

    q1 = np.array(_ref_requant(_ref_conv(x_q, w1), deq1, b1, s1))
    acc1 = stem_pallas.conv11_pair_acc(x_q, jnp.asarray(stem_pallas.pack_conv11_pair(w1)))
    q1pp = _ref_requant(acc1, np.tile(deq1, 2), np.tile(b1, 2), s1)
    want = np.asarray(stem_pallas.conv12_pool_pair(
        q1pp, jnp.asarray(stem_pallas.pack_conv12_pair(w2)), jnp.asarray(np.tile(deq2, 2)),
        jnp.asarray(np.tile(b2, 2)), jnp.float32(s2), out_width=w // 2, interpret=True,
        band_rows=band_rows,
    ))
    got = stem.stem_conv12_pool_reference(
        *(torch.from_numpy(a) for a in (q1, w2, deq2, b2)), s2
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_stem_wrapper_rejects_what_the_kernel_does_not_take():
    q1, w2, deq, bias, s2 = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in _stem_case("random"))
    with pytest.raises(ValueError):
        stem.stem_conv12_pool(q1[:, :19], w2, deq, bias, s2)  # odd H
    with pytest.raises(ValueError):
        stem.stem_conv12_pool(q1[..., :32], w2, deq, bias, s2)
    with pytest.raises(TypeError):
        stem.stem_conv12_pool(q1.float(), w2, deq, bias, s2)


def test_stem_wrapper_rejects_a_packed_operand_off_the_layout():
    """`packed` is checked before the wrapper dispatches on the device: a
    wrong shape, a wrong dtype, a strided tensor or another device raises,
    on the CPU too, where the kernel's plain version does not read it."""
    q1, w2, deq, bias, s2 = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in _stem_case("random"))
    packed = stem.pack_weights(w2)
    want = stem.stem_conv12_pool_reference(q1, w2, deq, bias, s2)
    assert torch.equal(stem.stem_conv12_pool(q1, w2, deq, bias, s2, packed=packed), want)
    bad = {"shape": packed.reshape(18, 4, 32, 16), "dtype": packed.to(torch.int16),
           "layout": packed.transpose(3, 4).contiguous().transpose(3, 4),
           "device": packed.to("meta")}
    for kind, p in bad.items():
        with pytest.raises(ValueError):
            stem.stem_conv12_pool(q1, w2, deq, bias, s2, packed=p)


def _l2norm_case(seed=0):
    rng = np.random.default_rng(seed)
    q0 = rng.integers(-127, 128, (2, 9, 9, 512), dtype=np.int8)
    q0[0, 0, 0] = 0  # all-zero pixels
    q0[1, 4, :] = 0
    gamma = (rng.random(512, dtype=np.float32) * 20.0).astype(np.float32)
    return q0, gamma, 0.137


def _assert_within_one_code(got, want):
    """The reference computes rsqrt with XLA's own rsqrt (and the TPU kernel
    folds gamma / scale), which can move a product by an ulp and flip
    round() at an exact .5 boundary: at most one code off, on a vanishing
    fraction of the elements (the TPU kernel's own contract,
    tests/test_quant.py:282-286)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("form", ["jnp", "pallas_interpret"])
def test_l2norm_reference_matches_reference_forms(form):
    q0, gamma, s0 = _l2norm_case()
    if form == "jnp":  # engine.py:1242-1248, the reference's serving default
        qf = jnp.asarray(q0).astype(jnp.float32)
        sq = jnp.sum(jnp.square(qf), axis=-1, keepdims=True)
        ln = qf * jax.lax.rsqrt(sq + 1e-12) * jnp.asarray(gamma)
        want = np.asarray(jnp.clip(jnp.round(ln / s0), -127, 127).astype(jnp.int8))
    else:
        want = np.asarray(l2norm_pallas.l2norm_requant(
            jnp.asarray(q0), jnp.asarray(gamma), s0, interpret=True
        ))
    got = l2norm.l2norm_requant_reference(torch.from_numpy(q0), torch.from_numpy(gamma), s0)
    got = got.numpy()
    assert got.dtype == np.int8 and got.shape == q0.shape
    assert not got[0, 0, 0].any() and not got[1, 4].any()
    _assert_within_one_code(got, want)
    before = l2norm.l2norm_requant.launches
    wrapped = l2norm.l2norm_requant(torch.from_numpy(q0), torch.from_numpy(gamma), s0)
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert l2norm.l2norm_requant.launches == before


def test_l2norm_wrapper_rejects_what_the_kernel_does_not_take():
    q0, gamma, s0 = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in _l2norm_case())
    with pytest.raises(ValueError):
        l2norm.l2norm_requant(q0, gamma[:256], s0)
    with pytest.raises(TypeError):
        l2norm.l2norm_requant(q0.float(), gamma, s0)
