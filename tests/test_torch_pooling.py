"""Port vs reference: the first-max 2x2/s2 pool backward.

The reference's Pallas kernel runs in interpret mode on the CPU; the port's
wrapper runs its plain version there. The reference is NHWC, the port NCHW
in shape (channels-last in memory): the conversion is done here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from object_detector_tpu.ops import pooling as ref_pooling
from object_detector_tpu_torch.kernels import pool_bwd
from object_detector_tpu_torch.ops.pooling import max_pool_2x2_fastgrad

torch.set_num_threads(2)


def _to_port(a, dtype=torch.float32):
    """(B, H, W, C) numpy -> (B, C, H, W) tensor, channels-last in memory."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _to_ref(t):
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


def _case(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        x = np.maximum(x, 0.0) * (rng.random(shape) > 0.6)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "levels":  # three values: the maximum ties at any pair of positions
        x = rng.integers(-1, 2, shape).astype(np.float32)
    b, h, w, c = shape
    g = rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32)
    return x, g


CASES = [
    ("random", (2, 8, 12, 5), "float32"),
    ("random", (2, 6, 8, 3), "bfloat16"),
    ("ties", (2, 8, 12, 5), "float32"),
    ("ties", (2, 8, 12, 5), "bfloat16"),
    ("zeros", (1, 4, 6, 3), "float32"),
    ("levels", (2, 8, 12, 5), "float32"),
    ("levels", (2, 8, 12, 5), "bfloat16"),
    ("random", (1, 38, 8, 4), "float32"),  # H/2 = 19: one row block in the reference
    ("random", (1, 30, 8, 4), "float32"),  # H/2 = 15: the reference's divisor path
    ("random", (1, 6, 10, 3), "float32"),
]


@pytest.mark.parametrize("kind,shape,dtype", CASES)
def test_reference_bit_equal_to_pallas_interpret(kind, shape, dtype):
    x, g = _case(kind, shape, seed=sum(shape))
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    gj = jnp.asarray(g).astype(jdt)
    yj = ref_pooling._pool_fwd(xj)
    want = ref_pooling._max_pool_bwd_pallas(xj, yj, gj, interpret=True)

    tdt = getattr(torch, dtype)
    xt, gt = _to_port(x, tdt), _to_port(g, tdt)
    yt = torch.nn.functional.max_pool2d(xt, 2, 2)
    np.testing.assert_array_equal(_to_ref(yt), np.asarray(yj, np.float32))
    for fn in (pool_bwd.max_pool_bwd_reference, pool_bwd.max_pool_bwd):  # the wrapper, on the CPU
        got = fn(xt, yt, gt)
        assert got.dtype == tdt and got.shape == xt.shape
        np.testing.assert_array_equal(_to_ref(got), np.asarray(want, np.float32))
    if kind == "zeros":  # every window ties: everything goes to (0, 0)
        assert torch.equal(got[:, :, 0::2, 0::2], gt) and not got[:, :, 1::2].any()


@pytest.mark.parametrize("kind,shape,dtype", CASES[:7])
def test_fastgrad_gradient_bit_equal_to_reference(kind, shape, dtype):
    x, cot = _case(kind, shape, seed=1 + sum(shape))
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    cotj = jnp.asarray(cot)
    loss = lambda pool: lambda v: jnp.sum(pool(v).astype(jnp.float32) * cotj)  # noqa: E731
    g_fast = jax.grad(loss(ref_pooling.max_pool_2x2_fastgrad))(xj)
    g_xla = jax.grad(loss(lambda v: nn.max_pool(v, (2, 2), strides=(2, 2))))(xj)

    leaf = _to_port(x, getattr(torch, dtype)).clone().requires_grad_(True)
    y = max_pool_2x2_fastgrad(leaf)
    (y.to(torch.float32) * _to_port(cot)).sum().backward()
    np.testing.assert_array_equal(
        _to_ref(y), np.asarray(ref_pooling.max_pool_2x2_fastgrad(xj), np.float32))
    np.testing.assert_array_equal(_to_ref(leaf.grad), np.asarray(g_fast, np.float32))
    np.testing.assert_array_equal(_to_ref(leaf.grad), np.asarray(g_xla, np.float32))
    # The library's own backward keeps the first maximum too.
    leaf2 = leaf.detach().clone().requires_grad_(True)
    (torch.nn.functional.max_pool2d(leaf2, 2, 2).to(torch.float32) * _to_port(cot)).sum().backward()
    assert torch.equal(leaf2.grad, leaf.grad)


def test_fastgrad_takes_any_memory_format_and_rejects_odd_sizes():
    x, cot = _case("ties", (2, 4, 6, 3), seed=2)
    grads = []
    for contiguous in (False, True):
        leaf = _to_port(x)
        leaf = (leaf.contiguous() if contiguous else leaf).clone().requires_grad_(True)
        max_pool_2x2_fastgrad(leaf).backward(_to_port(cot).contiguous())
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(ValueError):
        max_pool_2x2_fastgrad(torch.zeros(1, 3, 5, 4))
    with pytest.raises(ValueError):
        pool_bwd.max_pool_bwd(torch.zeros(1, 3, 5, 4), torch.zeros(1, 3, 2, 2), torch.zeros(1, 3, 2, 2))
    with pytest.raises(TypeError):
        pool_bwd.max_pool_bwd(torch.zeros(1, 3, 4, 4, dtype=torch.float64),
                              torch.zeros(1, 3, 2, 2, dtype=torch.float64),
                              torch.zeros(1, 3, 2, 2, dtype=torch.float64))


def test_vgg_backbone_honours_pool_grad_kernel():
    """With the flag the four 2x2 pools go through max_pool_2x2_fastgrad
    (pool3 padded to even, as at 300 px: 75 -> 38); outputs and gradients are
    those of the library's pools."""
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.models import vgg

    calls = []
    real = pool_bwd.max_pool_bwd_reference

    def counting(x, y, g):
        calls.append(tuple(x.shape))
        return real(x, y, g)

    # Channels-last, as SSDModel hands its images to the backbone.
    x = _to_port(np.random.default_rng(0).normal(size=(1, 12, 12, 3)))
    outs = {}
    for flag in (False, True):
        backbone = init_params(vgg.VGG16Backbone(pool_grad_kernel=flag), seed=3)
        leaf = x.clone().requires_grad_(True)
        pool_bwd.max_pool_bwd_reference = counting
        try:
            taps = backbone(leaf)
            sum(t.square().sum() for t in taps).backward()
        finally:
            pool_bwd.max_pool_bwd_reference = real
        outs[flag] = ([t.detach() for t in taps], leaf.grad,
                      backbone.conv1_1.weight.grad.clone())
    # 12 -> 6 -> 3 -> (padded to 4) 2 -> 1.
    assert [t.shape[2] for t in outs[True][0]] == [2, 1]
    for a, b in zip(outs[True][0], outs[False][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[True][1], outs[False][1])
    assert torch.equal(outs[True][2], outs[False][2])
    assert sorted(h for _, _, h, _ in calls) == [2, 4, 6, 12]
