"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with CUDA and nvcc; every test here skips on a host
without one. This file imports neither JAX nor the reference, so it also
runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from object_detector_tpu_torch.kernels import (
    bottleneck, l2norm, pool_bwd, resnet_stem, stem, stem_fp,
)
from object_detector_tpu_torch.kernels import nms as nms_kernel
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.ops.pooling import max_pool_2x2_fastgrad

# The SSD-300 bs=64 shape: 64 images x 20 classes, 512 candidates, 100 out.
ROWS, K, MAX_OUT = 1280, 512, 100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(kind, seed, rows=ROWS, k=K):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (2, rows, k))
    coords = np.concatenate([xy, np.minimum(xy + rng.uniform(0.02, 0.3, (2, rows, k)), 1.0)])
    scores = rng.uniform(0, 1, (rows, k))
    if kind == "sparse":  # about 1% of candidates above 0.01
        scores = np.where(rng.uniform(0, 1, (rows, k)) < 0.01, scores, scores * 0.005)
    elif kind == "ties":
        scores = rng.integers(0, 5, (rows, k)) / 4.0
        coords[:, :, 1::2] = coords[:, :, 0::2]
    elif kind == "negative":
        coords -= 0.4
    return coords.astype(np.float32), scores.astype(np.float32)


# (kind, rows, k): the four kinds at the SSD-300 bs=64 shape; the bs=1 paths'
# 20 and 80 rows and SSD-512 bs=64's 5120; k = 1, a k that is not a multiple
# of 32, the widest row of the warp route and one column either side of it
# (511 and 512 in registers, 513 on the block route), the block route at 48 KB
# of dynamic shared memory (2048), and the widest row the wrapper takes.
NMS_CASES = [("dense", ROWS, K), ("sparse", ROWS, K), ("ties", ROWS, K), ("negative", ROWS, K),
             ("dense", 20, K), ("dense", 80, K), ("dense", 5120, K),
             ("dense", 64, 1), ("ties", 64, 100), ("dense", 64, nms_kernel.WARP_ROUTE_MAX_K - 1),
             ("ties", 64, nms_kernel.WARP_ROUTE_MAX_K),
             ("dense", 64, nms_kernel.WARP_ROUTE_MAX_K + 1), ("dense", 16, 2048),
             ("dense", 8, nms_kernel.MAX_K)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,k", NMS_CASES)
def test_nms_kernel_bit_equal_to_plain_version(cuda_device, kind, rows, k):
    coords, scores = (torch.from_numpy(a).to(cuda_device) for a in _rows(kind, 11, rows, k))
    kw = dict(max_out=min(MAX_OUT, k), iou_threshold=0.45, score_threshold=0.01)
    before = nms_kernel.nms_rows.launches
    got = nms_kernel.nms_rows(coords, scores, **kw)
    torch.cuda.synchronize()
    assert nms_kernel.nms_rows.launches == before + 1
    want = nms_kernel.nms_rows_reference(coords, scores, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert nms_kernel.warp_route_max_k() == nms_kernel.WARP_ROUTE_MAX_K


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,k,iou", [
    ("dense", 1280, 512, 0.45), ("sparse", 80, 512, 0.5), ("ties", 64, 128, 0.45),
    ("dense", 256, 256, 0.1434952540480179), ("dense", 16, 1, 0.45), ("dense", 16, 2048, 0.45),
])
def test_nms_bf16_kernel_bit_equal_to_plain_version(cuda_device, kind, rows, k, iou):
    """The bfloat16-coordinate instantiation on both routes (k = 2048: the
    block route) against the plain version's bfloat16 arithmetic on the
    card, at a threshold whose bfloat16 t / (1 + t) rounds through float32."""
    coords, scores = (torch.from_numpy(a).to(cuda_device) for a in _rows(kind, 12, rows, k))
    coords = coords.to(torch.bfloat16)
    kw = dict(max_out=min(MAX_OUT, k), iou_threshold=iou, score_threshold=0.01)
    before = (nms_kernel.nms_rows.launches, nms_kernel.nms_rows.bf16.launches)
    got = nms_kernel.nms_rows(coords, scores, **kw)
    torch.cuda.synchronize()
    assert (nms_kernel.nms_rows.launches, nms_kernel.nms_rows.bf16.launches) == (
        before[0], before[1] + 1)
    want = nms_kernel.nms_rows_reference(coords, scores, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_nms_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    coords, scores = (torch.from_numpy(a).to(cuda_device) for a in _rows("dense", seed=1))
    kw = dict(max_out=MAX_OUT, iou_threshold=0.45, score_threshold=0.01)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(coords.double(), scores.double(), **kw)
    with pytest.raises(ValueError):
        nms_kernel.nms_rows(coords[:, :, ::2], scores[:, ::2], **kw)
    with pytest.raises(ValueError):
        nms_kernel.nms_rows(coords, scores, **{**kw, "max_out": K + 1})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "saturating", "negative_bias", "ragged_tile",
                                  "full_width_bs1", "ties"])
def test_stem_kernel_bit_equal_to_plain_version(cuda_device, kind):
    """The fused conv1_2 + pool against its plain version, with the packed
    operand made by the wrapper and passed in. "ragged_tile": a pooled size
    that is not a multiple of the kernel's 8 x 8 tile; "full_width_bs1":
    one SSD-300 image's conv1_1 codes; "ties": deq = s / 8, so that many
    quotients y / s lie at or within an ulp of a half-integer, where a
    reciprocal multiply alone would round wrongly."""
    rng = np.random.default_rng(5)
    b, h, w = {"ragged_tile": (3, 22, 36), "full_width_bs1": (1, 300, 300)}.get(kind, (3, 32, 32))
    lim = {"saturating": 128, "ties": 2}.get(kind, 10)
    q1 = rng.integers(-lim + 1, lim, (b, h, w, 64), dtype=np.int8)
    w2 = rng.integers(-lim + 1, lim, (3, 3, 64, 64)).astype(np.int8)
    deq = ((rng.random(64) + 0.5) * (0.2 if kind == "saturating" else 1e-2)).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    if kind == "negative_bias":
        bias = -np.abs(bias) - 100.0
    elif kind == "ties":
        deq, bias = np.full(64, np.float32(0.021) / 8, np.float32), np.zeros(64, np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (q1, w2, deq, bias)]
    before = stem.stem_conv12_pool.launches
    got = stem.stem_conv12_pool(*args, 0.021)
    torch.cuda.synchronize()
    assert stem.stem_conv12_pool.launches == before + 1
    want = stem.stem_conv12_pool_reference(*args, 0.021)
    assert got.shape == (b, h // 2, w // 2, 64) and torch.equal(got, want), \
        int((got != want).sum())
    packed = stem.pack_weights(args[1])
    assert torch.equal(stem.stem_conv12_pool(*args, 0.021, packed=packed), want)
    if kind != "negative_bias":
        assert 0.05 < float((want > 0).float().mean())


def _stem_fp_case(kind, device, seed=12):
    """x_q, w1, deq1, bias1, s1, w2, deq2, bias2, s2 for all of VGG block 1
    on ``device``. "large_bias1": rq(relu(bias1)) well above 0, so a conv1_1
    halo pixel outside the image that was not zeroed would show;
    "ragged_tile": a pooled size (11 x 18) that is not a multiple of the
    kernel's 8 x 8 tile; "full_width": one SSD-300 image; "ties": deq = s / 2
    and s / 8, so that many quotients y / s lie at or within an ulp of a
    half-integer, where a reciprocal multiply alone would round wrongly."""
    b, h, w = {"ragged_tile": (3, 22, 36), "full_width": (1, 300, 300),
               "bs1": (1, 32, 32)}.get(kind, (2, 32, 32))
    rng = np.random.default_rng(seed)
    lim = {"saturating": 128, "ties": 2}.get(kind, 10)
    x_q = rng.integers(-lim + 1, lim, (b, h, w, 3), dtype=np.int8)
    if kind == "zero_input":
        x_q[:] = 0
    w1 = rng.integers(-lim + 1, lim, (3, 3, 3, 64)).astype(np.int8)
    w2 = rng.integers(-lim + 1, lim, (3, 3, 64, 64)).astype(np.int8)
    deq1 = ((rng.random(64) + 0.5) * (0.2 if kind == "saturating" else 1e-2)).astype(np.float32)
    deq2 = ((rng.random(64) + 0.5) * (0.2 if kind == "saturating" else 1e-2)).astype(np.float32)
    bias1 = (rng.normal(size=64) * 0.1).astype(np.float32)
    bias2 = (rng.normal(size=64) * 0.1).astype(np.float32)
    if kind == "ties":  # quotients at or within an ulp of half-integers
        deq1 = np.full(64, np.float32(0.043) / 2, np.float32)
        deq2 = np.full(64, np.float32(0.021) / 8, np.float32)
        bias1, bias2 = np.zeros(64, np.float32), np.zeros(64, np.float32)
    elif kind == "negative_bias":
        bias1, bias2 = -np.abs(bias1) - 100.0, -np.abs(bias2) - 100.0
    elif kind == "large_bias1":
        bias1 = np.abs(bias1) + 3.0
    t = [torch.from_numpy(a).to(device) for a in (x_q, w1, deq1, bias1, w2, deq2, bias2)]
    return t[0], t[1], t[2], t[3], 0.043, t[4], t[5], t[6], 0.021


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "saturating", "negative_bias", "zero_input",
                                  "large_bias1", "ragged_tile", "bs1", "full_width", "ties"])
def test_stem_fp_kernel_bit_equal_to_plain_version(cuda_device, kind):
    """All of VGG block 1 in one kernel against its plain version."""
    args = _stem_fp_case(kind, cuda_device)
    before = stem_fp.stem_fused_producer.launches
    got = stem_fp.stem_fused_producer(*args)
    torch.cuda.synchronize()
    assert stem_fp.stem_fused_producer.launches == before + 1
    want = stem_fp.stem_fused_producer_reference(*args)
    b, h, w, _ = args[0].shape
    assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == torch.int8
    assert torch.equal(got, want), int((got != want).sum())
    packed = stem_fp.pack_weights(args[1], args[5])
    assert torch.equal(stem_fp.stem_fused_producer(*args, packed=packed), want)
    if kind in ("negative_bias", "zero_input"):
        assert kind == "zero_input" or not want.any()
    else:
        assert 0.05 < float((want > 0).float().mean())


@pytest.mark.cuda
def test_stem_fp_wrapper_rejects_a_strided_input(cuda_device):
    args = _stem_fp_case("random", cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        stem_fp.stem_fused_producer(args[0].transpose(1, 2), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 1])
def test_l2norm_kernel_bit_equal_to_plain_version(cuda_device, batch):
    """batch 1: 1444 pixels, not a multiple of the kernel's 8 pixels a
    block, so the last block is partial (the bs=1 serving path's tap)."""
    rng = np.random.default_rng(6)
    q0 = rng.integers(-127, 128, (batch, 38, 38, 512), dtype=np.int8)
    q0[0, :3] = 0  # all-zero pixels
    gamma = (rng.random(512) * 20.0).astype(np.float32)
    q0_t, gamma_t = torch.from_numpy(q0).to(cuda_device), torch.from_numpy(gamma).to(cuda_device)
    before = l2norm.l2norm_requant.launches
    got = l2norm.l2norm_requant(q0_t, gamma_t, 0.137)
    torch.cuda.synchronize()
    assert l2norm.l2norm_requant.launches == before + 1
    assert torch.equal(got, l2norm.l2norm_requant_reference(q0_t, gamma_t, 0.137))
    assert not got[0, :3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 528, 1040, 2048])
def test_l2norm_kernel_at_every_chunk_count(cuda_device, c):
    """C = 16 (lane 0 alone holds a chunk), and one to four 512-channel
    chunks a lane, the last ones partial at 528 and 1040."""
    rng = np.random.default_rng(c)
    q0 = rng.integers(-127, 128, (2, 7, 9, c), dtype=np.int8)
    q0[1, 3] = 0
    gamma = (rng.normal(size=c) * 10.0).astype(np.float32)
    q0_t, gamma_t = torch.from_numpy(q0).to(cuda_device), torch.from_numpy(gamma).to(cuda_device)
    got = l2norm.l2norm_requant(q0_t, gamma_t, 0.093)
    torch.cuda.synchronize()
    assert torch.equal(got, l2norm.l2norm_requant_reference(q0_t, gamma_t, 0.093))
    assert not got[1, 3].any() and got.any()


@pytest.mark.cuda
def test_l2norm_kernel_on_pixels_off_the_grid(cuda_device):
    """29,391 pixels: several rounds of the persistent grid's warps, the
    last one partial."""
    rng = np.random.default_rng(9)
    q0 = rng.integers(-127, 128, (3, 101, 97, 512), dtype=np.int8)
    q0[2, -1, -5:] = 0
    gamma = (rng.random(512) * 20.0).astype(np.float32)
    q0_t, gamma_t = torch.from_numpy(q0).to(cuda_device), torch.from_numpy(gamma).to(cuda_device)
    got = l2norm.l2norm_requant(q0_t, gamma_t, 0.137)
    torch.cuda.synchronize()
    assert torch.equal(got, l2norm.l2norm_requant_reference(q0_t, gamma_t, 0.137))
    assert not got[2, -1, -5:].any()


def _l2norm_ties(s, c, device):
    """(q0, gamma) with C = c whose values y sit at (n + 1/2) * s for n from
    -140 to 139, one ulp either side, and at n * s (1120 targets, taken c at
    a time into the batch): pixel i holds +1, pixel c + i holds -1 at
    channel i, so y = +-gamma exactly (1 / sqrt(1 + 1e-12) rounds to 1),
    then 16 zero pixels."""
    n = np.arange(-140, 140, dtype=np.float32)
    half = (n + np.float32(0.5)) * np.float32(s)
    targets = np.concatenate([half, np.nextafter(half, -np.inf), np.nextafter(half, np.inf),
                              n * np.float32(s)]).astype(np.float32)
    groups = -(-targets.size // c)
    gamma = np.resize(targets, (groups, c)).astype(np.float32)
    q0 = np.zeros((2 * c + 16, c), np.int8)
    q0[np.arange(c), np.arange(c)] = 1
    q0[c + np.arange(c), np.arange(c)] = -1
    return ([torch.from_numpy(q0.reshape(1, 1, -1, c)).to(device)] * groups,
            [torch.from_numpy(g).to(device) for g in gamma])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 1120])
def test_l2norm_kernel_on_ties(cuda_device, c):
    """Quotients y / s at half-integers and one ulp either side, signed and
    through the clip at +-127: the kernel's reciprocal-then-divide rule
    gives the plain version's codes (a true divide)."""
    for s in (0.02, 0.0173, 1.0 / 3.0, 0.5, 3.7e-3):
        for q0, gamma in zip(*_l2norm_ties(s, c, cuda_device)):
            got = l2norm.l2norm_requant(q0, gamma, s)
            torch.cuda.synchronize()
            want = l2norm.l2norm_requant_reference(q0, gamma, s)
            assert torch.equal(got, want), (s, int((got != want).sum()))
            assert not got[..., -16:, :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (90000, 27, 64),  # conv1_1 at bs=1: cuBLASLt refused inner width 32 at these rows
    (90001, 27, 64),
    (40, 32, 64),
    (1, 4608, 84),  # a head conv on the 1 x 1 level at bs=1: one row, 84 columns
    (17, 4608, 126),
    (361, 1024, 1024),
])
def test_int_matmul_takes_the_shapes_cublaslt_refuses(cuda_device, m, k, n):
    """int_matmul pads around cuBLASLt's int8 GEMM limits (rows, widths,
    inner width 32) and equals the CPU's exact product."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (1, 1, k, n), dtype=np.int8))
    got = int8_ops.int_matmul(a.to(cuda_device), int8_ops.gemm_operand(w.to(cuda_device)), n)
    assert got.shape == (m, n) and torch.equal(got.cpu(), torch._int_mm(a, w.reshape(k, n)))


def _pool_case(kind, shape, dtype, device, seed=0):
    """(x, y, g) channels-last on the card; shape is the reference's
    (B, H, W, C)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "ties":  # post-ReLU, most windows all zero
        x = np.maximum(x, 0.0) * (rng.random(shape) > 0.6)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "negative_zero":
        x = np.where(rng.random(shape) > 0.5, 0.0, -0.0).astype(np.float32)
    elif kind == "levels":  # three values: the maximum ties at any pair of positions
        x = rng.integers(-1, 2, shape).astype(np.float32)
    x = torch.from_numpy(x).to(device=device, dtype=dtype).permute(0, 3, 1, 2)
    g = torch.from_numpy(rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32))
    g = g.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
    return x, torch.nn.functional.max_pool2d(x, 2, 2), g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,shape", [
    ("random", (2, 38, 38, 512)),
    ("ties", (2, 76, 76, 256)),
    ("zeros", (1, 150, 150, 128)),
    ("negative_zero", (1, 8, 8, 64)),
    ("levels", (2, 38, 38, 512)),
    ("levels", (1, 6, 10, 3)),
    ("random", (1, 6, 10, 3)),  # channels not a multiple of the 16-byte group
    ("ties", (3, 2, 2, 20)),
])
def test_pool_bwd_kernel_bit_equal_to_plain_version(cuda_device, kind, shape, dtype):
    x, y, g = _pool_case(kind, shape, dtype, cuda_device)
    assert x.is_contiguous(memory_format=torch.channels_last)
    before = pool_bwd.max_pool_bwd.launches
    got = pool_bwd.max_pool_bwd(x, y, g)
    torch.cuda.synchronize()
    assert pool_bwd.max_pool_bwd.launches == before + 1
    want = pool_bwd.max_pool_bwd_reference(x, y, g)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    if kind == "zeros":  # every window ties: everything goes to (0, 0)
        assert torch.equal(got[:, :, 0::2, 0::2], g) and not got[:, :, 1::2].any()


@pytest.mark.cuda
def test_pool_bwd_takes_a_cotangent_in_another_format_and_rejects_a_strided_x(cuda_device):
    x, y, g = _pool_case("ties", (2, 8, 12, 16), torch.bfloat16, cuda_device)
    want = pool_bwd.max_pool_bwd_reference(x, y, g)
    assert torch.equal(pool_bwd.max_pool_bwd(x, y, g.contiguous()), want)  # g laid out NCHW
    with pytest.raises(ValueError, match="channels-last"):
        pool_bwd.max_pool_bwd(x.contiguous(), y, g)
    with pytest.raises(ValueError, match="even"):
        pool_bwd.max_pool_bwd(x[:, :, :7], y, g)
    with pytest.raises(TypeError):
        pool_bwd.max_pool_bwd(x.half(), y.half(), g.half())


@pytest.mark.cuda
def test_fastgrad_pool_gradient_through_the_kernel(cuda_device):
    """autograd through max_pool_2x2_fastgrad launches the kernel once and
    gives the plain version's gradient, for an NCHW-contiguous input too."""
    x, _, g = _pool_case("ties", (2, 8, 12, 16), torch.float32, cuda_device)
    for inp in (x, x.contiguous()):
        leaf = inp.clone().requires_grad_(True)
        before = pool_bwd.max_pool_bwd.launches
        y = max_pool_2x2_fastgrad(leaf)
        y.backward(g)
        assert pool_bwd.max_pool_bwd.launches == before + 1
        want = pool_bwd.max_pool_bwd_reference(x, y.detach(), g)
        assert torch.equal(leaf.grad, want)


def _resnet_stem_case(kind, device, seed=8):
    """images, w_q, deq, bias, in_scale, out_scale on ``device``. "edge":
    saturated inputs and extreme biases, which drive the clip and round
    boundaries and the padding rows into play; "ragged_tile": a pooled size
    (10 x 13) that the kernel's 8 x 16 tile does not divide; "ties_input":
    pixels at (n + 1/2) * in_scale and one ulp either side, where the
    input quantize's product by the reciprocal alone would round wrongly;
    "ties_requant": deq = out_scale / 2 and zero bias on codes and weights in
    {-1, 0, 1}, so that y * (1 / out_scale) lies at or next to
    half-integers; "bs1_full_width": one SSD-512 image."""
    rng = np.random.default_rng(seed)
    b, h, w = {"random": (2, 64, 64), "edge": (1, 32, 32), "ragged_tile": (3, 40, 52),
               "full_width": (2, 512, 512), "ties_input": (2, 64, 72),
               "ties_requant": (2, 48, 64), "bs1_full_width": (1, 512, 512)}[kind]
    if kind == "edge":
        images = rng.choice([-2.6, -0.02, 0.0, 0.02, 2.6], (b, h, w, 3))
        w_q = rng.choice([-127, -1, 0, 1, 127], (7, 7, 3, 64))
        w_scale, bias, scales = np.full(64, 0.01), rng.normal(0, 3.0, 64), (0.02, 0.05)
    elif kind == "ties_input":
        s_in = np.float32(0.0173)
        half = (rng.integers(-135, 135, (b, h, w, 3)) + np.float32(0.5)) * s_in
        images = np.choose(rng.integers(0, 3, half.shape),
                           [half, np.nextafter(half, np.float32(-np.inf)),
                            np.nextafter(half, np.float32(np.inf))])
        w_q = rng.integers(-127, 128, (7, 7, 3, 64))
        w_scale, bias, scales = rng.uniform(0.005, 0.02, 64), rng.normal(0, 0.5, 64), (0.0173, 0.4)
    elif kind == "ties_requant":
        images = rng.integers(-1, 2, (b, h, w, 3)) * 0.02
        w_q = rng.integers(-1, 2, (7, 7, 3, 64))
        scales = (0.02, 0.37)
        w_scale = np.full(64, np.float32(scales[1]) / 2 / np.float32(scales[0]))
        bias = np.zeros(64)
    else:
        images = rng.normal(0, 1.2, (b, h, w, 3))
        w_q = rng.integers(-127, 128, (7, 7, 3, 64))
        w_scale, bias, scales = rng.uniform(0.005, 0.02, 64), rng.normal(0, 0.5, 64), (0.02, 0.07)
    deq = np.float32(scales[0]) * w_scale.astype(np.float32)
    if kind == "ties_requant":
        deq = np.full(64, np.float32(scales[1]) / 2, np.float32)
    tensors = [torch.from_numpy(a).to(device) for a in (
        images.astype(np.float32), w_q.astype(np.int8), deq, bias.astype(np.float32))]
    return (*tensors, *scales)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "edge", "ragged_tile", "full_width", "ties_input",
                                  "ties_requant", "bs1_full_width"])
def test_resnet_stem_kernel_bit_equal_to_plain_version(cuda_device, kind):
    args = _resnet_stem_case(kind, cuda_device)
    before = resnet_stem.resnet_stem.launches
    got = resnet_stem.resnet_stem(*args)
    torch.cuda.synchronize()
    assert resnet_stem.resnet_stem.launches == before + 1
    want = resnet_stem.resnet_stem_reference(*args)
    b, h, w, _ = args[0].shape
    assert got.shape == (b, h // 4, w // 4, 64) and got.dtype == torch.int8
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(resnet_stem.resnet_stem(
        *args, packed=resnet_stem.pack_weights(args[1])), want)
    assert 0.05 < float((want > 0).float().mean())
    if kind != "ties_requant":  # its codes stay below 20
        assert int(want.max()) == 127


def _bottleneck_case(kind, device, seed=9):
    """The fused bottleneck's operands on ``device``. The four shapes of
    ResNet-50 at 512 px; "ragged": H and W that the kernel's 8 x 16 tile does
    not divide; "large_b1": a bias that makes rq(relu(b1)) well above zero,
    so a halo pixel outside the image that was not zeroed would show;
    "narrow": the narrowest widths the kernel takes (one pass of 64
    channels, one chunk); "wide_odd": widths that are not powers of two,
    whose chunks are 64 channels (C) and 64 of 320 (Cm); "ties": deq = s / 2
    and small codes, so that many quotients y / s lie at or within an ulp of
    a half-integer."""
    b, h, w, c, cm = {
        "stage1": (2, 128, 128, 256, 64), "stage2": (2, 64, 64, 512, 128),
        "stage3": (2, 32, 32, 1024, 256), "stage4": (2, 16, 16, 2048, 512),
        "ragged": (2, 13, 19, 256, 64), "large_b1": (2, 12, 20, 128, 64),
        "zero_input": (1, 16, 16, 256, 64), "narrow": (2, 12, 16, 64, 64),
        "wide_odd": (1, 9, 10, 448, 320), "ties": (2, 16, 16, 256, 64),
    }[kind]
    rng = np.random.default_rng(seed)
    xlim, lim = (4, 1) if kind == "ties" else (128, 40)
    x = rng.integers(-xlim + 1, xlim, (b, h, w, c), dtype=np.int8)
    if kind == "zero_input":
        x[:] = 0
    w1 = rng.integers(-lim, lim + 1, (c, cm)).astype(np.int8)
    w2 = rng.integers(-lim, lim + 1, (3, 3, cm, cm)).astype(np.int8)
    w3 = rng.integers(-lim, lim + 1, (cm, c)).astype(np.int8)
    # Scales that keep the three outputs spread over the codes.
    deq = lambda k, n: ((rng.random(n) + 0.5) * 40.0 / (lim * 127 * np.sqrt(k))).astype(np.float32)  # noqa: E731
    bias = lambda n, shift=0.0: (rng.normal(size=n) * 5.0 + shift).astype(np.float32)  # noqa: E731
    ops = (x, w1, deq(c, cm), bias(cm, 60.0 if kind == "large_b1" else 0.0),
           w2, deq(9 * cm, cm), bias(cm), w3, deq(cm, c), bias(c))
    scales = dict(s1=0.43, s2=0.51, s3=0.37, resid_scale=0.29)
    if kind == "ties":  # y / s at or within an ulp of half-integers
        half = lambda s, n: np.full(n, np.float32(s) / 2, np.float32)  # noqa: E731
        zero = lambda n: np.zeros(n, np.float32)  # noqa: E731
        ops = (x, w1, half(0.43, cm), zero(cm), w2, half(0.51, cm), zero(cm), w3,
               half(0.37, c), zero(c))
        scales["resid_scale"] = float(np.float32(0.37) / 2)
    return [torch.from_numpy(a).to(device) for a in ops], scales


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stage1", "stage2", "stage3", "stage4", "ragged", "large_b1",
                                  "zero_input", "narrow", "wide_odd", "ties"])
def test_bottleneck_kernel_bit_equal_to_plain_version(cuda_device, kind):
    ops, scales = _bottleneck_case(kind, cuda_device)
    before = bottleneck.fused_bottleneck.launches
    got = bottleneck.fused_bottleneck(*ops, **scales)
    torch.cuda.synchronize()
    assert bottleneck.fused_bottleneck.launches == before + 1
    want = bottleneck.fused_bottleneck_reference(*ops, **scales)
    assert got.shape == ops[0].shape and got.dtype == torch.int8
    assert torch.equal(got, want), int((got != want).sum())
    packed = bottleneck.pack_weights(ops[1], ops[4], ops[7])
    assert torch.equal(bottleneck.fused_bottleneck(*ops, **scales, packed=packed), want)
    share = float((want > 0).float().mean())
    assert 0.05 < share < 0.95 or kind == "large_b1", share


@pytest.mark.cuda
def test_bottleneck_and_resnet_stem_reject_what_the_kernels_do_not_take(cuda_device):
    ops, scales = _bottleneck_case("narrow", cuda_device)
    narrow = [ops[0][..., :32].contiguous(), ops[1][:32, :32].contiguous(), ops[2][:32],
              ops[3][:32], ops[4][:, :, :32, :32].contiguous(), ops[5][:32], ops[6][:32],
              ops[7][:32, :32].contiguous(), ops[8][:32], ops[9][:32]]
    with pytest.raises(ValueError, match="multiples of 64"):
        bottleneck.fused_bottleneck(*narrow, **scales)  # C=32, Cm=32
    cm = bottleneck.MAX_MID_CHANNELS + 64  # past what shared memory holds
    wide = [ops[0], torch.zeros((64, cm), dtype=torch.int8, device=cuda_device),
            ops[2].new_ones(cm), ops[3].new_zeros(cm),
            torch.zeros((3, 3, cm, cm), dtype=torch.int8, device=cuda_device),
            ops[5].new_ones(cm), ops[6].new_zeros(cm),
            torch.zeros((cm, 64), dtype=torch.int8, device=cuda_device), ops[8], ops[9]]
    with pytest.raises(ValueError, match=f"up to {bottleneck.MAX_MID_CHANNELS}"):
        bottleneck.fused_bottleneck(*wide, **scales)
    with pytest.raises(ValueError, match="contiguous"):
        bottleneck.fused_bottleneck(ops[0].transpose(1, 2), *ops[1:], **scales)
    args = _resnet_stem_case("random", cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        resnet_stem.resnet_stem(args[0].transpose(1, 2), *args[1:])
    shifted = torch.empty(args[0].numel() + 1, device=cuda_device)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        resnet_stem.resnet_stem(shifted.copy_(args[0]), *args[1:])
