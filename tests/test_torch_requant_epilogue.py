"""The int8 engine's one-pass epilogue (`kernels.requant_epilogue`): on the
CPU the wrapper runs its plain version, which is the engine's former eager
chain, and raises on what it does not take; on the card (``cuda``-marked)
the CUDA kernel is bit-equal to the plain version at the main path's own
shapes, and the int8 forwards of SSD-300 and RetinaNet equal the same
forwards with the plain version swapped in, with one launch an epilogue and
nothing else under ``odt.int8.epilogue``.

This file imports neither JAX nor the reference, so on the card it runs as

    python -m pytest tests/test_torch_requant_epilogue.py --noconftest -q
"""

import functools
import json

import numpy as np
import pytest
import torch

from object_detector_tpu_torch.kernels import requant_epilogue as ep
from object_detector_tpu_torch.ops import int8 as int8_ops

# Launches of one int8 forward at full width, its 3x3 stride-1 steps being
# the one-kernel conv's (`kernels.conv3x3`): SSD-300 with VGG block 1 as one
# kernel (fc7 and the extras' 4 1x1s and 2 stride-2 convs) and RetinaNet (15
# convs of the ResNet trunk outside its fused kernels, the FPN's 3 laterals,
# P6 and P7).
SSD300_EPILOGUES, RETINANET_EPILOGUES = 7, 20


def _case(shape, seed, big=False, device="cpu"):
    """acc, deq, bias and an out_scale at which the largest |y| / out_scale
    is 200: the codes reach both clips."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    acc = torch.randint(-(1 << 20), 1 << 20, shape, generator=g, dtype=torch.int32,
                        device=device)
    if big:  # past 2^22, beyond the exponent trick's exact range of int32 -> float32
        acc = acc * 37
    deq = (torch.rand(c, generator=g, device=device) + 0.5) * 1e-4
    bias = torch.randn(c, generator=g, device=device) * 0.1
    y = acc.to(torch.float32) * deq + bias
    return acc, deq, bias, float(np.float32(y.abs().max().item() / 200))


def _ties(shape, device="cpu"):
    """deq = 2^-4, bias 0, out_scale 2^-3: accumulators -300 .. 300 over
    and over, so every odd one lies at a half-integer quotient, on both
    sides of 0 and past both clips."""
    c = shape[-1]
    acc = (torch.arange(int(np.prod(shape)), dtype=torch.int32) % 601 - 300).reshape(shape)
    return (acc.to(device), torch.full((c,), 0.0625, device=device),
            torch.zeros(c, device=device), 0.125)


def _today_chain(acc, deq, bias, s, relu=False, resid=None, rs=None, coarse=None):
    """The engine's eager chain as it stood: ``dequant`` then ``quantize``
    by the 0-dim device scale where a residual joins, else ``_conv_f32``
    (mul, add), the upsample-add and ``_requant`` (the same quantize)."""
    if resid is not None:
        y = int8_ops.dequant(acc, deq, bias, resid, int8_ops.scale_tensor(rs, acc.device))
    else:
        y = torch.mul(acc, deq).add_(bias)
    if coarse is not None:
        y = y + ep.fpn_upsample2x(coarse)
    return int8_ops.quantize(y, int8_ops.scale_tensor(s, acc.device), 0.0 if relu else -127.0)


def _numpy_codes(acc, deq, bias, s, low):
    """An independent oracle: float32 at every step, a true divide, rint."""
    y = acc.numpy().astype(np.float32) * deq.numpy() + bias.numpy()
    q = np.rint(y / np.float32(s))
    return np.clip(q, low, 127).astype(np.int8)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["random", "ties", "big"])
def test_cpu_requant_is_the_former_chain(kind, relu):
    if kind == "ties":
        acc, deq, bias, s = _ties((2, 5, 6, 10))
    else:
        acc, deq, bias, s = _case((2, 5, 6, 24), seed=1, big=kind == "big")
    before = ep.epilogue.launches
    got = ep.epilogue(acc, deq, bias, s, relu).codes
    assert ep.epilogue.launches == before  # the plain version ran
    assert got.dtype == torch.int8 and got.shape == acc.shape
    assert torch.equal(got, _today_chain(acc, deq, bias, s, relu))
    assert np.array_equal(got.numpy(), _numpy_codes(acc, deq, bias, s, 0 if relu else -127))
    if kind == "ties":  # half to even: -1.5 -> -2, -0.5 -> 0, 0.5 -> 0, 1.5 -> 2
        code = dict(zip(acc.flatten().tolist(), got.flatten().tolist()))
        q = [code[a] for a in (-5, -3, -2, -1, 0, 1, 2, 3, 5)]
        assert q == ([0, 0, 0, 0, 0, 0, 1, 2, 2] if relu else [-2, -2, -1, 0, 0, 0, 1, 2, 2])
    assert bool((got == 127).any()) and bool((got == (0 if relu else -127)).any())


@pytest.mark.parametrize("relu", [False, True])
def test_cpu_residual_requant_is_requant_epilogue(relu):
    acc, deq, bias, s = _case((2, 4, 4, 16), seed=2)
    resid = torch.from_numpy(np.random.default_rng(3).integers(-127, 128, acc.shape,
                                                                dtype=np.int8))
    got = ep.epilogue(acc, deq, bias, s, relu, resid, 0.037).codes
    assert torch.equal(got, _today_chain(acc, deq, bias, s, relu, resid, 0.037))
    assert not torch.equal(got, ep.epilogue(acc, deq, bias, s, relu).codes)


def test_cpu_lateral_with_upsampled_addend_and_sum():
    """``fpn/lateral4``: the coarser float32 sum upsampled and added, the sum
    kept for the next level, and the codes."""
    acc, deq, bias, s = _case((2, 6, 4, 8), seed=4)
    coarse = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 2, 8)).astype(
        np.float32))
    out = ep.epilogue(acc, deq, bias, s, addend=coarse, sum_dtype=torch.float32)
    want_sum = torch.mul(acc, deq).add_(bias) + ep.fpn_upsample2x(coarse)
    assert out.sum.dtype == torch.float32 and torch.equal(out.sum, want_sum)
    assert torch.equal(out.codes, _today_chain(acc, deq, bias, s, coarse=coarse))
    assert out.relu_codes is None
    assert torch.equal(ep.epilogue(acc, deq, bias, s, addend=coarse).codes, out.codes)


def test_cpu_p6_codes_and_their_relu():
    acc, deq, bias, s = _case((2, 2, 2, 8), seed=6)
    out = ep.epilogue(acc, deq, bias, s, relu_codes=True)
    assert torch.equal(out.codes, _today_chain(acc, deq, bias, s))
    assert torch.equal(out.relu_codes, torch.clamp_min(out.codes, 0)) and out.sum is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dequant_is_the_heads_dequant(dtype):
    acc, deq, bias, _ = _case((2, 3, 3, 126), seed=7)
    got = ep.epilogue(acc, deq, bias, sum_dtype=dtype).sum
    want = acc.to(torch.float32).mul_(deq).add_(bias).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_cpu_wrapper_raises_on_what_it_does_not_take():
    acc, deq, bias, s = _case((1, 4, 4, 8), seed=8)
    with pytest.raises(TypeError):
        ep.epilogue(acc.float(), deq, bias, s)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq.double(), bias, s)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq[:4], bias, s)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias, s, resid=acc.to(torch.int32), resid_scale=0.1)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias, s, resid=acc.to(torch.int8))  # no resid_scale
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias, s, addend=torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias)  # neither codes nor a sum
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias, sum_dtype=torch.float16)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq, bias, sum_dtype=torch.float32, relu_codes=True)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq.to("meta"), bias, s)
    with pytest.raises(ValueError):
        ep.epilogue(acc.to("meta"), deq.to("meta"), bias.to("meta"), s)


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _padded(acc, rows_to=32, cols_to=8):
    """``acc`` as `int_matmul` returns it on the card: the rows of a result
    padded to 32 rows and 8 columns, sliced back (a view, rows strided)."""
    c = acc.shape[-1]
    flat = acc.reshape(-1, c)
    m = flat.shape[0]
    big = torch.full((-(-m // rows_to) * rows_to, -(-c // cols_to) * cols_to), 12345,
                     dtype=torch.int32, device=acc.device)
    big[:m, :c] = flat
    return big[:m, :c].reshape(acc.shape)


# (name, acc shape, kwargs): the main path's own shapes. SSD-300 bs=64: VGG
# conv2_2, conv3_3 (75 x 75), conv4_3, fc7, the extras' last, the heads' cls
# (4 and 6 anchors: 84, 126 columns) and box widths at 38 and 1; RetinaNet
# bs=64 at 512 px: the projection blocks' conv3 (residual) and proj (no
# ReLU), the laterals with their upsampled addends, a smooth, P6, P7, a
# head conv, the out convs (720, 36 columns); bs=1 of each kind.
KERNEL_CASES = [
    ("vgg_conv2_2", (64, 150, 150, 128), dict(relu=True)),
    ("vgg_conv3_3", (64, 75, 75, 256), dict(relu=True)),
    ("vgg_conv4_3", (64, 38, 38, 512), dict(relu=True)),
    ("vgg_fc7", (64, 19, 19, 1024), dict(relu=True)),
    ("extras_conv11_2", (64, 1, 1, 256), dict(relu=True)),
    ("ssd_cls_38", (64, 38, 38, 84), dict(sum_dtype=torch.float32)),
    ("ssd_cls_19_bf16", (64, 19, 19, 126), dict(sum_dtype=torch.bfloat16)),
    ("ssd_cls_19", (64, 19, 19, 126), dict(sum_dtype=torch.float32)),
    ("ssd_box_38", (64, 38, 38, 16), dict(sum_dtype=torch.float32)),
    ("ssd_box_1", (64, 1, 1, 24), dict(sum_dtype=torch.float32)),
    ("proj_stage1", (64, 128, 128, 256), dict(relu=False)),
    ("conv3_stage1", (64, 128, 128, 256), dict(relu=True, resid=True)),
    ("conv3_stage3", (64, 32, 32, 1024), dict(relu=True, resid=True)),
    ("conv3_stage4", (64, 16, 16, 2048), dict(relu=True, resid=True)),
    ("lateral5", (64, 16, 16, 256), dict(sum_dtype=torch.float32, codes=True)),
    ("lateral4", (64, 32, 32, 256), dict(sum_dtype=torch.float32, codes=True, addend=True)),
    ("lateral3", (64, 64, 64, 256), dict(addend=True)),
    ("smooth3", (64, 64, 64, 256), dict()),
    ("p6", (64, 8, 8, 256), dict(relu_codes=True)),
    ("p7", (64, 4, 4, 256), dict()),
    ("head_conv_p3", (64, 64, 64, 256), dict(relu=True)),
    ("cls_out_p3", (64, 64, 64, 720), dict(sum_dtype=torch.float32)),
    ("cls_out_p3_bf16", (64, 64, 64, 720), dict(sum_dtype=torch.bfloat16)),
    ("box_out_p7", (64, 4, 4, 36), dict(sum_dtype=torch.float32)),
    ("bs1_vgg_conv4_3", (1, 38, 38, 512), dict(relu=True)),
    ("bs1_ssd_cls_3", (1, 3, 3, 84), dict(sum_dtype=torch.float32)),
    ("bs1_ssd_cls_5", (1, 5, 5, 126), dict(sum_dtype=torch.float32)),
    ("bs1_conv3_stage2", (1, 64, 64, 512), dict(relu=True, resid=True)),
    ("bs1_lateral4", (1, 32, 32, 256), dict(sum_dtype=torch.float32, codes=True, addend=True)),
    ("bs1_p6", (1, 8, 8, 256), dict(relu_codes=True)),
    ("bs1_cls_out_p7", (1, 4, 4, 720), dict(sum_dtype=torch.bfloat16)),
]


def _kernel_args(shape, kw, device, seed):
    acc, deq, bias, s = _case(shape, seed, device=device, big=seed % 3 == 0)
    args = dict(relu=kw.get("relu", False), sum_dtype=kw.get("sum_dtype"),
                relu_codes=kw.get("relu_codes", False))
    if kw.get("codes", "sum_dtype" not in kw):
        args["out_scale"] = s
    if kw.get("resid"):
        args["resid"] = torch.randint(-127, 128, shape, dtype=torch.int8, device=device)
        args["resid_scale"] = 0.0173
    if kw.get("addend"):
        b, h, w, c = shape
        args["addend"] = torch.randn(b, h // 2, w // 2, c, device=device) * 3
    return acc, deq, bias, args


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), int((g != w).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "dense"])
@pytest.mark.parametrize("name,shape,kw", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_kernel_bit_equal_to_plain_version(cuda_device, name, shape, kw, layout):
    acc, deq, bias, args = _kernel_args(shape, kw, cuda_device, seed=len(name))
    if layout == "padded":
        acc = _padded(acc)
    before = ep.epilogue.launches
    got = ep.epilogue(acc, deq, bias, **args)
    torch.cuda.synchronize()
    assert ep.epilogue.launches == before + 1
    _assert_same(got, ep.epilogue_reference(acc, deq, bias, **args))
    if got.codes is not None:
        low = 0 if args["relu"] else -127
        assert bool((got.codes == 127).any()) and bool((got.codes == low).any())


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 9, 8), (3, 7, 9, 126), (1, 1, 1, 3)])
def test_kernel_rounds_ties_as_the_plain_version(cuda_device, shape, relu):
    """Quotients exactly at half-integers, both signs, past the clip; a
    ragged width and an unaligned view take the element-by-element walk."""
    acc, deq, bias, s = _ties(shape, cuda_device)
    want = ep.epilogue_reference(acc, deq, bias, s, relu, relu_codes=True)
    _assert_same(ep.epilogue(acc, deq, bias, s, relu, relu_codes=True), want)
    wide = torch.zeros(shape[:-1] + (shape[-1] + 1,), dtype=torch.int32, device=cuda_device)
    wide[..., 1:] = acc
    _assert_same(ep.epilogue(wide[..., 1:], deq, bias, s, relu, relu_codes=True), want)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_a_layout_it_does_not_take(cuda_device):
    acc, deq, bias, s = _case((2, 4, 4, 8), seed=9, device=cuda_device)
    with pytest.raises(ValueError):
        ep.epilogue(acc.transpose(1, 2), deq, bias, s)  # rows not at one stride
    with pytest.raises(ValueError):
        ep.epilogue(acc[..., ::2], deq[::2], bias[::2], s)
    with pytest.raises(ValueError):
        ep.epilogue(acc, deq.cpu(), bias, s)


@functools.lru_cache(maxsize=None)
def _quantized(family):
    """A full-width int8 model of ``family`` on the card (seeded weights,
    calibrated on two seeded batches): QuantParams, spec, config and the
    forward, made once for the tests that share it."""
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.core.config import get_config
    from object_detector_tpu_torch.models.retinanet import build_model
    from object_detector_tpu_torch.quant import engine

    cfg = get_config({"ssd": "ssd300_vgg16_voc", "retinanet": "retinanet_fpn_coco"}[family])
    s = cfg.model.image_size
    params = init_params(build_model(cfg), seed=5, random_batch_stats=True).state_dict()
    params = {k: v.cuda() for k, v in params.items()}
    calib = torch.randn(2, s, s, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
    if family == "ssd":
        qp, spec = engine.quantize_ssd(cfg, params, [calib])
        forward = engine.int8_forward
    else:
        qp, spec = engine.quantize_retinanet(cfg, params, [calib])
        forward = engine.retinanet_int8_forward
    return qp.to("cuda"), spec, cfg, forward


def _full_width(family, device, batch):
    """`_quantized` and ``batch`` seeded normalized images."""
    qp, spec, cfg, forward = _quantized(family)
    s = cfg.model.image_size
    images = torch.randn(batch, s, s, 3, device=device,
                         generator=torch.Generator(device=device).manual_seed(batch))
    return qp, spec, cfg, images, forward


def _plain_epilogue(*args, **kw):
    return ep.epilogue_reference(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("family,batch", [("ssd", 4), ("ssd", 1), ("retinanet", 4),
                                          ("retinanet", 1)])
def test_forward_bit_equal_with_the_plain_epilogue(cuda_device, monkeypatch, family, batch):
    """The int8 forward on the card against the same forward with the plain
    epilogue swapped in: RetinaNet's codes at every requant point and both
    families' logits, bit for bit; one launch an epilogue step."""
    from object_detector_tpu_torch.quant import engine

    qp, spec, cfg, images, forward = _full_width(family, cuda_device, batch)
    codes = {}
    if family == "retinanet":
        run = engine.run_int8_fpn_heads

        def capture(qp_, cfg_, taps_q, logits_dtype=torch.float32, concat=True, codes_=None):
            return run(qp_, cfg_, taps_q, logits_dtype, concat, codes)

        monkeypatch.setattr(engine, "run_int8_fpn_heads", capture)
    before = ep.epilogue.launches
    with torch.inference_mode():
        got = forward(qp, spec, cfg, images)
        torch.cuda.synchronize()
        launched = ep.epilogue.launches - before
        got_codes = dict(codes)
        codes.clear()
        monkeypatch.setattr(ep, "epilogue", _plain_epilogue)
        want = forward(qp, spec, cfg, images)
    assert launched == (SSD300_EPILOGUES if family == "ssd" else RETINANET_EPILOGUES)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if family == "retinanet":
        assert list(got_codes) == list(codes) and len(codes) == 8 + 2 * 5 * cfg.model.head_depth
        for key in codes:
            assert torch.equal(got_codes[key], codes[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ssd", "retinanet"])
def test_only_the_kernel_runs_under_the_epilogue_span(cuda_device, tmp_path, family):
    """Every kernel launched inside an ``odt.int8.epilogue`` range is the
    requant epilogue kernel, one a range. Two forwards are traced: a
    window's first kernel records can be missing."""
    from torch.profiler import ProfilerActivity, profile

    qp, spec, cfg, images, forward = _full_width(family, cuda_device, 2)
    with torch.inference_mode():
        forward(qp, spec, cfg, images)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                forward(qp, spec, cfg, images)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "odt.int8.epilogue")
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get(
                  "args", {})}
    under = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        hit = [i for i, (a, b) in enumerate(spans) if at is not None and a <= at <= b]
        if hit:
            under.setdefault(hit[0], []).append(e["name"])
    want = SSD300_EPILOGUES if family == "ssd" else RETINANET_EPILOGUES
    assert len(spans) == 2 * want and len(under) >= want
    for names in under.values():
        assert len(names) == 1 and "requant_epilogue_kernel" in names[0], names
