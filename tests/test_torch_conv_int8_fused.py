"""The int8 engine's 3x3 stride-1 conv with its epilogue in one kernel
(`kernels.conv3x3`). On the CPU the wrapper runs its plain version, the
engine's three-stage chain (`ops.int8.conv_int8`, then the plain epilogue),
which is held against an independent float64 conv at every geometry the
engine uses; `_conv_step` routes exactly the steps in scope, and counts their
operations and bytes in ``odt.int8.conv_ops`` / ``conv_bytes`` instead of the
epilogue's bytes. On the card (``cuda``-marked) the CUDA kernel is bit-equal
to the chain at the main paths' own shapes, the int8 forwards equal the same
forwards with the plain version swapped in, and only the kernel runs under
``odt.int8.conv``.

This file imports neither JAX nor the reference, so on the card it runs as

    python -m pytest tests/test_torch_conv_int8_fused.py --noconftest -q
"""

import functools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from object_detector_tpu_torch.kernels import conv3x3 as cv
from object_detector_tpu_torch.kernels import requant_epilogue as ep
from object_detector_tpu_torch.ops import int8 as int8_ops

# Routed steps of one int8 forward at full width: SSD-300 with VGG block 1 as
# one kernel (conv2_1 .. fc6, conv10_2, conv11_2, 6 levels x cls and box);
# RetinaNet (stage 1 block 1's 3x3, the 3 smooths, 2 heads x 5 levels x 5
# convs).
SSD300_CONVS, RETINANET_CONVS = 26, 54

OUTPUTS = {
    "codes": dict(relu=False),
    "codes_relu": dict(relu=True),
    "sum_f32": dict(sum_dtype=torch.float32),
    "sum_bf16": dict(sum_dtype=torch.bfloat16),
}


def _case(b, size, cin, cout, seed, device="cpu", out="codes", relu_input=False):
    """Codes, a kernel, deq, bias and the output's arguments, with an
    out_scale at which the largest |y| / out_scale is about 200: the codes
    reach both clips."""
    g = torch.Generator().manual_seed(seed)
    low = 0 if relu_input else -127
    x = torch.randint(low, 128, (b, size, size, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    deq = (torch.rand(cout, generator=g) + 0.5) * (4.0 / (127 * 127 * 9 * cin) ** 0.5)
    bias = torch.randn(cout, generator=g) * 0.1
    kw = dict(OUTPUTS[out])
    if "sum_dtype" not in kw:
        kw["out_scale"] = float(np.float32(4.0 / 200))
    return [t.to(device) for t in (x, w, deq, bias)] + [kw]


def _float_conv(x, w, padding, dilation):
    """An independent int32 conv: float64 products and sums (exact below
    2^53) by torch's own conv, NHWC in and out."""
    pad = {"SAME": dilation, "VALID": 0}.get(padding, padding)
    y = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1).double(),
                 padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


def _chain(x, w, deq, bias, padding, dilation, kw):
    acc = int8_ops.conv_int8(x, w, 1, padding, dilation)
    return ep.epilogue_reference(acc, deq, bias, kw.get("out_scale"), kw.get("relu", False),
                                 sum_dtype=kw.get("sum_dtype"))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), int((g != w).sum())


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("out", sorted(OUTPUTS))
def test_cpu_plain_version_is_the_chain(out):
    x, w, deq, bias, kw = _case(2, 6, 64, 24, seed=1, out=out)
    got = cv.conv3x3(x, w, deq, bias, **kw)
    _assert_same(got, _chain(x, w, deq, bias, "SAME", 1, kw))
    acc = _float_conv(x, w, "SAME", 1)
    want = ep.epilogue(acc, deq, bias, kw.get("out_scale"), kw.get("relu", False),
                       sum_dtype=kw.get("sum_dtype"))
    _assert_same(got, want)
    if got.codes is not None:
        low = 0 if kw["relu"] else -127
        assert bool((got.codes == 127).any()) and bool((got.codes == low).any())


# (map px, Cin, Cout, dilation, padding, output): the engine's geometries
# (dilation 1, 2 for DC5, 6 for fc6; SAME and SSD's VALID extras) over the
# widths and maps of the main paths, cut in batch for the CPU.
GEOMETRY = [
    (75, 64, 126, 1, "SAME", "sum_f32"),
    (19, 64, 16, 6, "SAME", "codes_relu"),
    (19, 256, 84, 2, "SAME", "sum_bf16"),
    (3, 256, 720, 1, "SAME", "sum_bf16"),
    (3, 512, 84, 1, "VALID", "codes"),
    (5, 512, 126, 1, "VALID", "codes_relu"),
    (1, 1024, 16, 1, "SAME", "sum_f32"),
    (1, 1024, 720, 6, "SAME", "codes"),
    (3, 32, 36, 2, 1, "codes_relu"),
]


@pytest.mark.parametrize("size,cin,cout,dilation,padding,out", GEOMETRY,
                         ids=[f"{g[0]}px_c{g[1]}_n{g[2]}_d{g[3]}_{g[4]}_{g[5]}" for g in GEOMETRY])
def test_cpu_plain_version_at_the_engines_geometries(size, cin, cout, dilation, padding, out):
    x, w, deq, bias, kw = _case(2, size, cin, cout, seed=size + cin + cout, out=out,
                                relu_input=True)
    got = cv.conv3x3(x, w, deq, bias, padding, dilation, **kw)
    acc = _float_conv(x, w, padding, dilation)
    _assert_same(got, ep.epilogue_reference(acc, deq, bias, kw.get("out_scale"),
                                            kw.get("relu", False), sum_dtype=kw.get("sum_dtype")))
    y = got.codes if got.codes is not None else got.sum
    assert y.shape == acc.shape


def test_cpu_wrapper_raises_on_what_it_does_not_take():
    x, w, deq, bias, kw = _case(1, 4, 64, 16, seed=3)
    with pytest.raises(ValueError):
        cv.conv3x3(x[..., :48], w[:, :, :48], deq, bias, **kw)  # Cin not a multiple of 32
    with pytest.raises(ValueError):
        cv.conv3x3(x, w[:1, :1], deq, bias, **kw)  # not 3x3
    with pytest.raises(ValueError):
        cv.conv3x3(x, w, deq, bias)  # neither codes nor sum
    with pytest.raises(ValueError):
        cv.conv3x3(x, w, deq, bias, sum_dtype=torch.float32, **kw)  # both
    with pytest.raises(ValueError):
        cv.conv3x3(x, w, deq[:8], bias, **kw)
    with pytest.raises(ValueError):
        cv.conv3x3(x[:, :1, :1], w, deq, bias, "VALID", **kw)  # no output pixel
    with pytest.raises(TypeError):
        cv.conv3x3(x.float(), w, deq, bias, **kw)
    with pytest.raises(ValueError, match="^conv3x3 runs on cuda or cpu tensors, got meta$"):
        cv.conv3x3(x.to("meta"), w.to("meta"), deq.to("meta"), bias.to("meta"), **kw)


def _tiny(family):
    """A tiny int8 model of ``family`` on the CPU: QuantParams, spec, config,
    forward and two seeded normalized images."""
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.core import config
    from object_detector_tpu_torch.models.retinanet import build_model
    from object_detector_tpu_torch.quant import engine

    cfg = {"ssd": config.tiny_test_config, "retinanet": config.tiny_retinanet_config}[family]()
    s = cfg.model.image_size
    params = init_params(build_model(cfg), seed=5, random_batch_stats=True).state_dict()
    calib = torch.randn(2, s, s, 3, generator=torch.Generator().manual_seed(6))
    if family == "ssd":
        qp, spec = engine.quantize_ssd(cfg, params, [calib])
        forward = engine.int8_forward
    else:
        qp, spec = engine.quantize_retinanet(cfg, params, [calib])
        forward = engine.retinanet_int8_forward
    images = torch.randn(2, s, s, 3, generator=torch.Generator().manual_seed(7))
    return qp, spec, cfg, forward, images


# Routed steps of one tiny forward: tiny_test (VGG at 64 px: conv2_1 .. fc6,
# 2 levels x cls and box) and tiny_retinanet_config (stage 1 block 1's 3x3,
# the 3 smooths and 2 heads x 5 levels x (1 conv + out) over 32 channels);
# and the steps left to the chain: fc7, and the ResNet trunk's 15 convs
# outside its kernels, the 3 laterals, P6 and P7.
TINY_CONVS = {"ssd": 12 + 2 * 2, "retinanet": 1 + 3 + 2 * 5 * 2}
TINY_EPILOGUES = {"ssd": 1, "retinanet": 15 + 3 + 2}


@pytest.mark.parametrize("family", sorted(TINY_CONVS))
def test_conv_step_routes_exactly_the_steps_in_scope(family):
    from object_detector_tpu_torch.utils import profiling

    qp, spec, cfg, forward, images = _tiny(family)
    routed = []
    kernel = cv.conv3x3

    def spy(x, w, *args, **kw):
        routed.append(tuple(w.shape))
        return kernel(x, w, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(cv, "conv3x3", spy)
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            forward(qp, spec, cfg, images)
    finally:
        mp.undo()
        profiling.reset_counters()
    spans = [e for e in prof.events() if e.name == "odt.int8.conv"]
    assert len(spans) == len(routed) == TINY_CONVS[family]
    assert all(s[:2] == (3, 3) and s[2] % cv.CIN_MULTIPLE == 0 for s in routed)
    epilogues = [e for e in prof.events() if e.name == "odt.int8.epilogue"]
    assert len(epilogues) == TINY_EPILOGUES[family]


def test_conv_counters_are_the_shapes_and_the_epilogue_bytes_leave_them_out():
    """One routed step adds 2 M K N operations and its codes in, kernel and
    output once; nothing to the epilogue's bytes. A strided 3x3 runs the
    chain and adds its epilogue's bytes and nothing to the conv counters."""
    from object_detector_tpu_torch.quant import engine
    from object_detector_tpu_torch.utils import profiling

    x, w, deq, bias, _ = _case(2, 5, 64, 16, seed=4)
    qp = engine.QuantParams(w_int8={"c": w}, w_scale={"c": deq}, bias={"c": bias},
                            act_scale={}, float_params={})
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        engine._conv_step(qp, x, 0.5, "c", out_scale=0.02, relu=True)
        engine._conv_step(qp, x, 0.5, "c", sum_dtype=torch.bfloat16)
    counted = profiling.counters()
    profiling.reset_counters()
    m, k, n = 2 * 5 * 5, 9 * 64, 16
    assert counted[engine.CONV_OPS] == 2 * (2 * m * k * n)
    assert counted[engine.CONV_BYTES] == 2 * (x.numel() + w.numel()) + m * n * (1 + 2)
    assert engine.EPILOGUE_BYTES not in counted
    with profile(activities=[ProfilerActivity.CPU]):
        engine._conv_step(qp, x, 0.5, "c", stride=2, out_scale=0.02)
    counted = profiling.counters()
    profiling.reset_counters()
    mo = 2 * 3 * 3
    assert counted == {engine.EPILOGUE_BYTES: mo * n * (4 + 1)}


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (name, batch, map px, Cin, Cout, dilation, padding, output): every routed
# shape of the main paths. SSD-300 bs=64: VGG conv2_1 .. fc6, the VALID
# extras, every head (cls 84 / 126 in float32 logits, box 16 / 24) at 38,
# 19, 10, 5, 3, 1 px; RetinaNet bs=64 at 512 px: stage 1's 3x3, a smooth,
# a head conv at P3 and P7, the cls (720, bf16 logits) and box (36) outs;
# DETR bs=32 at 1088 px: stage 1's 3x3 (272 px), stage 4 block 1's and a
# DC5 3x3 dilated by 2 (68 px); SSD-300 bs=1.
CARD_CASES = [
    ("ssd_conv2_1", 64, 150, 64, 128, 1, "SAME", "codes_relu"),
    ("ssd_conv2_2", 64, 150, 128, 128, 1, "SAME", "codes_relu"),
    ("ssd_conv3_1", 64, 75, 128, 256, 1, "SAME", "codes_relu"),
    ("ssd_conv3_3", 64, 75, 256, 256, 1, "SAME", "codes_relu"),
    ("ssd_conv4_1", 64, 38, 256, 512, 1, "SAME", "codes_relu"),
    ("ssd_conv4_3", 64, 38, 512, 512, 1, "SAME", "codes_relu"),
    ("ssd_conv5_3", 64, 19, 512, 512, 1, "SAME", "codes_relu"),
    ("ssd_fc6", 64, 19, 512, 1024, 6, "SAME", "codes_relu"),
    ("ssd_conv10_2", 64, 5, 128, 256, 1, "VALID", "codes_relu"),
    ("ssd_conv11_2", 64, 3, 128, 256, 1, "VALID", "codes_relu"),
    ("ssd_cls_38", 64, 38, 512, 84, 1, "SAME", "sum_f32"),
    ("ssd_box_38", 64, 38, 512, 16, 1, "SAME", "sum_f32"),
    ("ssd_cls_19", 64, 19, 1024, 126, 1, "SAME", "sum_f32"),
    ("ssd_box_19", 64, 19, 1024, 24, 1, "SAME", "sum_f32"),
    ("ssd_cls_10", 64, 10, 512, 126, 1, "SAME", "sum_f32"),
    ("ssd_box_10", 64, 10, 512, 24, 1, "SAME", "sum_f32"),
    ("ssd_cls_5", 64, 5, 256, 126, 1, "SAME", "sum_f32"),
    ("ssd_box_5", 64, 5, 256, 24, 1, "SAME", "sum_f32"),
    ("ssd_cls_3", 64, 3, 256, 84, 1, "SAME", "sum_f32"),
    ("ssd_box_3", 64, 3, 256, 16, 1, "SAME", "sum_f32"),
    ("ssd_cls_1", 64, 1, 256, 84, 1, "SAME", "sum_f32"),
    ("ssd_box_1", 64, 1, 256, 16, 1, "SAME", "sum_f32"),
    ("ssd_cls_38_bf16", 64, 38, 512, 84, 1, "SAME", "sum_bf16"),
    ("retina_stage1_conv2", 64, 128, 64, 64, 1, "SAME", "codes_relu"),
    ("retina_smooth3", 64, 64, 256, 256, 1, "SAME", "codes"),
    ("retina_head_p3", 64, 64, 256, 256, 1, "SAME", "codes_relu"),
    ("retina_head_p7", 64, 4, 256, 256, 1, "SAME", "codes_relu"),
    ("retina_cls_p3", 64, 64, 256, 720, 1, "SAME", "sum_bf16"),
    ("retina_cls_p7", 64, 4, 256, 720, 1, "SAME", "sum_bf16"),
    ("retina_box_p3", 64, 64, 256, 36, 1, "SAME", "sum_f32"),
    ("detr_stage1_conv2", 32, 272, 64, 64, 1, "SAME", "codes_relu"),
    ("detr_stage4_conv2", 32, 68, 512, 512, 1, "SAME", "codes_relu"),
    ("detr_dc5_conv2", 32, 68, 512, 512, 2, "SAME", "codes_relu"),
    ("bs1_ssd_conv2_2", 1, 150, 128, 128, 1, "SAME", "codes_relu"),
    ("bs1_ssd_conv5_3", 1, 19, 512, 512, 1, "SAME", "codes_relu"),
    ("bs1_ssd_fc6", 1, 19, 512, 1024, 6, "SAME", "codes_relu"),
    ("bs1_ssd_conv11_2", 1, 3, 128, 256, 1, "VALID", "codes_relu"),
    ("bs1_ssd_cls_19", 1, 19, 1024, 126, 1, "SAME", "sum_f32"),
    ("bs1_ssd_box_1", 1, 1, 256, 16, 1, "SAME", "sum_f32"),
    ("tiny_retina_head", 2, 16, 32, 32, 1, "SAME", "codes_relu"),
    ("tiny_retina_cls_odd", 2, 16, 32, 27, 1, "SAME", "sum_f32"),
    ("tiny_retina_cls_odd_bf16", 2, 8, 32, 27, 1, "SAME", "sum_bf16"),
    ("odd_codes_valid_d2", 3, 9, 64, 21, 2, "VALID", "codes"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,size,cin,cout,dilation,padding,out", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_kernel_bit_equal_to_the_chain(cuda_device, name, b, size, cin, cout, dilation, padding,
                                       out):
    x, w, deq, bias, kw = _case(b, size, cin, cout, seed=len(name), device=cuda_device,
                                out=out, relu_input=True)
    operand = int8_ops.gemm_operand(w)
    before = cv.conv3x3.launches
    got = cv.conv3x3(x, w, deq, bias, padding, dilation, operand=operand, **kw)
    torch.cuda.synchronize()
    assert cv.conv3x3.launches == before + 1
    _assert_same(got, cv.conv3x3_reference(x, w, deq, bias, padding, dilation, operand=operand,
                                           **kw))
    if got.codes is not None:
        low = 0 if kw["relu"] else -127
        assert bool((got.codes == 127).any()) and bool((got.codes == low).any())


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_a_layout_it_does_not_take(cuda_device):
    x, w, deq, bias, kw = _case(2, 6, 64, 16, seed=9, device=cuda_device)
    with pytest.raises(ValueError):
        cv.conv3x3(x.transpose(1, 2), w, deq, bias, **kw)  # not contiguous
    with pytest.raises(ValueError):
        cv.conv3x3(x, w, deq, bias, operand=w.reshape(-1, 16), **kw)  # not laid out
    with pytest.raises(ValueError):
        cv.conv3x3(x, w, deq.cpu(), bias, **kw)


@functools.lru_cache(maxsize=None)
def _quantized(family):
    """A full-width int8 model of ``family`` on the card (seeded weights,
    calibrated on a seeded batch): QuantParams, spec, config and forward."""
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


def _images(cfg, batch):
    s = cfg.model.image_size
    return torch.randn(batch, s, s, 3, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(batch))


@pytest.mark.cuda
@pytest.mark.parametrize("family,batch", [("ssd", 4), ("ssd", 1), ("retinanet", 4),
                                          ("retinanet", 1)])
def test_forward_bit_equal_with_the_plain_version(cuda_device, monkeypatch, family, batch):
    """The int8 forward on the card against the same forward with the plain
    version (im2col, the library GEMM, the epilogue) swapped in: RetinaNet's
    codes at every requant point and both families' logits, bit for bit;
    one launch a routed step."""
    from object_detector_tpu_torch.quant import engine

    qp, spec, cfg, forward = _quantized(family)
    images = _images(cfg, batch)
    codes = {}
    if family == "retinanet":
        run = engine.run_int8_fpn_heads

        def capture(qp_, cfg_, taps_q, logits_dtype=torch.float32, concat=True, codes_=None):
            return run(qp_, cfg_, taps_q, logits_dtype, concat, codes)

        monkeypatch.setattr(engine, "run_int8_fpn_heads", capture)
    before = cv.conv3x3.launches
    with torch.inference_mode():
        got = forward(qp, spec, cfg, images)
        torch.cuda.synchronize()
        launched = cv.conv3x3.launches - before
        got_codes = dict(codes)
        codes.clear()
        monkeypatch.setattr(cv, "conv3x3", cv.conv3x3_reference)
        want = forward(qp, spec, cfg, images)
    assert launched == (SSD300_CONVS if family == "ssd" else RETINANET_CONVS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if family == "retinanet":
        assert list(got_codes) == list(codes) and len(codes) == 8 + 2 * 5 * cfg.model.head_depth
        for key in codes:
            assert torch.equal(got_codes[key], codes[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ssd", "retinanet"])
def test_only_the_kernel_runs_under_the_conv_span(cuda_device, tmp_path, family):
    """Every kernel launched inside an ``odt.int8.conv`` range is the conv
    kernel, one a range: no library GEMM, no copy. Two forwards are traced:
    a window's first kernel records can be missing."""
    qp, spec, cfg, forward = _quantized(family)
    images = _images(cfg, 2)
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
                   if e.get("cat") == "user_annotation" and e["name"] == "odt.int8.conv")
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
    want = SSD300_CONVS if family == "ssd" else RETINANET_CONVS
    assert len(spans) == 2 * want and len(under) >= want
    for names in under.values():
        assert len(names) == 1 and "conv3x3_requant_kernel" in names[0], names
