"""Plain float32 reference of the two detectors the benchmark serves.

SSD-300/VGG16 (arXiv:1512.02325) and RetinaNet with ResNet-50 and FPN
(arXiv:1708.02002), written from the papers' layer equations in plain
``torch.nn.functional`` calls: no kernel, cache or batching of the program,
and nothing imported from it. Weights are a dict keyed by the program's
``state_dict`` names, which is how the benchmark hands the same weights to
both sides.

``arch`` is the ``resolved`` section of a configuration file under
``port_bench/configs/``: ``model``, ``anchors`` and ``eval`` as plain
numbers and lists.

`forward` can also run fake-quantized (``quant``): symmetric per-output-
channel weights and a per-tensor activation scale at every conv input,
calibrated by `calibrate` on the same calibration images the program gets.
With 4 bits that is the correctness control of an int8 cell.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
L2NORM_EPS = 1e-12

VGG_LAYERS = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), "pool_ceil",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), "pool",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
)
SSD300_EXTRAS = ((256, 512, 2, "SAME"), (128, 256, 2, "SAME"),
                 (128, 256, 1, "VALID"), (128, 256, 1, "VALID"))
RESNET_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
RETINANET_ANCHORS = 9


# --------------------------------------------------------------------------
# Parameter layout: (name, shape, role). Roles say how `port_bench.weights`
# draws each leaf; "relu" convs feed a ReLU, "linear" ones do not.
# --------------------------------------------------------------------------

def _conv_spec(name: str, cin: int, cout: int, k: int, role: str, bias: bool = True):
    out = [(f"{name}.weight", (cout, cin, k, k), role)]
    if bias:
        out.append((f"{name}.bias", (cout,), "bias"))
    return out


def _bn_spec(name: str, c: int):
    return [(f"{name}.{leaf}", (c,), f"bn_{leaf}")
            for leaf in ("weight", "bias", "running_mean", "running_var")]


def _resnet_spec() -> List[Tuple[str, tuple, str]]:
    spec = _conv_spec("backbone.stem_conv", 3, 64, 7, "relu", bias=False)
    spec += _bn_spec("backbone.stem_bn", 64)
    cin = 64
    for stage, (blocks, width) in enumerate(RESNET_STAGES, start=1):
        for block in range(1, blocks + 1):
            name = f"backbone.stage{stage}_block{block}"
            stride = 2 if (block == 1 and stage > 1) else 1
            spec += _conv_spec(f"{name}.conv1", cin, width, 1, "relu", bias=False)
            spec += _bn_spec(f"{name}.bn1", width)
            spec += _conv_spec(f"{name}.conv2", width, width, 3, "relu", bias=False)
            spec += _bn_spec(f"{name}.bn2", width)
            spec += _conv_spec(f"{name}.conv3", width, 4 * width, 1, "linear", bias=False)
            spec += [(n, s, "bn_residual_weight" if r == "bn_weight" else r)
                     for n, s, r in _bn_spec(f"{name}.bn3", 4 * width)]
            if cin != 4 * width or stride != 1:
                spec += _conv_spec(f"{name}.proj", cin, 4 * width, 1, "linear", bias=False)
                spec += _bn_spec(f"{name}.bn_proj", 4 * width)
            cin = 4 * width
    return spec


def anchors_per_level(arch) -> List[int]:
    a = arch["anchors"]
    if a["explicit_anchors_per_location"] is not None:
        return list(a["explicit_anchors_per_location"])
    return [2 + 2 * len(r) for r in a["aspect_ratios"]]


def _ssd_extras(arch, n_taps: int) -> Sequence[tuple]:
    n_extra = len(arch["anchors"]["feature_sizes"]) - n_taps
    if n_extra <= 0:
        return ()
    if arch["model"]["image_size"] >= 512:
        return ((256, 512, 2, "SAME"),) + ((128, 256, 2, "SAME"),) * (n_extra - 1)
    return SSD300_EXTRAS[:n_extra]


def param_spec(arch) -> List[Tuple[str, tuple, str]]:
    m = arch["model"]
    classes = m["num_classes"]
    if m["family"] == "retinanet":
        c, depth = m["fpn_channels"], m["head_depth"]
        spec = _resnet_spec()
        for level, cin in zip((3, 4, 5), (512, 1024, 2048)):
            spec += _conv_spec(f"fpn.lateral{level}", cin, c, 1, "linear")
        for level in (3, 4, 5):
            spec += _conv_spec(f"fpn.smooth{level}", c, c, 3, "linear")
        spec += _conv_spec("fpn.p6", 2048, c, 3, "linear")
        spec += _conv_spec("fpn.p7", c, c, 3, "linear")
        for head, outs, role in (("cls_head", classes, "cls"), ("box_head", 4, "box")):
            for i in range(depth):
                spec += _conv_spec(f"{head}.conv{i}", c, c, 3, "relu")
            spec += [(f"{head}.out.weight", (RETINANET_ANCHORS * outs, c, 3, 3), role),
                     (f"{head}.out.bias", (RETINANET_ANCHORS * outs,), f"{role}_bias")]
        return spec
    if m["backbone"] == "vgg16":
        spec = []
        for layer in VGG_LAYERS:
            if not isinstance(layer, str):
                name, cin, cout = layer
                spec += _conv_spec(f"backbone.{name}", cin, cout, 3, "relu")
        spec += _conv_spec("backbone.fc6", 512, 1024, 3, "relu")
        spec += _conv_spec("backbone.fc7", 1024, 1024, 1, "relu")
        spec.append(("l2norm.scale", (512,), "l2norm"))
        channels = [512, 1024]
    else:
        spec = _resnet_spec()
        channels = [512, 1024, 2048]
    cin = channels[-1]
    for i, (mid, out, _, _) in enumerate(_ssd_extras(arch, len(channels))):
        spec += _conv_spec(f"extras.conv{8 + i}_1", cin, mid, 1, "relu")
        spec += _conv_spec(f"extras.conv{8 + i}_2", mid, out, 3, "relu")
        channels.append(out)
        cin = out
    for level, (cin, a) in enumerate(zip(channels, anchors_per_level(arch))):
        spec += [(f"head{level}.cls.weight", (a * classes, cin, 3, 3), "cls"),
                 (f"head{level}.cls.bias", (a * classes,), "cls_bias"),
                 (f"head{level}.box.weight", (a * 4, cin, 3, 3), "box"),
                 (f"head{level}.box.bias", (a * 4,), "box_bias")]
    return spec


# --------------------------------------------------------------------------
# Fake quantization (the control) and operation counting
# --------------------------------------------------------------------------

class Quant:
    """Symmetric fake quantization to ``bits``: weights per output channel,
    activations per tensor at each conv input, from ``act_max`` (conv name
    -> the largest |x| `calibrate` saw there)."""

    def __init__(self, bits: int, act_max: Optional[Dict[str, float]] = None):
        self.qmax = float(2 ** (bits - 1) - 1)
        self.act_max = act_max
        self.recording: Optional[Dict[str, float]] = None

    def activation(self, name: str, x: Tensor) -> Tensor:
        if self.recording is not None:
            self.recording[name] = max(self.recording.get(name, 0.0), float(x.abs().max()))
            return x
        scale = max(self.act_max[name], 1e-12) / self.qmax
        return torch.clamp(torch.round(x / scale), -self.qmax, self.qmax) * scale

    def weight(self, w: Tensor) -> Tensor:
        scale = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / self.qmax
        return torch.clamp(torch.round(w / scale), -self.qmax, self.qmax) * scale


class _Run:
    def __init__(self, params: Params, quant: Optional[Quant]):
        self.p = params
        self.quant = quant
        self.macs = 0

    def conv(self, x: Tensor, name: str, stride: int = 1, padding="SAME",
             dilation: int = 1) -> Tensor:
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        if self.quant is not None:
            x = self.quant.activation(name, x)
            if self.quant.recording is None:
                w = self.quant.weight(w)
        k = w.shape[-1]
        if padding == "SAME":
            ph = _same_pads(x.shape[2], k, stride, dilation)
            pw = _same_pads(x.shape[3], k, stride, dilation)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        elif padding == "VALID":
            pad = 0
        else:
            pad = int(padding)
        y = F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation)
        self.macs += y.numel() * w.shape[1] * k * k
        return y

    def bn(self, x: Tensor, name: str) -> Tensor:
        p = self.p
        inv = torch.rsqrt(p[f"{name}.running_var"] + BN_EPS) * p[f"{name}.weight"]
        shape = (1, -1, 1, 1)
        return (x - p[f"{name}.running_mean"].view(shape)) * inv.view(shape) \
            + p[f"{name}.bias"].view(shape)


def _same_pads(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """XLA "SAME" padding for one axis (before, after); asymmetric when the
    total is odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def normalize_u8(images_u8: Tensor) -> Tensor:
    """(B, H, W, 3) uint8 -> ImageNet-normalized float32, NCHW."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _vgg(r: _Run, x: Tensor, l2norm_params: Tensor) -> List[Tensor]:
    conv4_3 = None
    for layer in VGG_LAYERS:
        if layer == "pool":
            x = F.max_pool2d(x, 2, 2)
        elif layer == "pool_ceil":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        else:
            x = F.relu(r.conv(x, f"backbone.{layer[0]}"))
            if layer[0] == "conv4_3":
                conv4_3 = x
    x = F.max_pool2d(x, 3, 1, padding=1)
    x = F.relu(r.conv(x, "backbone.fc6", dilation=6))
    x = F.relu(r.conv(x, "backbone.fc7"))
    norm = torch.rsqrt(torch.sum(conv4_3 * conv4_3, dim=1, keepdim=True) + L2NORM_EPS)
    return [conv4_3 * norm * l2norm_params[None, :, None, None], x]


def _resnet(r: _Run, x: Tensor) -> List[Tensor]:
    x = F.relu(r.bn(r.conv(x, "backbone.stem_conv", stride=2, padding=3), "backbone.stem_bn"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = []
    cin = 64
    for stage, (blocks, width) in enumerate(RESNET_STAGES, start=1):
        for block in range(1, blocks + 1):
            n = f"backbone.stage{stage}_block{block}"
            stride = 2 if (block == 1 and stage > 1) else 1
            out = F.relu(r.bn(r.conv(x, f"{n}.conv1"), f"{n}.bn1"))
            out = F.relu(r.bn(r.conv(out, f"{n}.conv2", stride=stride), f"{n}.bn2"))
            out = r.bn(r.conv(out, f"{n}.conv3"), f"{n}.bn3")
            if cin != 4 * width or stride != 1:
                short = r.bn(r.conv(x, f"{n}.proj", stride=stride), f"{n}.bn_proj")
            else:
                short = x
            x = F.relu(out + short)
            cin = 4 * width
        if stage >= 2:
            feats.append(x)
    return feats


def _flatten(t: Tensor, outputs: int) -> Tensor:
    b, _, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(b, -1, outputs)


def _up2(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def forward(params: Params, images_u8: Tensor, arch, quant: Optional[Quant] = None,
            count: Optional[list] = None) -> Tuple[Tensor, Tensor]:
    """(B, H, W, 3) uint8 -> (cls_logits (B, A, C), box_offsets (B, A, 4)),
    float32, anchors in level order and (y, x, slot) within a level. With
    ``count`` (a list) the conv multiply-adds a batch are appended to it."""
    m = arch["model"]
    classes = m["num_classes"]
    r = _Run(params, quant)
    x = normalize_u8(images_u8)
    cls_out, box_out = [], []
    if m["family"] == "retinanet":
        c3, c4, c5 = _resnet(r, x)
        p5 = r.conv(c5, "fpn.lateral5")
        p4 = r.conv(c4, "fpn.lateral4") + _up2(p5)
        p3 = r.conv(c3, "fpn.lateral3") + _up2(p4)
        p3, p4, p5 = (r.conv(p3, "fpn.smooth3"), r.conv(p4, "fpn.smooth4"),
                      r.conv(p5, "fpn.smooth5"))
        p6 = r.conv(c5, "fpn.p6", stride=2)
        p7 = r.conv(F.relu(p6), "fpn.p7", stride=2)
        for p in (p3, p4, p5, p6, p7):
            for head, outs, sink in (("cls_head", classes, cls_out), ("box_head", 4, box_out)):
                y = p
                for i in range(m["head_depth"]):
                    y = F.relu(r.conv(y, f"{head}.conv{i}"))
                sink.append(_flatten(r.conv(y, f"{head}.out"), outs))
    else:
        if m["backbone"] == "vgg16":
            taps = _vgg(r, x, params["l2norm.scale"])
        else:
            taps = _resnet(r, x)
        y = taps[-1]
        for i, (_, _, stride, pad) in enumerate(_ssd_extras(arch, len(taps))):
            y = F.relu(r.conv(y, f"extras.conv{8 + i}_1"))
            y = F.relu(r.conv(y, f"extras.conv{8 + i}_2", stride=stride, padding=pad))
            taps.append(y)
        for level, feat in enumerate(taps):
            cls_out.append(_flatten(r.conv(feat, f"head{level}.cls"), classes))
            box_out.append(_flatten(r.conv(feat, f"head{level}.box"), 4))
    if count is not None:
        count.append(r.macs)
    return torch.cat(cls_out, 1), torch.cat(box_out, 1)


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products without TF32 on a card, for the length of a block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def calibrate(params: Params, images_u8: Tensor, arch, bits: int) -> Quant:
    """The fake quantizer, its activation ranges read on ``images_u8``."""
    q = Quant(bits)
    q.recording = {}
    with torch.no_grad():
        forward(params, images_u8, arch, quant=q)
    q.act_max, q.recording = q.recording, None
    return q


def macs_per_image(arch) -> int:
    """Conv multiply-adds of one image, counted on the meta device."""
    spec = param_spec(arch)
    params = {name: torch.empty(shape, device="meta") for name, shape, _ in spec}
    s = arch["model"]["image_size"]
    count: list = []
    forward(params, torch.empty((1, s, s, 3), dtype=torch.uint8, device="meta"), arch,
            count=count)
    return int(count[0])


# --------------------------------------------------------------------------
# Anchors, scores, boxes
# --------------------------------------------------------------------------

def _tile(f: int, shapes: np.ndarray) -> np.ndarray:
    steps = (np.arange(f, dtype=np.float64) + 0.5) / f
    cx, cy = np.meshgrid(steps, steps)
    centers = np.repeat(np.stack([cx, cy], -1).reshape(f * f, 1, 2), len(shapes), axis=1)
    wh = np.broadcast_to(shapes[None], (f * f, len(shapes), 2))
    return np.concatenate([centers, wh], -1).reshape(-1, 4)


def anchors(arch) -> np.ndarray:
    """(A, 4) center-form anchors, normalized: SSD's scales and aspect ratios
    (arXiv:1512.02325 §2.2), or RetinaNet's 3 octaves x 3 ratios at area
    (4 stride)^2 (arXiv:1708.02002 §4)."""
    m, a = arch["model"], arch["anchors"]
    size = m["image_size"]
    out = []
    if m["family"] == "retinanet":
        for stride in (8, 16, 32, 64, 128):
            base = 4.0 * stride / size
            shapes = []
            for octave in (1.0, 2 ** (1 / 3), 2 ** (2 / 3)):
                for ratio in (0.5, 1.0, 2.0):
                    rt = math.sqrt(ratio)
                    shapes.append((base * octave * rt, base * octave / rt))
            out.append(_tile(max(1, size // stride), np.asarray(shapes)))
        return np.concatenate(out).astype(np.float32)
    for f, (lo, hi), ratios in zip(a["feature_sizes"], a["sizes"], a["aspect_ratios"]):
        s, s2 = lo / size, math.sqrt(lo * hi) / size
        shapes = [(s, s), (s2, s2)]
        for ratio in ratios:
            rt = math.sqrt(ratio)
            shapes += [(s * rt, s / rt), (s / rt, s * rt)]
        out.append(_tile(f, np.asarray(shapes)))
    boxes = np.concatenate(out)
    if a["clip"]:
        boxes[:, 2:] = np.minimum(boxes[:, 2:], 1.0)
    return boxes.astype(np.float32)


def decode(offsets: Tensor, anchors_c: Tensor, arch) -> Tensor:
    """SSD box decoding (arXiv:1512.02325 eq. 2 inverted) -> corner boxes
    clipped to the image."""
    cv, sv = arch["anchors"]["center_variance"], arch["anchors"]["size_variance"]
    cxy = offsets[..., :2] * cv * anchors_c[:, 2:] + anchors_c[:, :2]
    wh = torch.exp(offsets[..., 2:] * sv) * anchors_c[:, 2:]
    return torch.cat([cxy - wh / 2, cxy + wh / 2], -1).clamp(0.0, 1.0)


def scores_and_boxes(params: Params, images_u8: Tensor, arch,
                     quant: Optional[Quant] = None) -> Tuple[Tensor, Tensor]:
    """Per-anchor class scores (B, A, C) (sigmoid, one against all) and
    decoded boxes (B, A, 4), in exact float32."""
    with torch.no_grad(), exact_float32():
        logits, offsets = forward(params, images_u8, arch, quant)
        anchors_c = torch.as_tensor(anchors(arch), device=logits.device)
        return torch.sigmoid(logits), decode(offsets, anchors_c, arch)


def _iou(a: Tensor, b: Tensor) -> Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[..., 2:] - t[..., :2]).clamp_min(0).prod(-1)  # noqa: E731
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter).clamp_min(1e-8)


def detect(scores: Tensor, boxes: Tensor, arch, with_anchors: bool = False) -> Tuple[Tensor, ...]:
    """Greedy per-class NMS over the top-M anchors of each image by best
    class score (M = 2 pre_nms_top_k), then each image's best
    ``max_detections``: (boxes, scores, classes, valid), as the served
    detections are laid out, and with ``with_anchors`` each detection's
    anchor index too. The control's NMS, and what the check holds the
    served detections against."""
    e = arch["eval"]
    b, a, c = scores.shape
    m = min(2 * e["pre_nms_top_k"], a)
    best = scores.amax(-1)
    idx = torch.sort(best, dim=1, descending=True, stable=True).indices[:, :m]
    cand_s = torch.gather(scores, 1, idx[..., None].expand(b, m, c)).transpose(1, 2)
    cand_b = torch.gather(boxes, 1, idx[..., None].expand(b, m, 4))
    order = torch.sort(cand_s, dim=2, descending=True, stable=True).indices  # (B, C, M)
    s_sorted = torch.gather(cand_s, 2, order)
    b_sorted = torch.gather(cand_b[:, None].expand(b, c, m, 4), 2,
                            order[..., None].expand(b, c, m, 4))
    keep = s_sorted > e["score_threshold"]
    over = _iou(b_sorted, b_sorted) > e["nms_iou_threshold"]
    for i in range(m):
        sup = over[:, :, i, :] & keep[:, :, i:i + 1]
        sup[:, :, : i + 1] = False
        keep &= ~sup
    rank = torch.cumsum(keep.to(torch.int32), dim=2)
    keep &= rank <= e["nms_max_per_class"]
    kept = torch.where(keep, s_sorted, torch.zeros_like(s_sorted)).reshape(b, c * m)
    top = torch.sort(kept, dim=1, descending=True, stable=True)
    n = min(e["max_detections"], c * m)
    sel = top.indices[:, :n]
    out_s = top.values[:, :n]
    out_b = torch.gather(b_sorted.reshape(b, c * m, 4), 1, sel[..., None].expand(b, n, 4))
    out = (out_b, out_s, (sel // m).to(torch.int32), out_s > 0)
    if with_anchors:
        cand = torch.gather(idx[:, None].expand(b, c, m), 2, order).reshape(b, c * m)
        out += (torch.gather(cand, 1, sel),)
    return out
