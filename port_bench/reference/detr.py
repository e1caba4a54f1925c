"""Plain float32 reference of DETR-DC5 on ResNet-50 (arXiv:2005.12872).

Written from the paper's section 3.2 and Fig. 2 and from its public code
(github.com/facebookresearch/detr: ``models/transformer.py``,
``position_encoding.py``, ``detr.py``) in plain ``torch`` calls: the
trunk through `reference.detector`'s conv and BatchNorm helpers, the
transformer as ``nn.MultiheadAttention``'s arithmetic written out (scaled
queries, the key padding mask as -inf before the softmax), post-norm
layers, dropout off. Nothing of the program is imported, and no kernel,
cache or batching of it is used. TF32 is off (`detector.exact_float32`).

``arch`` is the ``resolved`` section of ``port_bench/configs/
detr_r50_dc5_coco.json``: ``model``, ``eval`` and ``transformer``. Weights
are a dict keyed by the program's ``state_dict`` names.

Departures from the paper, all of them the benchmark's:
- images are served on a 1088 x 1088 canvas (the paper pads each batch to
  its largest image: 1066 at most at section 4's shapes); the canvas is
  a multiple of 32, and where the padding ends changes nothing that an
  image's extent does not;
- the weights are seeded (`port_bench.detr_weights`), not trained;
- the trunk is the repository's ResNet-50: the strided convs pad as XLA's
  "SAME" (torchvision pads 1 on each side), the stem's conv 3 on each side;
- the class head has 92 outputs (91 COCO ids and "no object"), as the
  public code's ``num_classes = 91``.

`forward` can also run the correctness controls (`Quant`): the trunk's
convs fake-quantized (symmetric, weights per output channel, activations
per tensor at each conv input, calibrated by `calibrate` on the program's
calibration canvases), and optionally every matrix product of the
transformer with both inputs rounded to float8 e4m3.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import detector

Tensor = torch.Tensor
Params = Dict[str, Tensor]

C5_CHANNELS = 2048
LN_EPS = 1e-5
POS_TEMPERATURE = 10000.0
POS_EPS = 1e-6
POS_SCALE = 2 * math.pi
# float8 e4m3's largest finite value: inputs are clipped to it before the
# cast, which has no saturation of its own.
FP8_MAX = 448.0


# --------------------------------------------------------------------------
# Parameter layout: (name, shape, role), as `port_bench.detr_weights` draws it
# --------------------------------------------------------------------------

def _linear(name: str, cin: int, cout: int, role: str):
    return [(f"{name}.weight", (cout, cin), role), (f"{name}.bias", (cout,), "bias")]


def _layer_norm(name: str, d: int):
    return [(f"{name}.weight", (d,), "ln_weight"), (f"{name}.bias", (d,), "bias")]


def _attention(name: str, d: int):
    return [(f"{name}.in_proj_weight", (3 * d, d), "attn_in"),
            (f"{name}.in_proj_bias", (3 * d,), "bias")] + _linear(f"{name}.out_proj", d, d,
                                                                   "linear")


def param_spec(arch) -> List[Tuple[str, tuple, str]]:
    """The trunk's leaves are `detector`'s ResNet-50 (DC5 changes strides
    and dilations, no shape); then ``input_proj``, the transformer, the
    query embedding and the heads under DETR's names."""
    t, classes = arch["transformer"], arch["model"]["num_classes"]
    d, ffn = t["d_model"], t["ffn"]
    spec = detector._resnet_spec()
    spec += [("input_proj.weight", (d, C5_CHANNELS, 1, 1), "linear"),
             ("input_proj.bias", (d,), "bias")]
    for i in range(t["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        spec += _attention(f"{n}.self_attn", d)
        spec += _linear(f"{n}.linear1", d, ffn, "relu") + _linear(f"{n}.linear2", ffn, d, "linear")
        spec += _layer_norm(f"{n}.norm1", d) + _layer_norm(f"{n}.norm2", d)
    for i in range(t["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        spec += _attention(f"{n}.self_attn", d) + _attention(f"{n}.multihead_attn", d)
        spec += _linear(f"{n}.linear1", d, ffn, "relu") + _linear(f"{n}.linear2", ffn, d, "linear")
        for k in (1, 2, 3):
            spec += _layer_norm(f"{n}.norm{k}", d)
    spec += _layer_norm("transformer.decoder.norm", d)
    spec.append(("query_embed.weight", (t["queries"], d), "query"))
    spec += _linear("class_embed", d, classes + 1, "cls")
    spec += _linear("bbox_embed.layers.0", d, d, "relu") + _linear("bbox_embed.layers.1", d, d,
                                                                   "relu")
    spec += _linear("bbox_embed.layers.2", d, 4, "box")
    return spec


# --------------------------------------------------------------------------
# The controls
# --------------------------------------------------------------------------

class Quant:
    """A control: the trunk fake-quantized by ``trunk`` (a `detector.Quant`,
    or None for float32), and with ``fp8`` both inputs of every matrix
    product of the transformer rounded to float8 e4m3."""

    def __init__(self, trunk: Optional[detector.Quant], fp8: bool = False):
        self.trunk = trunk
        self.fp8 = fp8


def _fp8(x: Tensor) -> Tensor:
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)


class _Products:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def linear(self, x: Tensor, p: Params, name: str) -> Tensor:
        return self.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _trunk(r: detector._Run, x: Tensor, dilate_c5: bool) -> Tensor:
    """ResNet-50 (DC5: stage 4 at stride 1, its blocks 2 and 3 at dilation
    2) -> C5, NCHW."""
    x = F.relu(r.bn(r.conv(x, "backbone.stem_conv", stride=2, padding=3), "backbone.stem_bn"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    cin = 64
    for stage, (blocks, width) in enumerate(detector.RESNET_STAGES, start=1):
        for block in range(1, blocks + 1):
            n = f"backbone.stage{stage}_block{block}"
            stride = 2 if (block == 1 and stage > 1) else 1
            dilation = 1
            if dilate_c5 and stage == 4:
                stride, dilation = 1, (1 if block == 1 else 2)
            out = F.relu(r.bn(r.conv(x, f"{n}.conv1"), f"{n}.bn1"))
            out = F.relu(r.bn(r.conv(out, f"{n}.conv2", stride=stride, dilation=dilation),
                              f"{n}.bn2"))
            out = r.bn(r.conv(out, f"{n}.conv3"), f"{n}.bn3")
            if cin != 4 * width or stride != 1:
                short = r.bn(r.conv(x, f"{n}.proj", stride=stride), f"{n}.bn_proj")
            else:
                short = x
            x = F.relu(out + short)
            cin = 4 * width
    return x


def canvas_mask(extents: Tensor, h: int, w: int) -> Tensor:
    """(B, 2) extents (h, w) -> (B, h, w) bool, True beyond the extent
    (DETR's ``NestedTensor`` mask: the image at the top left)."""
    ys = torch.arange(h, device=extents.device)[None, :, None]
    xs = torch.arange(w, device=extents.device)[None, None, :]
    return (ys >= extents[:, 0, None, None]) | (xs >= extents[:, 1, None, None])


def position_encoding(mask: Tensor, d_model: int) -> Tensor:
    """``PositionEmbeddingSine(d_model / 2, 10000, normalize=True)`` of a
    (B, H, W) mask, verbatim -> (B, d_model, H, W)."""
    feats = d_model // 2
    not_mask = ~mask
    y_embed = not_mask.cumsum(1, dtype=torch.float32)
    x_embed = not_mask.cumsum(2, dtype=torch.float32)
    y_embed = y_embed / (y_embed[:, -1:, :] + POS_EPS) * POS_SCALE
    x_embed = x_embed / (x_embed[:, :, -1:] + POS_EPS) * POS_SCALE
    dim_t = torch.arange(feats, dtype=torch.float32, device=mask.device)
    dim_t = POS_TEMPERATURE ** (2 * (dim_t // 2) / feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def _mha(m: _Products, p: Params, name: str, query: Tensor, key: Tensor, value: Tensor,
         heads: int, key_pad: Optional[Tensor]) -> Tensor:
    """``nn.MultiheadAttention`` (batch first, dropout off): (B, Lq, d)."""
    w, bias = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    d = query.shape[-1]
    dh = d // heads
    q = m.mm(query, w[:d].t()) + bias[:d]
    k = m.mm(key, w[d:2 * d].t()) + bias[d:2 * d]
    v = m.mm(value, w[2 * d:].t()) + bias[2 * d:]
    q = q * (float(dh) ** -0.5)
    b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
    q = q.reshape(b, lq, heads, dh).transpose(1, 2)
    k = k.reshape(b, lk, heads, dh).transpose(1, 2)
    v = v.reshape(b, lk, heads, dh).transpose(1, 2)
    scores = m.mm(q, k.transpose(-1, -2))
    if key_pad is not None:
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
    out = m.mm(torch.softmax(scores, dim=-1), v)
    return m.linear(out.transpose(1, 2).reshape(b, lq, d), p, f"{name}.out_proj")


def _norm(x: Tensor, p: Params, name: str) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _ffn(m: _Products, p: Params, name: str, x: Tensor) -> Tensor:
    return m.linear(F.relu(m.linear(x, p, f"{name}.linear1")), p, f"{name}.linear2")


def forward(params: Params, images_u8: Tensor, extents: Tensor, arch,
            quant: Optional[Quant] = None) -> Tuple[Tensor, Tensor]:
    """(B, S, S, 3) uint8 canvases and (B, 2) extents (h, w) -> (logits
    (B, Q, C + 1), boxes (B, Q, 4) cx, cy, w, h in [0, 1] of the extent),
    float32."""
    t = arch["transformer"]
    heads = t["heads"]
    p = params
    m = _Products(quant is not None and quant.fp8)
    x = detector.normalize_u8(images_u8)
    b, _, h, w = x.shape
    mask = canvas_mask(extents.to(x.device), h, w)
    x = x * (~mask)[:, None].to(x.dtype)
    r = detector._Run(p, quant.trunk if quant is not None else None)
    c5 = _trunk(r, x, t["dilate_c5"])
    src = F.conv2d(c5, p["input_proj.weight"], p["input_proj.bias"])
    mask = F.interpolate(mask[None].float(), size=src.shape[-2:]).to(torch.bool)[0]
    pos = position_encoding(mask, src.shape[1])
    src = src.flatten(2).transpose(1, 2)  # (B, L, d), (y, x) order
    pos = pos.flatten(2).transpose(1, 2)
    key_pad = mask.flatten(1)
    for i in range(t["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        qk = src + pos
        src = _norm(src + _mha(m, p, f"{n}.self_attn", qk, qk, src, heads, key_pad), p,
                    f"{n}.norm1")
        src = _norm(src + _ffn(m, p, n, src), p, f"{n}.norm2")
    memory = src
    query_pos = p["query_embed.weight"][None].expand(b, -1, -1)
    tgt = torch.zeros_like(query_pos)
    for i in range(t["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        qk = tgt + query_pos
        tgt = _norm(tgt + _mha(m, p, f"{n}.self_attn", qk, qk, tgt, heads, None), p,
                    f"{n}.norm1")
        tgt = _norm(tgt + _mha(m, p, f"{n}.multihead_attn", tgt + query_pos, memory + pos,
                               memory, heads, key_pad), p, f"{n}.norm2")
        tgt = _norm(tgt + _ffn(m, p, n, tgt), p, f"{n}.norm3")
    hs = _norm(tgt, p, "transformer.decoder.norm")
    logits = hs @ p["class_embed.weight"].t() + p["class_embed.bias"]
    y = hs
    for i in range(3):
        y = y @ p[f"bbox_embed.layers.{i}.weight"].t() + p[f"bbox_embed.layers.{i}.bias"]
        if i < 2:
            y = F.relu(y)
    return logits, y.sigmoid()


def outputs(params: Params, images_u8: Tensor, extents: Tensor, arch,
            quant: Optional[Quant] = None) -> Tuple[Tensor, Tensor]:
    """`forward` in exact float32, without autograd."""
    with torch.no_grad(), detector.exact_float32():
        return forward(params, images_u8, extents, arch, quant)


def postprocess(logits: Tensor, boxes: Tensor, extents: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """DETR's ``PostProcess``: (boxes (B, Q, 4) corners in pixels of each
    image's extent, scores (B, Q), labels (B, Q)): the softmax's best class
    but "no object", and its probability."""
    prob = torch.softmax(logits, dim=-1)
    scores, labels = prob[..., :-1].max(-1)
    cx, cy, w, h = boxes.unbind(-1)
    corners = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    img_h, img_w = extents.to(corners.dtype).unbind(1)
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return corners * scale[:, None, :], scores, labels


def calibrate(params: Params, images_u8: Tensor, extents: Tensor, arch, bits: int,
              fp8: bool = False) -> Quant:
    """A control: the trunk fake-quantized to ``bits``, its activation ranges
    read on these canvases; with ``fp8`` the transformer's products too."""
    q = detector.Quant(bits)
    q.recording = {}
    with torch.no_grad(), detector.exact_float32():
        forward(params, images_u8, extents, arch, Quant(q))
    q.act_max, q.recording = q.recording, None
    return Quant(q, fp8)


def macs_per_image(arch) -> int:
    """The trunk's conv multiply-adds on one whole canvas, counted on the
    meta device."""
    params = {name: torch.empty(shape, device="meta") for name, shape, _ in param_spec(arch)}
    s = arch["model"]["image_size"]
    r = detector._Run(params, None)
    _trunk(r, torch.empty((1, 3, s, s), device="meta"), arch["transformer"]["dilate_c5"])
    return int(r.macs)
