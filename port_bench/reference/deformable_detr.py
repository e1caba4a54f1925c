"""Plain float32 reference of Deformable DETR on ResNet-50 (arXiv:2010.04159),
single-stage, without iterative box refinement.

Written from the paper's eq. 3 and sections 4.1 and 5, Appendix A.2, and
from its public code (github.com/fundamentalvision/Deformable-DETR:
``models/deformable_transformer.py``, ``models/ops/modules/
ms_deform_attn.py``, ``models/ops/functions/ms_deform_attn_func.py``
``ms_deform_attn_core_pytorch``, ``models/deformable_detr.py``,
``models/position_encoding.py``) in plain ``torch`` calls: the trunk through
`reference.detector`'s ResNet-50, the sampling core as
``ms_deform_attn_core_pytorch`` (``F.grid_sample`` once a level), the
decoder's self-attention as ``nn.MultiheadAttention``'s arithmetic written
out, post-norm layers, dropout off. Nothing of the program is imported, and
no kernel, cache or batching of it is used. TF32 is off
(`detector.exact_float32`).

``arch`` is the ``resolved`` section of ``port_bench/configs/
deformable_detr_r50_coco.json``: ``model``, ``eval`` and ``deformable``.
Weights are a dict keyed by the program's ``state_dict`` names, which are
the public code's.

Departures from the paper and its code, all of them the benchmark's:
- images are served on a 1088 x 1088 canvas (the code pads each batch to
  its largest image); where the padding ends changes nothing that an image's
  extent does not, but GroupNorm's statistics, which the code takes over
  the whole map, padding included, as here;
- the weights are seeded (`port_bench.deformable_weights`), not trained;
- the trunk is the repository's ResNet-50: its strided convs pad as XLA's
  "SAME" (torchvision pads 1 on each side), the stem's conv 3 on each side;
- the encoder's reference points take the cell centres as ``arange + 0.5``
  where the code takes ``torch.linspace(0.5, H - 0.5, H)`` (the same
  numbers, within a float32 rounding).

`forward` can also run the correctness controls (`Quant`): the trunk's
convs fake-quantized (`detector.Quant`, calibrated by `calibrate` on the
program's calibration canvases); every matrix product of the transformer
with both inputs rounded to float8 e4m3 or to bfloat16; and each bilinear
sample replaced by its nearest cell. And it runs the check's yardstick
(`yardstick`): the configuration's own precision, its trunk fake-quantized
to 8 bits and every matrix product of the transformer with both inputs
rounded to bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import detector

Tensor = torch.Tensor
Params = Dict[str, Tensor]

TRUNK_CHANNELS = (512, 1024, 2048)
LN_EPS = 1e-5
GN_EPS = 1e-5
POS_TEMPERATURE = 10000.0
POS_EPS = 1e-6
POS_SCALE = 2 * math.pi
INVERSE_SIGMOID_EPS = 1e-5
# float8 e4m3's largest finite value: inputs are clipped to it before the
# cast, which has no saturation of its own.
FP8_MAX = 448.0


# --------------------------------------------------------------------------
# Parameter layout: (name, shape, role), as `port_bench.deformable_weights`
# draws it
# --------------------------------------------------------------------------

def _linear(name: str, cin: int, cout: int, role: str, bias_role: str = "bias"):
    return [(f"{name}.weight", (cout, cin), role), (f"{name}.bias", (cout,), bias_role)]


def _layer_norm(name: str, d: int):
    return [(f"{name}.weight", (d,), "ln_weight"), (f"{name}.bias", (d,), "bias")]


def _msda_spec(name: str, d: int, heads: int, levels: int, points: int):
    return (_linear(f"{name}.sampling_offsets", d, heads * levels * points * 2, "offset",
                    "offset_bias")
            + _linear(f"{name}.attention_weights", d, heads * levels * points, "attn_logit")
            + _linear(f"{name}.value_proj", d, d, "linear")
            + _linear(f"{name}.output_proj", d, d, "msda_out"))


def param_spec(arch) -> List[Tuple[str, tuple, str]]:
    """The trunk's leaves are `detector`'s ResNet-50; then the input
    projections with their GroupNorms, the transformer, the query embedding
    and the heads under the public code's names."""
    c, classes = arch["deformable"], arch["model"]["num_classes"]
    d, ffn, heads, levels = c["d_model"], c["ffn"], c["heads"], c["levels"]
    spec = detector._resnet_spec()
    for level in range(levels):
        cin, k = (TRUNK_CHANNELS[level], 1) if level < len(TRUNK_CHANNELS) \
            else (TRUNK_CHANNELS[-1], 3)
        spec += [(f"input_proj.{level}.0.weight", (d, cin, k, k), "linear"),
                 (f"input_proj.{level}.0.bias", (d,), "bias"),
                 (f"input_proj.{level}.1.weight", (d,), "ln_weight"),
                 (f"input_proj.{level}.1.bias", (d,), "bias")]
    spec.append(("transformer.level_embed", (levels, d), "embed"))
    for i in range(c["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        spec += _msda_spec(f"{n}.self_attn", d, heads, levels, c["enc_points"])
        spec += _layer_norm(f"{n}.norm1", d)
        spec += _linear(f"{n}.linear1", d, ffn, "relu") + _linear(f"{n}.linear2", ffn, d, "linear")
        spec += _layer_norm(f"{n}.norm2", d)
    for i in range(c["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        spec += _msda_spec(f"{n}.cross_attn", d, heads, levels, c["dec_points"])
        spec += _layer_norm(f"{n}.norm1", d)
        spec += [(f"{n}.self_attn.in_proj_weight", (3 * d, d), "attn_in"),
                 (f"{n}.self_attn.in_proj_bias", (3 * d,), "bias")]
        spec += _linear(f"{n}.self_attn.out_proj", d, d, "linear")
        spec += _layer_norm(f"{n}.norm2", d)
        spec += _linear(f"{n}.linear1", d, ffn, "relu") + _linear(f"{n}.linear2", ffn, d, "linear")
        spec += _layer_norm(f"{n}.norm3", d)
    spec += _linear("transformer.reference_points", d, 2, "linear")
    spec.append(("query_embed.weight", (c["queries"], 2 * d), "embed"))
    spec += _linear("class_embed", d, classes, "cls", "cls_prior")
    spec += _linear("bbox_embed.layers.0", d, d, "relu") + _linear("bbox_embed.layers.1", d, d,
                                                                   "relu")
    spec += _linear("bbox_embed.layers.2", d, 4, "box")
    return spec


# --------------------------------------------------------------------------
# The controls
# --------------------------------------------------------------------------

class Quant:
    """A control or the yardstick: the trunk fake-quantized by ``trunk`` (a
    `detector.Quant`, or None for float32); both inputs of every matrix
    product of the transformer rounded to ``products`` (float8 e4m3 or
    bfloat16; None keeps float32); with ``nearest`` each bilinear sample
    replaced by its nearest cell."""

    def __init__(self, trunk: Optional[detector.Quant], products: Optional[torch.dtype] = None,
                 nearest: bool = False):
        self.trunk = trunk
        self.products = products
        self.nearest = nearest


def _rounded(x: Tensor, dtype: torch.dtype) -> Tensor:
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-FP8_MAX, FP8_MAX)  # the cast has no saturation of its own
    return x.to(dtype).to(torch.float32)


class _Products:
    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.dtype is not None:
            a, b = _rounded(a, self.dtype), _rounded(b, self.dtype)
        return torch.matmul(a, b)

    def linear(self, x: Tensor, p: Params, name: str) -> Tensor:
        return self.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def canvas_mask(extents: Tensor, h: int, w: int) -> Tensor:
    """(B, 2) extents (h, w) -> (B, h, w) bool, True beyond the extent."""
    ys = torch.arange(h, device=extents.device)[None, :, None]
    xs = torch.arange(w, device=extents.device)[None, None, :]
    return (ys >= extents[:, 0, None, None]) | (xs >= extents[:, 1, None, None])


def position_encoding(mask: Tensor, d_model: int) -> Tensor:
    """Deformable DETR's ``PositionEmbeddingSine(d_model / 2, 10000,
    normalize=True)`` of a (B, H, W) mask, verbatim -> (B, d_model, H, W)."""
    feats = d_model // 2
    not_mask = ~mask
    y_embed = not_mask.cumsum(1, dtype=torch.float32)
    x_embed = not_mask.cumsum(2, dtype=torch.float32)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + POS_EPS) * POS_SCALE
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + POS_EPS) * POS_SCALE
    dim_t = torch.arange(feats, dtype=torch.float32, device=mask.device)
    dim_t = POS_TEMPERATURE ** (2 * (dim_t // 2) / feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def valid_ratio(mask: Tensor) -> Tensor:
    """``DeformableTransformer.get_valid_ratio``: (B, 2) (w, h)."""
    _, h, w = mask.shape
    valid_h = torch.sum(~mask[:, :, 0], 1)
    valid_w = torch.sum(~mask[:, 0, :], 1)
    return torch.stack([valid_w.float() / w, valid_h.float() / h], -1)


def encoder_reference_points(shapes: List[Tuple[int, int]], ratios: Tensor) -> Tensor:
    """``DeformableTransformerEncoder.get_reference_points``."""
    points = []
    for level, (h, w) in enumerate(shapes):
        ref_y, ref_x = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=ratios.device),
            torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=ratios.device),
            indexing="ij")
        ref_y = ref_y.reshape(-1)[None] / (ratios[:, None, level, 1] * h)
        ref_x = ref_x.reshape(-1)[None] / (ratios[:, None, level, 0] * w)
        points.append(torch.stack((ref_x, ref_y), -1))
    return torch.cat(points, 1)[:, :, None] * ratios[:, None]


def ms_deform_attn_core(value: Tensor, shapes: List[Tuple[int, int]], locations: Tensor,
                        weights: Tensor, mode: str = "bilinear") -> Tensor:
    """``ms_deform_attn_core_pytorch``: value (N, S, M, D), locations (N,
    Lq, M, L, P, 2) in [0, 1], weights (N, Lq, M, L, P) -> (N, Lq, M * D);
    ``mode="nearest"`` is the ``sampling_nearest`` control."""
    n, _, m, dh = value.shape
    _, lq, _, n_levels, n_points, _ = locations.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * locations - 1
    sampled = []
    for level, (h, w) in enumerate(shapes):
        value_l = value_list[level].flatten(2).transpose(1, 2).reshape(n * m, dh, h, w)
        grid_l = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(value_l, grid_l, mode=mode, padding_mode="zeros",
                                     align_corners=False))
    weights = weights.transpose(1, 2).reshape(n * m, 1, lq, n_levels * n_points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1).view(n, m * dh, lq)
    return out.transpose(1, 2).contiguous()


def _msda(mp: _Products, p: Params, name: str, query: Tensor, ref: Tensor, x: Tensor,
          shapes: List[Tuple[int, int]], pad: Tensor, heads: int, points: int,
          mode: str) -> Tensor:
    """``MSDeformAttn.forward`` with 2-d reference points."""
    n, lq, d = query.shape
    n_levels = len(shapes)
    value = mp.linear(x, p, f"{name}.value_proj")
    value = value.masked_fill(pad[..., None], 0.0).view(n, x.shape[1], heads, d // heads)
    offsets = mp.linear(query, p, f"{name}.sampling_offsets").view(n, lq, heads, n_levels,
                                                                   points, 2)
    weights = mp.linear(query, p, f"{name}.attention_weights").view(n, lq, heads,
                                                                    n_levels * points)
    weights = F.softmax(weights, -1).view(n, lq, heads, n_levels, points)
    normalizer = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                              device=query.device)
    locations = ref[:, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
    out = ms_deform_attn_core(value, shapes, locations, weights, mode)
    return mp.linear(out, p, f"{name}.output_proj")


def _mha(mp: _Products, p: Params, name: str, qk: Tensor, value: Tensor, heads: int) -> Tensor:
    """``nn.MultiheadAttention`` (batch first, no mask, dropout off)."""
    w, bias = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    b, lq, d = qk.shape
    dh = d // heads
    q = (mp.mm(qk, w[:d].t()) + bias[:d]) * (float(dh) ** -0.5)
    k = mp.mm(qk, w[d:2 * d].t()) + bias[d:2 * d]
    v = mp.mm(value, w[2 * d:].t()) + bias[2 * d:]
    q, k, v = (t.reshape(b, lq, heads, dh).transpose(1, 2) for t in (q, k, v))
    out = mp.mm(torch.softmax(mp.mm(q, k.transpose(-1, -2)), dim=-1), v)
    return mp.linear(out.transpose(1, 2).reshape(b, lq, d), p, f"{name}.out_proj")


def _norm(x: Tensor, p: Params, name: str) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _ffn(mp: _Products, p: Params, name: str, x: Tensor) -> Tensor:
    return mp.linear(F.relu(mp.linear(x, p, f"{name}.linear1")), p, f"{name}.linear2")


def inverse_sigmoid(x: Tensor, eps: float = INVERSE_SIGMOID_EPS) -> Tensor:
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def forward(params: Params, images_u8: Tensor, extents: Tensor, arch,
            quant: Optional[Quant] = None) -> Tuple[Tensor, Tensor]:
    """(B, S, S, 3) uint8 canvases and (B, 2) extents (h, w) -> (logits
    (B, Q, C), boxes (B, Q, 4) cx, cy, w, h in [0, 1] of the extent),
    float32."""
    c = arch["deformable"]
    heads, d = c["heads"], c["d_model"]
    p = params
    mp = _Products(quant.products if quant is not None else None)
    mode = "nearest" if quant is not None and quant.nearest else "bilinear"
    x = detector.normalize_u8(images_u8)
    b, _, h, w = x.shape
    mask = canvas_mask(extents.to(x.device), h, w)
    x = x * (~mask)[:, None].to(x.dtype)
    r = detector._Run(p, quant.trunk if quant is not None else None)
    feats = detector._resnet(r, x)
    srcs, masks = [], []
    for level in range(c["levels"]):
        n = f"input_proj.{level}"
        if level < len(feats):
            y = F.conv2d(feats[level], p[f"{n}.0.weight"], p[f"{n}.0.bias"])
        else:
            y = F.conv2d(feats[-1], p[f"{n}.0.weight"], p[f"{n}.0.bias"], stride=2, padding=1)
        srcs.append(F.group_norm(y, c["gn_groups"], p[f"{n}.1.weight"], p[f"{n}.1.bias"],
                                 GN_EPS))
        masks.append(F.interpolate(mask[None].float(), size=y.shape[-2:]).to(torch.bool)[0])
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    pos = [position_encoding(m, d).flatten(2).transpose(1, 2) + p["transformer.level_embed"][lv]
           for lv, m in enumerate(masks)]
    src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    pos = torch.cat(pos, 1)
    pad = torch.cat([m.flatten(1) for m in masks], 1)
    ratios = torch.stack([valid_ratio(m) for m in masks], 1)
    ref = encoder_reference_points(shapes, ratios)
    for i in range(c["enc_layers"]):
        n = f"transformer.encoder.layers.{i}"
        src = _norm(src + _msda(mp, p, f"{n}.self_attn", src + pos, ref, src, shapes, pad,
                                heads, c["enc_points"], mode), p, f"{n}.norm1")
        src = _norm(src + _ffn(mp, p, n, src), p, f"{n}.norm2")
    memory = src
    query_pos, tgt = torch.split(p["query_embed.weight"], d, dim=1)
    query_pos = query_pos[None].expand(b, -1, -1)
    tgt = tgt[None].expand(b, -1, -1)
    ref = (query_pos @ p["transformer.reference_points.weight"].t()
           + p["transformer.reference_points.bias"]).sigmoid()
    ref_in = ref[:, :, None] * ratios[:, None]
    for i in range(c["dec_layers"]):
        n = f"transformer.decoder.layers.{i}"
        qk = tgt + query_pos
        tgt = _norm(tgt + _mha(mp, p, f"{n}.self_attn", qk, tgt, heads), p, f"{n}.norm2")
        tgt = _norm(tgt + _msda(mp, p, f"{n}.cross_attn", tgt + query_pos, ref_in, memory,
                                shapes, pad, heads, c["dec_points"], mode), p, f"{n}.norm1")
        tgt = _norm(tgt + _ffn(mp, p, n, tgt), p, f"{n}.norm3")
    logits = tgt @ p["class_embed.weight"].t() + p["class_embed.bias"]
    y = tgt
    for i in range(3):
        y = y @ p[f"bbox_embed.layers.{i}.weight"].t() + p[f"bbox_embed.layers.{i}.bias"]
        if i < 2:
            y = F.relu(y)
    y = torch.cat([y[..., :2] + inverse_sigmoid(ref), y[..., 2:]], -1)
    return logits, y.sigmoid()


def outputs(params: Params, images_u8: Tensor, extents: Tensor, arch,
            quant: Optional[Quant] = None) -> Tuple[Tensor, Tensor]:
    """`forward` in exact float32 (the controls' and the yardstick's roundings
    aside), without autograd."""
    with torch.no_grad(), detector.exact_float32():
        return forward(params, images_u8, extents, arch, quant)


def postprocess(logits: Tensor, boxes: Tensor, extents: Tensor,
                top_k: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``PostProcess``: the ``top_k`` best sigmoid scores over each image's
    (query, class) pairs -> (boxes (B, k, 4) corners in pixels of each
    image's extent, scores (B, k), labels (B, k), queries (B, k))."""
    b, _, c = logits.shape
    prob = logits.sigmoid()
    scores, index = torch.topk(prob.view(b, -1), top_k, dim=1)
    queries = index // c
    labels = index % c
    cx, cy, w, h = boxes.unbind(-1)
    corners = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
    corners = torch.gather(corners, 1, queries.unsqueeze(-1).repeat(1, 1, 4))
    img_h, img_w = extents.to(corners.dtype).unbind(1)
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return corners * scale[:, None, :], scores, labels, queries


def calibrate(params: Params, images_u8: Tensor, extents: Tensor, arch, bits: int,
              products: Optional[torch.dtype] = None, nearest: bool = False) -> Quant:
    """A control: the trunk fake-quantized to ``bits``, its activation
    ranges read on these canvases; the transformer's products on inputs
    rounded to ``products`` (None keeps float32); with ``nearest`` the
    nearest-cell sampling."""
    q = detector.Quant(bits)
    q.recording = {}
    with torch.no_grad(), detector.exact_float32():
        forward(params, images_u8, extents, arch, Quant(q))
    q.act_max, q.recording = q.recording, None
    return Quant(q, products, nearest)


def yardstick(params: Params, images_u8: Tensor, extents: Tensor, arch) -> Quant:
    """The check's yardstick, the configuration's precision: the trunk
    fake-quantized to 8 bits (its activation ranges read on these canvases,
    the program's calibration batch), every product of the transformer on
    bfloat16 inputs."""
    return calibrate(params, images_u8, extents, arch, 8, torch.bfloat16)


def macs_per_image(arch) -> int:
    """The trunk's conv multiply-adds on one whole canvas, counted on the
    meta device."""
    params = {name: torch.empty(shape, device="meta") for name, shape, _ in param_spec(arch)}
    s = arch["model"]["image_size"]
    r = detector._Run(params, None)
    detector._resnet(r, torch.empty((1, 3, s, s), device="meta"))
    return int(r.macs)
