"""Deformable DETR (arXiv:2010.04159), single-stage, without iterative box
refinement: a ResNet-50 trunk whose C3, C4 and C5 and a stride-2 conv on C5
give four token levels, a transformer encoder of multi-scale deformable
attention over all of them, a decoder of learned queries that samples them
the same way, and per-query class and box heads. No anchors and no NMS.

The layer equations are the public code's (github.com/fundamentalvision/
Deformable-DETR: ``models/deformable_transformer.py``,
``models/ops/modules/ms_deform_attn.py``, ``models/deformable_detr.py``,
``models/position_encoding.py``): post-norm layers, dropout off.

  levels:        src_l = GN_l(Conv1x1_l(C_{l+3})), l = 0, 1, 2;
                 src_3 = GN_3(Conv3x3/s2/p1(C5)); GroupNorm over the whole
                 map, padding included; mask_l the canvas mask interpolated
                 to level l (nearest), pos_l its sine encoding (counts less
                 0.5) plus ``level_embed[l]``
  MSDA(z, p, x): V = value_proj(x), padded tokens 0; for each head, level
                 and point, offset and softmax weight from z; the sum of the
                 weights times V sampled bilinearly at p + offset / (W, H)
                 (`kernels.msda`); then output_proj
  encoder layer: src = LN1(src + MSDA(src + pos, ref, src))
                 src = LN2(src + W2 relu(W1 src + b1) + b2)
  decoder layer: tgt = LN2(tgt + MHA(tgt + qpos, tgt + qpos, tgt))
                 tgt = LN1(tgt + MSDA(tgt + qpos, ref, memory))
                 tgt = LN3(tgt + FFN(tgt))

The encoder's reference points are the cells' centres over each level's
valid extent, times every level's valid ratio; the decoder's are
``sigmoid(reference_points(query_pos))`` times the valid ratios, the same
for every layer. The heads take the last decoder layer: ``class_embed``
(91 logits, sigmoid scores) and ``bbox_embed`` (an MLP of three layers) to
which the reference's inverse sigmoid is added before the sigmoid: cx, cy,
w, h relative to the image's extent.

Images are served padded on a square canvas, each with its extent (h, w)
at the top left, as DETR's (`models.detr`). Parameter names follow the
public code's (``transformer.encoder.layers.0.self_attn.sampling_offsets``,
``input_proj.0.1`` the first level's GroupNorm, ``query_embed``); the
trunk is the port's ResNet-50.

While a profiler records, every launch of the sampling core runs under the
span ``odt.deformable.sampling``, the model's stages under
``odt.deformable.backbone``, ``.encoder``, ``.decoder`` and ``.heads``
(`utils.profiling`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.kernels.msda import msda
from object_detector_tpu_torch.models.detr import (LAYER_NORM_EPS, MLP, MultiheadAttention,
                                                   feature_mask, sine_position)
from object_detector_tpu_torch.models.resnet import ResNet50Backbone
from object_detector_tpu_torch.models.ssd import _dtype
from object_detector_tpu_torch.models.vgg import Conv
from object_detector_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
Shapes = Tuple[Tuple[int, int], ...]

# ResNet-50's C3, C4, C5 widths, the taps of the first three levels.
TRUNK_CHANNELS = (512, 1024, 2048)
GROUP_NORM_EPS = 1e-5
# The position encoding's offset of each count of unmasked cells.
POS_OFFSET = 0.5
# ``inverse_sigmoid``'s clamp.
INVERSE_SIGMOID_EPS = 1e-5
# Unmasked tokens over the levels a predict call, counted while a profiler records.
VALID_TOKENS = "odt.deformable.valid_tokens"


def level_side(size: int, level: int) -> int:
    """The side of level ``level`` on a ``size`` canvas side: C3 at stride
    8 and each further level half the one before, rounding up (the trunk's
    strided convs and the 3x3/s2/p1 conv on C5 alike)."""
    for _ in range(3 + level):
        size = -(-size // 2)
    return size


def level_shapes(canvas: Tuple[int, int], levels: int) -> Shapes:
    return tuple((level_side(canvas[0], lv), level_side(canvas[1], lv)) for lv in range(levels))


def level_masks(extents: Tensor, canvas: Tuple[int, int], shapes: Shapes) -> List[Tensor]:
    """(B, h_l, w_l) bool masks, True on padding: the canvas mask
    interpolated to each level (`models.detr.feature_mask`)."""
    return [feature_mask(extents, canvas, hw) for hw in shapes]


def valid_tokens(extents: Tensor, canvas: Tuple[int, int], levels: int) -> int:
    """Unmasked cells of all levels of images with these (B, 2) extents."""
    masks = level_masks(extents, canvas, level_shapes(canvas, levels))
    return int(sum((~m).sum() for m in masks))


def valid_ratios(masks: Sequence[Tensor]) -> Tensor:
    """(B, L, 2) float32 (w, h): each level's unmasked share of its first row
    and its first column (the public code's ``get_valid_ratio``)."""
    ratios = []
    for m in masks:
        _, h, w = m.shape
        ratios.append(torch.stack([(~m[:, 0, :]).sum(1).float() / w,
                                   (~m[:, :, 0]).sum(1).float() / h], -1))
    return torch.stack(ratios, 1)


def encoder_reference_points(shapes: Shapes, ratios: Tensor) -> Tensor:
    """(B, sum H W, L, 2) float32: each token's cell centre (x, y) over its
    level's valid extent, ``((j + 0.5) / (ratio_w W), (i + 0.5) / (ratio_h
    H))``, times every level's valid ratio."""
    dev = ratios.device
    points = []
    for level, (h, w) in enumerate(shapes):
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(h, w)
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(h, w)
        x = xs.reshape(-1)[None] / (ratios[:, None, level, 0] * w)
        y = ys.reshape(-1)[None] / (ratios[:, None, level, 1] * h)
        points.append(torch.stack((x, y), -1))
    return torch.cat(points, 1)[:, :, None] * ratios[:, None]


def inverse_sigmoid(x: Tensor, eps: float = INVERSE_SIGMOID_EPS) -> Tensor:
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def group_norm_tokens(x: Tensor, groups: int, weight: Tensor, bias: Tensor) -> Tensor:
    """GroupNorm of (B, N, C) tokens over all N and each group's channels,
    statistics and affine in float32, the result in x's dtype."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(b, n, c)
    return (y * weight.float() + bias.float()).to(x.dtype)


def linear_f32(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """``x @ weight^T + bias`` with float32 sums and a float32 result: on the
    card one GEMM in x's dtype with a float32 output, on the CPU the same
    products in float32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype != torch.float32:
        y = torch.addmm(bias.float(), x2, weight.to(x.dtype).t(), out_dtype=torch.float32)
    else:
        y = torch.addmm(bias.float(), x2.float(), weight.float().t())
    return y.reshape(*x.shape[:-1], -1)


class MSDeformAttn(nn.Module):
    """The public code's ``MSDeformAttn``: offsets and attention-weight
    logits from the query (one product with a float32 result), values from
    the input with padded tokens zeroed, the sampling core of
    `kernels.msda`, and the output projection."""

    def __init__(self, d_model: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads = heads
        self.sampling_offsets = nn.Linear(d_model, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d_model, heads * levels * points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: Tensor, ref: Tensor, x: Tensor, shapes: Shapes,
                key_pad: Optional[Tensor], query_pad: Optional[Tensor] = None) -> Tensor:
        b, length, d = x.shape
        value = self.value_proj(x)
        if key_pad is not None:
            value.masked_fill_(key_pad[..., None], 0.0)
        n_off = self.sampling_offsets.out_features
        both = linear_f32(query,
                          torch.cat([self.sampling_offsets.weight, self.attention_weights.weight]),
                          torch.cat([self.sampling_offsets.bias, self.attention_weights.bias]))
        with span("odt.deformable.sampling"):
            out = msda(value.view(b, length, self.heads, d // self.heads), shapes, ref,
                       both[..., :n_off], both[..., n_off:], query_pad)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, levels: int, points: int):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, heads, levels, points)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, src: Tensor, pos: Tensor, ref: Tensor, shapes: Shapes,
                pad: Tensor) -> Tensor:
        """A padded token's row is computed by no one: its sampled sum is
        zero (its value takes part in nothing anyway)."""
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes, pad, query_pad=pad))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, levels: int, points: int):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, heads, levels, points)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.self_attn = MultiheadAttention(d_model, heads)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, tgt: Tensor, query_pos: Tensor, ref: Tensor, memory: Tensor,
                shapes: Shapes, pad: Tensor) -> Tensor:
        qk = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, ref, memory, shapes, pad))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class _Layers(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, enc_layers: int, dec_layers: int,
                 levels: int, enc_points: int, dec_points: int):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(levels, d_model))
        self.encoder = _Layers([EncoderLayer(d_model, heads, ffn, levels, enc_points)
                                for _ in range(enc_layers)])
        self.decoder = _Layers([DecoderLayer(d_model, heads, ffn, levels, dec_points)
                                for _ in range(dec_layers)])
        self.reference_points = nn.Linear(d_model, 2)


class DeformableDETRModel(nn.Module):
    """The float Deformable DETR: (B, S, S, 3) normalized canvases, zero
    beyond each image's extent, and (B, 2) extents (h, w) -> (logits (B, Q,
    C), boxes (B, Q, 4) cx, cy, w, h in [0, 1] of the extent), both float32.
    The trunk, the input projections and the transformer run in
    ``cfg.model.compute_dtype`` (GroupNorm and LayerNorm statistics, the
    offsets, the softmax weights and the sampling in float32), the heads and
    the decoder's reference points in float32: the transformer's other
    parameters are held in the compute dtype, the rest in float32."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        c = config.deformable
        self.config = config
        self.compute_dtype = _dtype(config.model.compute_dtype)
        self.backbone = ResNet50Backbone()
        proj = [nn.Sequential(Conv(cin, c.d_model, 1), nn.GroupNorm(c.gn_groups, c.d_model))
                for cin in TRUNK_CHANNELS]
        proj.append(nn.Sequential(Conv(TRUNK_CHANNELS[-1], c.d_model, 3, stride=2, padding=1),
                                  nn.GroupNorm(c.gn_groups, c.d_model)))
        self.input_proj = nn.ModuleList(proj)
        self.transformer = DeformableTransformer(c.d_model, c.heads, c.ffn, c.enc_layers,
                                                 c.dec_layers, c.levels, c.enc_points,
                                                 c.dec_points)
        self.query_embed = nn.Embedding(c.queries, 2 * c.d_model)
        self.class_embed = nn.Linear(c.d_model, config.model.num_classes)
        self.bbox_embed = MLP((c.d_model, c.d_model, c.d_model, 4))
        self.hold_transformer_in(self.compute_dtype)

    def hold_transformer_in(self, dtype: torch.dtype) -> None:
        """The transformer's parameters in ``dtype``, but its reference
        points' projection in float32."""
        self.transformer.to(dtype)
        self.transformer.reference_points.float()

    def projections(self, dtype: torch.dtype, scales: Sequence[float] = (1.0, 1.0, 1.0)):
        """Each level's conv as (weight, bias) in ``dtype``, its input's
        scale folded into the weight (the int8 taps' scales; 1 for float
        taps): (d, C) for the 1x1 levels, (d, 2048, 3, 3) for the last."""
        out = []
        for level, seq in enumerate(self.input_proj):
            conv = seq[0]
            weight = conv.weight.float() * scales[min(level, len(scales) - 1)]
            if conv.weight.shape[-1] == 1:
                weight = weight.reshape(weight.shape[0], -1)
            out.append((weight.to(dtype), conv.bias.to(dtype)))
        return out

    def levels(self, taps: Sequence[Tensor], projections) -> Tuple[List[Tensor], Shapes]:
        """(B, h, w, C) C3, C4, C5 (values or int8 codes as the projections'
        dtype) -> each level's (B, h_l w_l, d) tokens after its GroupNorm, in
        (y, x) order, and the levels' (h, w)."""
        srcs, shapes = [], []
        for level, seq in enumerate(self.input_proj):
            weight, bias = projections[level]
            if weight.dim() == 2:
                x = taps[level]
                b, h, w, _ = x.shape
                y = F.linear(x.reshape(b, h * w, -1), weight, bias)
            else:
                y = F.conv2d(taps[-1].permute(0, 3, 1, 2), weight, bias, stride=2, padding=1)
                b, _, h, w = y.shape
                y = y.permute(0, 2, 3, 1).reshape(b, h * w, -1)
            gn = seq[1]
            srcs.append(group_norm_tokens(y, gn.num_groups, gn.weight, gn.bias))
            shapes.append((h, w))
        return srcs, tuple(shapes)

    def forward(self, images: Tensor, extents: Tensor) -> Tuple[Tensor, Tensor]:
        dtype = self.compute_dtype
        with span("odt.deformable.backbone"):
            feats = self.backbone(images.permute(0, 3, 1, 2).to(dtype))
            srcs, shapes = self.levels([f.permute(0, 2, 3, 1) for f in feats],
                                       self.projections(dtype))
        return self.transform(srcs, shapes, extents, tuple(images.shape[1:3]), dtype)

    def transform(self, srcs: Sequence[Tensor], shapes: Shapes, extents: Tensor,
                  canvas: Tuple[int, int], dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """The model after the levels: each level's (B, N_l, d) tokens in
        ``dtype`` and the images' (B, 2) extents on the ``canvas`` ->
        (logits, boxes) as `forward` gives them. The float model and the
        int8 engine share it."""
        t = self.transformer
        d = srcs[0].shape[-1]
        with span("odt.deformable.encoder"):
            masks = level_masks(extents.to(srcs[0].device), canvas, shapes)
            ratios = valid_ratios(masks)
            pos = torch.cat([sine_position(m, d, POS_OFFSET) + t.level_embed[lv].float()
                             for lv, m in enumerate(masks)], 1).to(dtype)
            pad = torch.cat([m.flatten(1) for m in masks], 1)
            memory = torch.cat(list(srcs), 1)
            ref = encoder_reference_points(shapes, ratios)
            for layer in t.encoder.layers:
                memory = layer(memory, pos, ref, shapes, pad)
        with span("odt.deformable.decoder"):
            b = memory.shape[0]
            query_pos, tgt = self.query_embed.weight.split(d, dim=1)
            ref = t.reference_points(query_pos.float()).sigmoid()  # (Q, 2)
            ref_in = ref[None, :, None] * ratios[:, None]
            query_pos = query_pos.to(dtype)[None].expand(b, -1, -1)
            tgt = tgt.to(dtype)[None].expand(b, -1, -1)
            for layer in t.decoder.layers:
                tgt = layer(tgt, query_pos, ref_in, memory, shapes, pad)
        with span("odt.deformable.heads"):
            hs = tgt.float()
            box = self.bbox_embed(hs)
            box = torch.cat([box[..., :2] + inverse_sigmoid(ref), box[..., 2:]], -1)
            return self.class_embed(hs), box.sigmoid()
