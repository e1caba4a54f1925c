"""DETR (arXiv:2005.12872): a ResNet-50 trunk, a transformer encoder over its
C5 tokens, a decoder of learned object queries, and per-query class and box
heads. No anchors and no NMS.

The layer equations are the paper's (section 3.2, Fig. 2) and its public
code's (``models/transformer.py``, ``position_encoding.py``, ``detr.py``):
post-norm layers, dropout off.

  encoder layer:  q = k = src + pos
                  src = LN1(src + MHA(q, k, src, key_padding_mask))
                  src = LN2(src + W2 relu(W1 src + b1) + b2)
  decoder layer:  tgt = LN1(tgt + MHA(tgt + query_pos, tgt + query_pos, tgt))
                  tgt = LN2(tgt + MHA(tgt + query_pos, memory + pos, memory,
                                      key_padding_mask))
                  tgt = LN3(tgt + FFN(tgt))

``tgt`` starts at zeros, ``query_pos`` is the learned (queries, d_model)
embedding, and a last LayerNorm precedes the heads: ``class_embed``
(num_classes + 1 logits, the last "no object") and ``bbox_embed`` (an MLP
of three layers with ReLUs, then a sigmoid: cx, cy, w, h relative to the
image's extent).

Images are served padded on a square canvas, each with its extent (h, w)
at the top left (DETR's ``NestedTensor``). The padding is zero after
normalization, the mask of a feature map is the canvas mask interpolated to
it (nearest), and the sine position encoding counts unmasked cells, so
every position depends on where its image ends.

Parameter names follow DETR's where the module is DETR's own
(``transformer.encoder.layers.0.self_attn.in_proj_weight``, ``input_proj``,
``query_embed``, ``class_embed``, ``bbox_embed.layers.0``); the trunk is
the port's ResNet-50 (``backbone.stage4_block2.conv2.weight``).

While a profiler records, every multi-head attention core (QK^T, the masked
softmax and PV, without the projections) runs under the span
``odt.detr.attention`` (`utils.profiling`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.kernels.attention import masked_attention
from object_detector_tpu_torch.models.resnet import ResNet50Backbone
from object_detector_tpu_torch.models.ssd import _dtype
from object_detector_tpu_torch.models.vgg import Conv
from object_detector_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# ResNet-50's C5 width.
C5_CHANNELS = 2048
LAYER_NORM_EPS = 1e-5
# PositionEmbeddingSine(normalize=True): its temperature, and the scale and
# the epsilon of the normalization by the image's extent.
POS_TEMPERATURE = 10000.0
POS_SCALE = 2 * math.pi
POS_EPS = 1e-6
# Unmasked C5 tokens a predict call, counted while a profiler records.
VALID_TOKENS = "odt.detr.valid_tokens"


def trunk_feature_size(size: int, dilate_c5: bool) -> int:
    """The side of the ResNet-50 trunk's C5 on a ``size`` canvas: the
    stem's conv and pool and stages 2 to 4 each halve it, rounding up
    (stage 4 not under DC5)."""
    for _ in range(4 if dilate_c5 else 5):
        size = -(-size // 2)
    return size


def valid_tokens(extents: Tensor, canvas: Tuple[int, int], feature_hw: Tuple[int, int]) -> int:
    """Unmasked cells of the ``feature_hw`` maps of images with these (B, 2)
    extents, from `feature_mask`."""
    return int((~feature_mask(extents, canvas, feature_hw)).sum())


def feature_mask(extents: Tensor, canvas: Tuple[int, int], feature_hw: Tuple[int, int]) -> Tensor:
    """(B, 2) extents (h, w) on a ``canvas`` -> (B, Hf, Wf) bool, True where
    a feature cell is padding: the canvas mask (True beyond the extent)
    interpolated to ``feature_hw`` (nearest), as DETR's
    ``F.interpolate(mask[None].float(), size=...).bool()``. Nearest
    interpolation samples rows and columns apart, so the two axes are
    interpolated apart and joined."""
    extents = extents.to(torch.int64)
    axes = []
    for axis in (0, 1):
        pad = (torch.arange(canvas[axis], device=extents.device)[None]
               >= extents[:, axis:axis + 1])  # (B, canvas)
        axes.append(F.interpolate(pad[:, None].float(), size=feature_hw[axis],
                                  mode="nearest")[:, 0].bool())
    return axes[0][:, :, None] | axes[1][:, None, :]


def sine_position(mask: Tensor, d_model: int, offset: float = 0.0) -> Tensor:
    """DETR's ``PositionEmbeddingSine(d_model / 2, 10000, normalize=True,
    scale=2 pi)`` of a (B, H, W) padding mask -> (B, H*W, d_model) float32:
    y then x, each d_model / 2 features of interleaved sin and cos. Each
    count of unmasked cells is less ``offset`` before it is normalized
    (Deformable DETR's encoding takes 0.5)."""
    feats = d_model // 2
    not_mask = (~mask).to(torch.float32)
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y_last, x_last = y[:, -1:, :], x[:, :, -1:]
    if offset:
        y, x = y - offset, x - offset
    y = y / (y_last + POS_EPS) * POS_SCALE
    x = x / (x_last + POS_EPS) * POS_SCALE
    dim_t = torch.arange(feats, dtype=torch.float32, device=mask.device)
    dim_t = POS_TEMPERATURE ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / feats)

    def encode(e: Tensor) -> Tensor:
        p = e[..., None] / dim_t
        return torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), dim=4).flatten(3)

    b, h, w = mask.shape
    return torch.cat((encode(y), encode(x)), dim=3).reshape(b, h * w, d_model)


def attend(q: Tensor, k: Tensor, v: Tensor, heads: int, key_pad: Optional[Tensor]) -> Tensor:
    """The attention core of one multi-head attention: (B, Lq, d) queries
    and (B, Lk, d) keys and values, already projected, -> (B, Lq, d);
    scale 1/sqrt(d / heads); ``key_pad`` (B, Lk) True where a key is
    padding and takes no part. `kernels.attention.masked_attention`: the
    hand-written kernel over each image's unmasked keys on the card, its
    plain version on the CPU."""
    with span("odt.detr.attention"):
        return masked_attention(q, k, v, heads, key_pad)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters and math (batch first): a
    packed in-projection with bias (q, k, v rows in that order), the
    attention of `attend`, and the out-projection. Where the query and the
    key are one tensor their projections are one product."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query: Tensor, key: Tensor, value: Tensor,
                key_pad: Optional[Tensor] = None) -> Tensor:
        d = query.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        if query is key:
            q, k = F.linear(query, w[:2 * d], b[:2 * d]).chunk(2, dim=-1)
        else:
            q = F.linear(query, w[:d], b[:d])
            k = F.linear(key, w[d:2 * d], b[d:2 * d])
        v = F.linear(value, w[2 * d:], b[2 * d:])
        return self.out_proj(attend(q, k, v, self.heads, key_pad))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, heads)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, src: Tensor, pos: Tensor, key_pad: Tensor) -> Tensor:
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, key_pad))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, heads)
        self.multihead_attn = MultiheadAttention(d_model, heads)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, tgt: Tensor, query_pos: Tensor, memory: Tensor, memory_pos: Tensor,
                key_pad: Tensor) -> Tensor:
        """``memory_pos`` is ``memory + pos``, the same for every layer."""
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory_pos, memory, key_pad))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Encoder(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, heads, ffn) for _ in range(layers))

    def forward(self, src: Tensor, pos: Tensor, key_pad: Tensor) -> Tensor:
        for layer in self.layers:
            src = layer(src, pos, key_pad)
        return src


class Decoder(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d_model, heads, ffn) for _ in range(layers))
        self.norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, query_pos: Tensor, memory: Tensor, pos: Tensor, key_pad: Tensor) -> Tensor:
        """(Q, d) query embedding over (B, L, d) memory -> (B, Q, d), the
        last layer's output after the final LayerNorm."""
        b = memory.shape[0]
        query_pos = query_pos[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        memory_pos = memory + pos
        for layer in self.layers:
            tgt = layer(tgt, query_pos, memory, memory_pos, key_pad)
        return self.norm(tgt)


class Transformer(nn.Module):
    def __init__(self, d_model: int, heads: int, ffn: int, enc_layers: int, dec_layers: int):
        super().__init__()
        self.encoder = Encoder(d_model, heads, ffn, enc_layers)
        self.decoder = Decoder(d_model, heads, ffn, dec_layers)


class MLP(nn.Module):
    """Linear layers with a ReLU between each two (DETR's ``MLP``)."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: Tensor) -> Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


def project_nhwc(input_proj: Conv, c5: Tensor) -> Tensor:
    """(B, Hf, Wf, 2048) C5 -> (B, Hf*Wf, d) tokens in (y, x) order: the 1x1
    ``input_proj`` as one product in the C5's dtype."""
    b, h, w, c = c5.shape
    weight = input_proj.weight.reshape(input_proj.weight.shape[0], c).to(c5.dtype)
    return F.linear(c5.reshape(b, h * w, c), weight, input_proj.bias.to(c5.dtype))


class DETRModel(nn.Module):
    """The float DETR: (B, S, S, 3) normalized canvases, zero beyond each
    image's extent, and (B, 2) extents (h, w) -> (logits (B, Q, C + 1),
    boxes (B, Q, 4) cx, cy, w, h in [0, 1] of the extent), both float32.
    The trunk, ``input_proj`` and the transformer run in
    ``cfg.model.compute_dtype``, the heads in float32: the transformer's
    parameters are held in the compute dtype (a state dict loads into them
    rounded), the rest in float32."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        t = config.transformer
        self.config = config
        self.compute_dtype = _dtype(config.model.compute_dtype)
        self.backbone = ResNet50Backbone(dilate_c5=t.dilate_c5)
        self.input_proj = Conv(C5_CHANNELS, t.d_model, 1)
        self.transformer = Transformer(t.d_model, t.heads, t.ffn, t.enc_layers, t.dec_layers)
        self.query_embed = nn.Embedding(t.queries, t.d_model)
        self.class_embed = nn.Linear(t.d_model, config.model.num_classes + 1)
        self.bbox_embed = MLP((t.d_model, t.d_model, t.d_model, 4))
        self.hold_transformer_in(self.compute_dtype)

    def hold_transformer_in(self, dtype: torch.dtype) -> None:
        """The transformer's parameters in ``dtype``."""
        self.transformer.to(dtype)

    def forward(self, images: Tensor, extents: Tensor) -> Tuple[Tensor, Tensor]:
        dtype = self.compute_dtype
        with span("odt.detr.backbone"):
            c5 = self.backbone(images.permute(0, 3, 1, 2).to(dtype))[-1]
            src = project_nhwc(self.input_proj, c5.permute(0, 2, 3, 1))
        return self.transform(src, extents, tuple(images.shape[1:3]), tuple(c5.shape[2:]), dtype)

    def transform(self, src: Tensor, extents: Tensor, canvas: Tuple[int, int],
                  feature_hw: Tuple[int, int], dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """The model after ``input_proj``: (B, L, d) tokens in ``dtype``
        and the images' (B, 2) extents on the ``canvas`` -> (logits, boxes)
        as `forward` gives them; the mask and positions of the
        ``feature_hw`` map, the encoder and decoder in ``dtype`` (the
        modules' own), the heads in float32. The float model and the int8
        engine share it."""
        t = self.transformer
        with span("odt.detr.encoder"):
            mask = feature_mask(extents.to(src.device), canvas, feature_hw)
            key_pad = mask.flatten(1)
            pos = sine_position(mask, src.shape[-1]).to(dtype)
            memory = t.encoder(src, pos, key_pad)
        with span("odt.detr.decoder"):
            hs = t.decoder(self.query_embed.weight.to(dtype), memory, pos, key_pad)
        with span("odt.detr.heads"):
            hs = hs.float()
            return self.class_embed(hs), self.bbox_embed(hs).sigmoid()
