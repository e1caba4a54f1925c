"""Seeded weights of Deformable DETR, made on the device in a few large draws.

The layout comes from the reference (`reference.deformable_detr.param_spec`),
keyed by the program's ``state_dict`` names; both sides get the same tensors.
The trunk's leaves are drawn as `port_bench.weights` draws a ResNet's. After
it: linear and projection weights at 1/sqrt(fan-in) (He for those that feed a
ReLU), GroupNorm and LayerNorm scales in [0.5, 1.5), every bias N(0,
``bias_std``), the level and query embeddings N(0, 1), as the public code
initializes them. The decoder's self-attention takes its query and key rows
at ``qk_gain`` / sqrt(fan-in), as DETR's (`port_bench.detr_weights`).

Deformable attention's own leaves: the sampling offsets' bias is the
public code's grid (each head's direction, the point's offset (k + 1) cells
along it, on every level), and their weight is drawn at ``offset_gain`` /
sqrt(fan-in) (the code starts it at 0; drawn, the offsets spread over a few
cells around the grid and differ from query to query); the attention-weight
logits at ``attn_gain`` / sqrt(fan-in) (the code starts them at 0, a uniform
softmax). The class head at ``cls_gain`` / sqrt(fan-in), its bias
``cls_bias`` (the code's prior of 0.01: -log(99)), the box head's last layer
at ``box_gain`` / sqrt(fan-in).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench import weights
from port_bench.reference import deformable_detr

NORMAL_ROLES = weights.NORMAL_ROLES + ("embed", "attn_in", "offset", "attn_logit", "msda_out")
UNIFORM_ROLES = weights.UNIFORM_ROLES + ("ln_weight",)
GAINS = {"relu": lambda init: math.sqrt(2.0), "linear": lambda init: 1.0,
         "cls": lambda init: init["cls_gain"], "box": lambda init: init["box_gain"],
         "offset": lambda init: init["offset_gain"], "attn_logit": lambda init: init["attn_gain"],
         "msda_out": lambda init: init["msda_out_gain"]}


def offset_grid(heads: int, levels: int, points: int, device) -> torch.Tensor:
    """The public code's ``sampling_offsets.bias``: head h's direction
    (cos, sin of 2 pi h / heads, scaled so its larger coordinate is 1),
    times k + 1 for point k, on every level; (heads * levels * points * 2,)."""
    thetas = torch.arange(heads, dtype=torch.float32, device=device) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
    grid = grid.repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float32, device=device)[:, None]
    return grid.reshape(-1)


def make_weights(arch, init, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``arch`` from ``seed``. ``init`` is the
    configuration's ``weights`` section: ``cls_gain``, ``box_gain``,
    ``bias_std``, ``qk_gain``, ``offset_gain``, ``attn_gain`` and
    ``cls_bias``."""
    spec = deformable_detr.param_spec(arch)
    c = arch["deformable"]
    gen = torch.Generator(device=device).manual_seed(weights.derive(seed, "weights"))
    n_normal = sum(math.prod(s) for _, s, role in spec if role in NORMAL_ROLES)
    n_uniform = sum(math.prod(s) for _, s, role in spec if role in UNIFORM_ROLES)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    for name, shape, role in spec:
        n = math.prod(shape)
        if role in NORMAL_ROLES:
            leaf = normal[i:i + n].view(shape)
            i += n
        elif role in UNIFORM_ROLES:
            leaf = uniform[j:j + n].view(shape)
            j += n
        if role in GAINS:
            leaf = leaf * (GAINS[role](init) / math.sqrt(math.prod(shape[1:])))
        elif role == "attn_in":  # (3 d, d): the q, k and v rows
            d = shape[1]
            gains = torch.ones(shape[0], 1, device=device)
            gains[:2 * d] = init["qk_gain"]
            leaf = leaf * gains / math.sqrt(d)
        elif role == "offset_bias":
            points = n // (2 * c["heads"] * c["levels"])
            leaf = offset_grid(c["heads"], c["levels"], points, device)
        elif role == "cls_prior":
            leaf = torch.full(shape, float(init["cls_bias"]), device=device)
        elif role in ("bn_bias", "bn_running_mean"):
            leaf = leaf * 0.1
        elif role in ("bn_weight", "ln_weight"):
            leaf = leaf + 0.5
        elif role == "bn_residual_weight":
            leaf = (leaf + 0.5) * weights.RESIDUAL_SCALE
        elif role == "bn_running_var":
            leaf = leaf * 1.5 + 0.5
        elif role == "bias":
            leaf = leaf * init["bias_std"]
        elif role != "embed":
            raise ValueError(f"unknown weight role {role!r} of {name}")
        out[name] = leaf.contiguous()
    return out
