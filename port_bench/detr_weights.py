"""Seeded weights of DETR, made on the device in a few large draws.

The layout comes from the reference (`reference.detr.param_spec`), keyed by
the program's ``state_dict`` names; both sides get the same tensors. The
trunk's leaves are drawn as `port_bench.weights` draws a ResNet's
(He-normal convs, BatchNorm away from the identity, each block's last scale
small). After it: linear and projection weights at 1/sqrt(fan-in) (He for
those that feed a ReLU), the class head at ``cls_gain`` / sqrt(fan-in) and
the box head's last layer at ``box_gain`` / sqrt(fan-in), the query and
key rows of each attention's in-projection at ``qk_gain`` / sqrt(fan-in)
(its value rows at 1 / sqrt(fan-in)), LayerNorm scales in [0.5, 1.5),
every bias N(0, ``bias_std``), the query embedding N(0, 1).

With every product at 1 / sqrt(fan-in) the attention of a seeded model is
nearly uniform over thousands of keys, and the decoder gives every query
nearly the same output; ``qk_gain`` sharpens it, as training does, so that
queries attend apart and their detections differ.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench import weights
from port_bench.reference import detr

NORMAL_ROLES = weights.NORMAL_ROLES + ("query", "attn_in")
UNIFORM_ROLES = weights.UNIFORM_ROLES + ("ln_weight",)


def make_weights(arch, init, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``arch`` from ``seed``. ``init`` is the
    configuration's ``weights`` section: ``cls_gain``, ``box_gain`` and
    ``bias_std`` and ``qk_gain``."""
    spec = detr.param_spec(arch)
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
        else:
            leaf = uniform[j:j + n].view(shape)
            j += n
        if role in ("relu", "linear", "cls", "box"):
            gain = {"relu": math.sqrt(2.0), "linear": 1.0,
                    "cls": init["cls_gain"], "box": init["box_gain"]}[role]
            leaf = leaf * (gain / math.sqrt(math.prod(shape[1:])))
        elif role == "attn_in":  # (3 d, d): the q, k and v rows
            d = shape[1]
            gains = torch.ones(shape[0], 1, device=device)
            gains[:2 * d] = init["qk_gain"]
            leaf = leaf * gains / math.sqrt(d)
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
        elif role != "query":
            raise ValueError(f"unknown weight role {role!r} of {name}")
        out[name] = leaf.contiguous()
    return out
