"""Seeded weights, made on the device in a few large draws.

The layout comes from the reference (`reference.detector.param_spec`), keyed
by the program's ``state_dict`` names; both sides get the same tensors. Each
leaf's role sets its draw: He-normal for convs that feed a ReLU,
LeCun-normal for those that do not, the heads scaled by the configuration's
``weights`` gains, BatchNorm drawn away from the identity and every bias
drawn per channel, so that a wrong fold, or a bias dropped, mis-scaled or
put on another channel, shows.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from port_bench.reference import detector

# A ResNet block's last BatchNorm scale, drawn in [0.1, 0.3): the residual
# stream then grows slowly with depth, as in a ResNet started with small
# residual scales. (BatchNorm statistics fitted to each layer's inputs divide
# channels that are almost always zero after a ReLU by a tiny deviation,
# which amplifies rounding a hundredfold and more.)
RESIDUAL_SCALE = 0.2
NORMAL_ROLES = ("relu", "linear", "cls", "box", "bn_bias", "bn_running_mean", "bias",
                "box_bias", "cls_bias")
UNIFORM_ROLES = ("bn_weight", "bn_residual_weight", "bn_running_var")


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for one use (``stream``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_weights(arch, init, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``arch`` from ``seed``. ``init`` is the
    configuration's ``weights`` section: ``cls_gain``, ``box_gain`` (the
    heads' stddev times sqrt(fan-in)), ``bias_std`` (every other conv
    bias), and ``cls_bias`` with ``cls_bias_std`` (the class logits' bias,
    drawn per channel around the prior's logit)."""
    spec = detector.param_spec(arch)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
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
        if role in ("relu", "linear", "cls", "box"):
            fan_in = math.prod(shape[1:])
            gain = {"relu": math.sqrt(2.0), "linear": 1.0,
                    "cls": init["cls_gain"], "box": init["box_gain"]}[role]
            leaf = leaf * (gain / math.sqrt(fan_in))
        elif role in ("bn_bias", "bn_running_mean"):
            leaf = leaf * 0.1
        elif role == "bn_weight":
            leaf = leaf + 0.5
        elif role == "bn_residual_weight":  # a residual branch's last scale
            leaf = (leaf + 0.5) * RESIDUAL_SCALE
        elif role == "bn_running_var":
            leaf = leaf * 1.5 + 0.5
        elif role in ("bias", "box_bias"):
            leaf = leaf * init["bias_std"]
        elif role == "cls_bias":
            leaf = leaf * init["cls_bias_std"] + init["cls_bias"]
        elif role == "l2norm":
            leaf = torch.full(shape, float(arch["model"]["l2norm_scale"]), device=device)
        else:
            raise ValueError(f"unknown weight role {role!r} of {name}")
        out[name] = leaf.contiguous()
    return out

