"""Weights for the port's models: carried across from flax, or made from a seed.

``params_from_jax`` takes the reference's flax params flattened to
``/``-joined paths (the format of ``object_detector_tpu/cli/convert_weights.py``
``flatten_tree``, of which `flatten_tree` here is the port's copy) and
returns the port's ``state_dict``; ``variables_from_jax`` takes a whole flax
``variables`` dict, with the ``batch_stats`` collection of a BatchNorm
backbone. ``init_params`` is the port's own seeded
initialiser, with the reference's init scheme; the two give different
numbers from the same seed. ``quant_params_from_jax`` carries the
reference's int8 ``QuantParams`` across, so both engines can run on the
same codes and scales. For training, ``names_to_jax`` is the inverse name
map (a port ``state_dict`` or gradient dict to the flax tree's flat names)
and ``opt_state_from_optax`` carries optax's optimizer state across, so the
tests can compare gradients and updated parameters leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from object_detector_tpu_torch.models.resnet import BatchNorm
from object_detector_tpu_torch.models.retinanet import RetinaNetHead
from object_detector_tpu_torch.models.ssd import CLASS_BIAS_INIT, PredictionHead
from object_detector_tpu_torch.models.vgg import Conv, L2Norm
from object_detector_tpu_torch.quant.engine import QuantParams

# Stddev correction of a normal truncated to +-2 stddevs (flax/jax
# variance_scaling "truncated_normal").
_TRUNC_STD = 0.87962566103423978


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


# A BatchNorm's leaves in flax's two collections and in the port's module.
_STATS_FROM_JAX = {"mean": "running_mean", "var": "running_var"}
_STATS_TO_JAX = {v: k for k, v in _STATS_FROM_JAX.items()}


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax params (``backbone/conv1_1/kernel``, ...) -> the port's
    state_dict (``backbone.conv1_1.weight``, ...). Conv kernels go from HWIO
    to OIHW; biases and ``l2norm/scale`` carry over as they are. A
    BatchNorm's ``scale`` (the scope holds ``scale`` and ``bias`` and no
    ``kernel``) becomes ``weight``; the leaves of its ``batch_stats``,
    ``mean`` and ``var``, become ``running_mean`` and ``running_var``."""
    scopes: Dict[str, set] = {}
    for path in flat:
        scope, _, leaf = path.rpartition("/")
        scopes.setdefault(scope, set()).add(leaf)
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        *scope, leaf = path.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{path}: expected an HWIO conv kernel, got shape {arr.shape}")
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and scopes["/".join(scope)] == {"scale", "bias"}:
            leaf = "weight"
        elif leaf in _STATS_FROM_JAX:
            leaf = _STATS_FROM_JAX[leaf]
        elif leaf not in ("bias", "scale"):
            raise KeyError(f"unexpected flax param {path!r}")
        out[".".join([*scope, leaf])] = torch.tensor(arr)
    return out


def variables_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``variables`` dict (``params`` and, for a BatchNorm backbone,
    ``batch_stats``) -> the port's state_dict."""
    out = params_from_jax(flatten_tree(variables["params"]))
    out.update(params_from_jax(flatten_tree(variables.get("batch_stats", {}))))
    return out


def names_to_jax(tree: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax` for any dict keyed like the port's
    state_dict (parameters, gradients, optimizer moments):
    ``backbone.conv1_1.weight`` (OIHW) -> ``backbone/conv1_1/kernel`` (HWIO).
    A BatchNorm's 1-D ``weight`` goes back to ``scale`` and its running
    statistics to ``mean`` and ``var`` (flax keeps those two in the
    ``batch_stats`` collection)."""
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        *scope, leaf = name.split(".")
        arr = value.detach().to(torch.float32).cpu().numpy()
        if leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{name}: expected an OIHW conv weight, got shape {arr.shape}")
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf in _STATS_TO_JAX:
            leaf = _STATS_TO_JAX[leaf]
        elif leaf not in ("bias", "scale"):
            raise KeyError(f"unexpected parameter {name!r}")
        out["/".join([*scope, leaf])] = arr
    return out


def opt_state_from_optax(opt_state: Any) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int]:
    """An optax optimizer state of the reference's ``make_optimizer`` (nested
    tuples of per-transformation states) -> the port's ``opt_state`` and the
    update count. The momentum trace becomes ``{"trace": ...}``, Adam's
    moments ``{"mu": ..., "nu": ...}``, each keyed like the state_dict."""
    found: Dict[str, Dict[str, torch.Tensor]] = {}
    count = 0

    def walk(node: Any) -> None:
        nonlocal count
        fields = getattr(node, "_fields", ())  # optax states are named tuples
        for field in ("trace", "mu", "nu"):
            if field in fields:
                found[field] = params_from_jax(flatten_tree(getattr(node, field)))
        if "count" in fields:
            count = int(node.count)
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if not found:
        raise ValueError("no momentum trace and no Adam moments in this optax state")
    return found, count


def quant_params_from_jax(qp: Any) -> QuantParams:
    """The reference's ``quant.engine.QuantParams`` (arrays, a dict of float
    activation scales, the flax params tree) -> the port's `QuantParams`.

    A fused-stem ``QuantParams`` holds block 1's kernels packed for the TPU
    and the plain ones under ``path + "#plain"``; the port takes the plain
    ones, which is what its stem kernel reads."""
    def arrays(d: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        # "#plain" entries come last and replace the packed ones.
        plain_last = sorted(d, key=lambda k: k.endswith("#plain"))
        return {k.removesuffix("#plain"): torch.from_numpy(np.array(d[k])) for k in plain_last}

    return QuantParams(
        w_int8=arrays(qp.w_int8), w_scale=arrays(qp.w_scale), bias=arrays(qp.bias),
        act_scale={k: float(v) for k, v in qp.act_scale.items()},
        float_params=params_from_jax(flatten_tree(qp.float_params)),
    )


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0, random_batch_stats: bool = False) -> nn.Module:
    """Seeded init in place: lecun-normal conv kernels, zero biases, the class
    bias -log(99) on every SSD head's cls conv and on the out conv of
    RetinaNet's classification subnet (its box subnet's stays 0), L2Norm scale at its init value, BatchNorm at
    the identity (weight 1, bias 0, mean 0, var 1).

    ``random_batch_stats`` draws every BatchNorm from the seed instead:
    weight in [0.5, 1.5), bias and mean normal with stddev 0.1, var in
    [0.5, 2). With identity BatchNorm a wrong fold into the conv is
    invisible; smoke runs and tests ask for these."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, Conv):
            std = math.sqrt(1.0 / module.weight[0].numel()) / _TRUNC_STD
            w = torch.empty(module.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            n = module.weight.shape[0]
            if random_batch_stats:
                module.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                module.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                module.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                module.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            else:
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, L2Norm):
            module.scale.fill_(module.init_scale)
    for module in model.modules():
        if isinstance(module, PredictionHead):
            module.cls.bias.fill_(CLASS_BIAS_INIT)
        elif isinstance(module, RetinaNetHead) and module.use_class_bias:
            module.out.bias.fill_(CLASS_BIAS_INIT)
    return model
