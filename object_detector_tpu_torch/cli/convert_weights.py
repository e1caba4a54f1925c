"""CLI: convert a torchvision backbone state_dict into a backbone .npz.

    python -m object_detector_tpu_torch.cli.convert_weights \\
        --backbone vgg16 --src vgg16-imagenet.pth --dst vgg16_backbone.npz

The port's copy of ``object_detector_tpu/cli/convert_weights.py``. It writes
the reference's layout: ``params:<flax path>`` entries with HWIO kernels
and, for ResNet-50, ``stats:<flax path>`` running statistics, so a file
written by either package loads in both. `load_backbone_npz` reads such a
file into the port's names, for `utils.weights.inject_backbone`::

    state = inject_backbone(model.state_dict(), load_backbone_npz(path))
    model.load_state_dict(state)
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping

import numpy as np
import torch

from object_detector_tpu_torch.convert import names_to_jax, params_from_jax
from object_detector_tpu_torch.utils.weights import (
    load_torch_state_dict, resnet50_from_torch, validate_torch_state_dict, vgg16_from_torch,
)

_STATS = (".running_mean", ".running_var")


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``a/b/c`` paths -> nested dicts, the reference's trees (the inverse of
    `convert.flatten_tree`)."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        *scopes, leaf = path.split("/")
        node = out
        for part in scopes:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def backbone_npz_payload(backbone: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Backbone entries in the port's names -> the .npz entries of the
    reference's layout (flax paths, HWIO kernels, running statistics under
    ``stats:``)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in backbone.items()}
    params = names_to_jax({k: v for k, v in tensors.items() if not k.endswith(_STATS)})
    stats = names_to_jax({k: v for k, v in tensors.items() if k.endswith(_STATS)})
    return {**{f"params:{k}": v for k, v in params.items()},
            **{f"stats:{k}": v for k, v in stats.items()}}


def load_backbone_npz(path: str) -> Dict[str, torch.Tensor]:
    """A backbone .npz of either package -> its entries in the port's names
    (relative to ``backbone.``), OIHW, with the running statistics."""
    with np.load(path) as blob:
        flat = {k: blob[k] for k in blob.files}
    params = {k[len("params:"):]: v for k, v in flat.items() if k.startswith("params:")}
    stats = {k[len("stats:"):]: v for k, v in flat.items() if k.startswith("stats:")}
    out = params_from_jax(params)
    out.update(params_from_jax(stats))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m object_detector_tpu_torch.cli.convert_weights")
    p.add_argument("--backbone", required=True, choices=["vgg16", "resnet50"])
    p.add_argument("--src", required=True, help="torch .pth/.pt or .npz state_dict")
    p.add_argument("--dst", required=True, help="output .npz")
    p.add_argument(
        "--no-validate", action="store_true",
        help="skip the canonical torchvision key/shape check (non-standard dicts)",
    )
    args = p.parse_args(argv)

    state = load_torch_state_dict(args.src)
    if not args.no_validate:
        validate_torch_state_dict(state, args.backbone, allow_missing_fc=True)
    convert = vgg16_from_torch if args.backbone == "vgg16" else resnet50_from_torch
    payload = backbone_npz_payload(convert(state))
    np.savez(args.dst, **payload)
    print(f"wrote {len(payload)} arrays -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
