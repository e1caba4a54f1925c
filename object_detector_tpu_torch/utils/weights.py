"""Pretrained backbones from torchvision ``state_dict``s.

The port's copy of ``object_detector_tpu/utils/weights.py``. The same
conversions, but into the port's own names: a torchvision VGG16 or
ResNet-50 ``state_dict`` (a local .pth/.pt or .npz; nothing is
downloaded) becomes the entries of a model's ``backbone.*`` state_dict,
relative to ``backbone.`` (``conv1_1.weight``, ``stage1_block1.bn1.running_mean``).
Conv weights stay OIHW. When a VGG dict carries its classifier, fc6 and
fc7 come from it by the SSD paper's atrous subsampling: fc6 Linear(25088
-> 4096) reshaped to (4096, 512, 7, 7), every fourth output and the
spatial taps 0, 3, 6 (covered by the dilation-6 conv); fc7 Linear(4096 ->
4096) as a 1x1 conv, every fourth row and column.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_VGG_FEATURE_IDX = {  # torchvision vgg16.features index -> our layer name
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}


def vgg16_from_torch(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision vgg16 state_dict -> the VGG16 backbone's entries. fc6 and
    fc7 are converted where the classifier is present, else left out (the
    model keeps its own)."""
    out: Dict[str, np.ndarray] = {}
    for idx, name in _VGG_FEATURE_IDX.items():
        out[f"{name}.weight"] = np.asarray(state[f"features.{idx}.weight"])
        out[f"{name}.bias"] = np.asarray(state[f"features.{idx}.bias"])
    if "classifier.0.weight" in state:
        w6 = np.asarray(state["classifier.0.weight"]).reshape(4096, 512, 7, 7)
        out["fc6.weight"] = np.ascontiguousarray(w6[::4, :, ::3, ::3])  # (1024, 512, 3, 3)
        out["fc6.bias"] = np.asarray(state["classifier.0.bias"])[::4]
    if "classifier.3.weight" in state:
        w7 = np.asarray(state["classifier.3.weight"])[::4, ::4]
        out["fc7.weight"] = np.ascontiguousarray(w7[:, :, None, None])  # (1024, 1024, 1, 1)
        out["fc7.bias"] = np.asarray(state["classifier.3.bias"])[::4]
    return out


def _bn(state: Mapping[str, np.ndarray], src: str, dst: str, out: Dict[str, np.ndarray]) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = np.asarray(state[f"{src}.{leaf}"])


def resnet50_from_torch(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision resnet50 state_dict -> the ResNet-50 backbone's entries:
    the weights and the BatchNorm running statistics (``num_batches_tracked``
    is not used)."""
    out: Dict[str, np.ndarray] = {"stem_conv.weight": np.asarray(state["conv1.weight"])}
    _bn(state, "bn1", "stem_bn", out)
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for block in range(n_blocks):
            src, dst = f"layer{stage}.{block}", f"stage{stage}_block{block + 1}"
            for i in (1, 2, 3):
                out[f"{dst}.conv{i}.weight"] = np.asarray(state[f"{src}.conv{i}.weight"])
                _bn(state, f"{src}.bn{i}", f"{dst}.bn{i}", out)
            if f"{src}.downsample.0.weight" in state:
                out[f"{dst}.proj.weight"] = np.asarray(state[f"{src}.downsample.0.weight"])
                _bn(state, f"{src}.downsample.1", f"{dst}.bn_proj", out)
    return out


# ---------------------------------------------------------------------------
# Canonical torchvision state_dict inventories (public, stable since 2017).
# The validator fails loudly on any layout drift, and the tests build their
# fixtures from this inventory, so they are key-exact.
# ---------------------------------------------------------------------------

def torchvision_state_dict_shapes(arch: str) -> Dict[str, tuple]:
    """Full key -> shape inventory of a torchvision ImageNet state_dict.

    vgg16: torchvision.models.vgg16() — 13 convs in `features` (indices
    interleaved with ReLU/MaxPool), 3 linears in `classifier`.
    resnet50: torchvision.models.resnet50() — stem + 4 bottleneck stages
    (3/4/6/3 blocks, expansion 4) + fc. `num_batches_tracked` BN buffers
    (int64 scalars, present since torch 0.4) are included with shape ().
    """
    shapes: Dict[str, tuple] = {}
    if arch == "vgg16":
        chans = {
            0: (64, 3), 2: (64, 64),
            5: (128, 64), 7: (128, 128),
            10: (256, 128), 12: (256, 256), 14: (256, 256),
            17: (512, 256), 19: (512, 512), 21: (512, 512),
            24: (512, 512), 26: (512, 512), 28: (512, 512),
        }
        for idx, (o, i) in chans.items():
            shapes[f"features.{idx}.weight"] = (o, i, 3, 3)
            shapes[f"features.{idx}.bias"] = (o,)
        for idx, (o, i) in {0: (4096, 25088), 3: (4096, 4096), 6: (1000, 4096)}.items():
            shapes[f"classifier.{idx}.weight"] = (o, i)
            shapes[f"classifier.{idx}.bias"] = (o,)
        return shapes
    if arch == "resnet50":
        def bn(prefix: str, c: int) -> None:
            shapes[f"{prefix}.weight"] = (c,)
            shapes[f"{prefix}.bias"] = (c,)
            shapes[f"{prefix}.running_mean"] = (c,)
            shapes[f"{prefix}.running_var"] = (c,)
            shapes[f"{prefix}.num_batches_tracked"] = ()

        shapes["conv1.weight"] = (64, 3, 7, 7)
        bn("bn1", 64)
        stage_sizes = (3, 4, 6, 3)
        widths = (64, 128, 256, 512)
        in_ch = 64
        for s, (n_blocks, w) in enumerate(zip(stage_sizes, widths), start=1):
            for b in range(n_blocks):
                pre = f"layer{s}.{b}"
                dims = [(w, in_ch if b == 0 else 4 * w, 1), (w, w, 3), (4 * w, w, 1)]
                for i, (o, i_ch, k) in enumerate(dims, start=1):
                    shapes[f"{pre}.conv{i}.weight"] = (o, i_ch, k, k)
                    bn(f"{pre}.bn{i}", o)
                if b == 0:
                    shapes[f"{pre}.downsample.0.weight"] = (4 * w, in_ch, 1, 1)
                    bn(f"{pre}.downsample.1", 4 * w)
            in_ch = 4 * w
        shapes["fc.weight"] = (1000, 2048)
        shapes["fc.bias"] = (1000,)
        return shapes
    raise ValueError(f"unknown arch {arch!r}")


def validate_torch_state_dict(
    state: Mapping[str, np.ndarray], arch: str, allow_missing_fc: bool = False
) -> None:
    """Raise ValueError with a full diff if `state` is not key- and
    shape-identical to the canonical torchvision `arch` state_dict.

    allow_missing_fc tolerates classifier/fc-stripped dicts (feature
    extractors exported without the ImageNet head; for vgg16 the fc6/fc7
    atrous conversion is then skipped by vgg16_from_torch)."""
    want = torchvision_state_dict_shapes(arch)
    got = {k: tuple(np.asarray(v).shape) for k, v in state.items()}
    head_prefixes = ("classifier.", "fc.")
    missing = [
        k for k in want
        if k not in got
        and not (allow_missing_fc and k.startswith(head_prefixes))
    ]
    extra = [k for k in got if k not in want]
    bad_shapes = [
        f"{k}: got {got[k]}, want {want[k]}"
        for k in want
        if k in got and got[k] != want[k] and not k.endswith("num_batches_tracked")
    ]
    if missing or extra or bad_shapes:
        raise ValueError(
            f"state_dict does not match torchvision {arch}:\n"
            f"  missing keys: {sorted(missing)}\n"
            f"  unexpected keys: {sorted(extra)}\n"
            f"  shape mismatches: {bad_shapes}"
        )


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth/.pt state_dict (on the CPU, tensors only) or an .npz of
    the same keys."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    return {k: v.numpy() for k, v in blob.items()}


def inject_backbone(
    state_dict: Mapping[str, torch.Tensor], backbone: Mapping[str, np.ndarray]
) -> Dict[str, torch.Tensor]:
    """A copy of a model's ``state_dict`` with converted backbone entries
    (keyed relative to ``backbone.``, as the converters and
    ``cli.convert_weights.load_backbone_npz`` give them) grafted in, each
    shape-checked and in the entry's dtype. Entries absent from the source
    keep their values. Raises the reference's KeyError for a layer the model
    lacks and its ValueError for a shape mismatch."""
    out = dict(state_dict)
    for name, value in backbone.items():
        key = f"backbone.{name}"
        if key not in state_dict:
            layer = name.rpartition(".")[0] or name
            raise KeyError(f"backbone layer {layer!r} missing from model params")
        want = tuple(state_dict[key].shape)
        v = np.asarray(value)
        if tuple(v.shape) != want:
            raise ValueError(f"{name}: shape {tuple(v.shape)} != model {want}")
        out[key] = torch.tensor(v, dtype=state_dict[key].dtype)
    return out
