"""Int8 post-training-quantization inference engine, SSD-300/VGG16,
SSD-512/ResNet-50 and RetinaNet/FPN, and the int8 trunks of the port's own
DETR-DC5 (`quantize_detr`, `detr_int8_forward`) and Deformable DETR
(`quantize_deformable_detr`, `deformable_detr_int8_forward`).

The port of ``object_detector_tpu/quant/engine.py``.
The conv trunk is an op list built from the config (`build_spec`) and run
by two interpreters that share it:

  - `run_float`: the float32 trunk; records each stage's activation absmax
    for calibration;
  - `run_int8`: int8 convs with int32 accumulation, then
    ``acc * deq + bias -> ReLU -> requant`` per conv; max pools on the
    codes. Block 1 (`FusedStemOp`) is one kernel from the input codes to
    the pooled codes (`kernels.stem_fp`); with ``ODT_STEM_FP=0`` it is
    conv1_1 through the generic int8 conv, then the fused conv1_2 + pool of
    `kernels.stem`. The ResNet trunk
    (BatchNorm folded into the convs by `fold_resnet50`) starts with
    `StemPoolPallasOp`, the fused stem of `kernels.resnet_stem`, and runs
    every stride-1 block without a projection as `BottleneckOp`, the fused
    bottleneck of `kernels.bottleneck`; both expand to plain op chains
    (`_expand_spec`) for calibration, quantization and as the cross-check.

The heads run int8 over int8 taps (`apply_heads_int8`), with the int8
L2Norm of `kernels.l2norm` on tap 0. Weights quantize per output channel,
activations per tensor (absmax / 127 over the calibration batches).

Parameters are the port's state_dict (``backbone.conv1_1.weight``, OIHW);
op paths keep the reference's ``/``-joined names. Tensors are NHWC at every
public function, as in the reference. The requant follows the reference's
op-by-op form: multiply, add, divide by the scale, round half to even.
Two of the reference's TPU layout devices, image-pair packing and the
space-to-depth stem, are accepted as options and computed in the direct
form. Its packed conv+pool (``PackedConvPoolOp``) is not ported: a spec that
holds one raises.

RetinaNet runs the ResNet trunk, then its FPN and shared heads in int8
(`run_int8_fpn_heads`; `quantize_retinanet`, `retinanet_int8_forward`),
calibrated by `run_float_fpn_heads`, which records the absmax at each of
their requant points.

Every int8 conv step of the trunk, the FPN and the heads is one call of
`_conv_step`. A 3x3 stride-1 step with nothing to add (no residual, no
coarser level) and no ReLU'd copy of its codes is one launch of
`kernels.conv3x3`, the conv and its epilogue in one kernel. Every other step
is the int8 conv (im2col, the int8 GEMM), then the epilogue from its int32
accumulator to the codes, the FPN's float32 sums or the logits, one launch
of `kernels.requant_epilogue`. On the CPU both run their plain versions.

While a profiler records, the int8 forwards run under ``odt.forward`` and
each of their steps under one ``odt.int8.*`` or ``odt.kernel.*`` span
(`utils.profiling`). Every epilogue of the three-stage chain adds its least
bytes to the counter `EPILOGUE_BYTES`; every one-kernel conv adds its
operations and least bytes to `CONV_OPS` and `CONV_BYTES`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.kernels import bottleneck as bottleneck_kernel
from object_detector_tpu_torch.kernels import conv3x3 as conv3x3_kernel
from object_detector_tpu_torch.kernels import requant_epilogue as epilogue_kernel
from object_detector_tpu_torch.kernels import resnet_stem as resnet_stem_kernel
from object_detector_tpu_torch.kernels import stem as stem_kernel
from object_detector_tpu_torch.kernels import stem_fp as stem_fp_kernel
from object_detector_tpu_torch.kernels.bottleneck import fused_bottleneck
from object_detector_tpu_torch.kernels.l2norm import l2norm_requant
from object_detector_tpu_torch.kernels.requant_epilogue import fpn_upsample2x
from object_detector_tpu_torch.kernels.resnet_stem import resnet_stem
from object_detector_tpu_torch.kernels.stem import stem_conv12_pool
from object_detector_tpu_torch.kernels.stem_fp import stem_fused_producer
from object_detector_tpu_torch.models.detr import DETRModel
from object_detector_tpu_torch.models.resnet import block_geometry
from object_detector_tpu_torch.models.retinanet import (ANCHORS_PER_LOCATION, RetinaNetModel,
                                                       build_model)
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils import profiling
from object_detector_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
KernelFn = Callable[..., Tensor]
# The least bytes of the int8 forward's epilogues (`_count_epilogue`).
EPILOGUE_BYTES = "odt.int8.epilogue_bytes"
# The operations (2 a multiply-add) and least bytes of its one-kernel 3x3
# convs (`_count_conv`).
CONV_OPS = "odt.int8.conv_ops"
CONV_BYTES = "odt.int8.conv_bytes"


@dataclasses.dataclass(frozen=True)
class ConvOp:
    path: str  # param path, e.g. "backbone/conv1_1"
    kernel: int = 3
    stride: int = 1
    padding: Any = "SAME"  # "SAME" | "VALID" | int (explicit symmetric)
    dilation: int = 1
    relu: bool = True
    # Residual (ResNet): add the named register, saved by a SaveOp, into the
    # conv's epilogue before the ReLU.
    add_register: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FusedStemOp:
    """VGG block 1: conv1_1, then conv1_2 + ReLU + requant + 2x2/s2 max pool
    as one kernel (`kernels.stem.stem_conv12_pool`); or, where `stem_fp_on`
    says so, all of it as one kernel (`kernels.stem_fp.stem_fused_producer`).
    Both are exact against the unfused chain: the same int32 sums and
    float32 epilogues, and the pool commutes with the monotone requant."""

    path1: str = "backbone/conv1_1"
    path2: str = "backbone/conv1_2"


@dataclasses.dataclass(frozen=True)
class BottleneckOp:
    """A stride-1 ResNet bottleneck without a projection (conv1 1x1 -> conv2
    3x3 -> conv3 1x1 + residual) as one kernel
    (`kernels.bottleneck.fused_bottleneck`): both intermediates stay on
    chip. Bit-equal to the unfused chain it expands to (`_expand_spec`), so
    one QuantParams serves both specs."""

    base: str  # e.g. "backbone/stage1_block2"

    @property
    def conv_paths(self) -> Tuple[str, str, str]:
        return (f"{self.base}/conv1", f"{self.base}/conv2", f"{self.base}/conv3")


@dataclasses.dataclass(frozen=True)
class SaveOp:
    """Save the current activation into a named register (residual input)."""

    name: str


@dataclasses.dataclass(frozen=True)
class LoadOp:
    """Restore a register as the current activation (a branch)."""

    name: str


@dataclasses.dataclass(frozen=True)
class PoolOp:
    size: int = 2
    stride: int = 2
    pad_same: bool = False  # True -> SAME padding (pool5 3x3/1)
    explicit_pad: Optional[int] = None  # symmetric spatial pad (the ResNet stem's pool)


@dataclasses.dataclass(frozen=True)
class StemPoolPallasOp:
    """The ResNet stem as one kernel (`kernels.resnet_stem.resnet_stem`):
    input quantize + 7x7/s2 conv + folded-BN bias + ReLU + requant + 3x3/s2
    pad-1 max pool. Replaces the [input quantize, ConvOp(stem), PoolOp]
    prefix it expands to (`_expand_spec`). The kernel requants by the
    float32 reciprocal of the scale where the chain divides, so the two may
    differ by one code on about one element in a million. The name is the
    reference's."""

    path: str = "backbone/stem_conv"


@dataclasses.dataclass(frozen=True)
class PadToEvenOp:
    pass


@dataclasses.dataclass(frozen=True)
class TapOp:
    index: int


Spec = List[Any]


def _env_tristate(name: str, auto: bool) -> bool:
    """An on/off/auto environment knob: unset or "auto" -> ``auto``; "1" ->
    on; "0" -> off; anything else is an error, never a silent off."""
    val = os.environ.get(name)
    if val is None or val == "auto":
        return auto
    if val == "1":
        return True
    if val == "0":
        return False
    raise ValueError(f"{name}={val!r}: expected unset, 'auto', '0', or '1'")


def stem_fp_on() -> bool:
    """Whether `FusedStemOp` runs as the one-kernel block 1
    (`kernels.stem_fp`): ``ODT_STEM_FP``, read at each `run_int8` call as
    the reference reads it; unset or "auto" is on, "1" on, "0" off (conv1_1
    through the int8 conv, then `kernels.stem`). The reference leaves it off;
    on an NVIDIA H100 80GB HBM3 at 700 W int8 SSD-300 at bs=64 served 1939
    img/s with it and 1562 on the other route (PERF.md). Both routes give
    the same codes."""
    return _env_tristate("ODT_STEM_FP", auto=True)


def _extras_spec(cfg: DetectorConfig, n_taps_so_far: int) -> Spec:
    """Extra-layer ops mirroring models/ssd.py SSDExtraLayers selection."""
    spec: Spec = []
    n_extra = len(cfg.anchors.feature_sizes) - n_taps_so_far
    for i in range(n_extra):
        if cfg.model.image_size >= 512:
            stride, padding = 2, "SAME"
        else:
            stride, padding = (2, "SAME") if i < 2 else (1, "VALID")
        spec.append(ConvOp(f"extras/conv{8+i}_1", kernel=1))
        spec.append(ConvOp(f"extras/conv{8+i}_2", stride=stride, padding=padding))
        spec.append(TapOp(n_taps_so_far + i))
    return spec


def build_spec(cfg: DetectorConfig, fused_stem: Optional[bool] = None) -> Spec:
    """Op list for the configured SSD trunk (VGG16 or ResNet-50).

    ``fused_stem=None`` resolves to ``image_size % 2 == 0`` on every device
    (the reference picks the fused stem only on a TPU; the two specs give
    bit-equal codes). ResNet-50 reads its knobs from the environment (see
    `build_resnet_trunk_spec`)."""
    if cfg.model.backbone == "vgg16":
        if fused_stem is None:
            fused_stem = cfg.model.image_size % 2 == 0
        return build_ssd_spec(cfg, fused_stem=fused_stem)
    if cfg.model.backbone == "resnet50":
        return build_resnet_ssd_spec(cfg)
    raise NotImplementedError(f"int8 engine: unknown backbone {cfg.model.backbone}")


def _expand_spec(spec: Spec) -> Spec:
    """The spec with every fused op replaced by the unfused chain it equals:
    what the float interpreter, calibration and weight quantization walk,
    so fused and plain specs share one QuantParams."""
    out: Spec = []
    for op in spec:
        if isinstance(op, BottleneckOp):
            c1, c2, c3 = op.conv_paths
            out += [
                SaveOp("sc"),
                ConvOp(c1, kernel=1),
                ConvOp(c2, kernel=3),
                ConvOp(c3, kernel=1, relu=True, add_register="sc"),
            ]
        elif isinstance(op, StemPoolPallasOp):
            out += [ConvOp(op.path, kernel=7, stride=2, padding=3), PoolOp(3, 2, explicit_pad=1)]
        elif isinstance(op, FusedStemOp):
            out += [ConvOp(op.path1), ConvOp(op.path2), PoolOp()]
        else:
            out.append(op)
    return out


def build_resnet_ssd_spec(
    cfg: DetectorConfig, fused_bottleneck: Optional[bool] = None,
    img_pack: Optional[bool] = None,
) -> Spec:
    """Op list mirroring models/ssd.py + models/resnet.py (BatchNorm folded
    into conv kernels and biases by `fold_resnet50`)."""
    return build_resnet_trunk_spec(
        fused_bottleneck=fused_bottleneck, img_pack=img_pack
    ) + _extras_spec(cfg, 3)


def build_resnet_trunk_spec(
    stem_algo: str = "direct", fused_bottleneck: Optional[bool] = None,
    img_pack: Optional[bool] = None, dilate_c5: bool = False,
) -> Spec:
    """ResNet-50 C3/C4/C5 trunk.

    ``dilate_c5``: DETR's DC5 trunk (`models.resnet.block_geometry`): stage
    4 at stride 1, its blocks 2 and 3 with the 3x3 dilated by 2. The
    bottleneck kernel has no dilation, so those two blocks run the unfused
    chain (im2col of the dilated windows, the int8 GEMM, the epilogue).

    ``fused_bottleneck``: the stride-1 blocks without a projection (blocks 2
    and later of every stage) run as single kernels (`BottleneckOp`).
    ``None`` reads ``ODT_FUSED_BOTTLENECK``; unset or "auto" is on. The stem
    runs as one kernel (`StemPoolPallasOp`) unless ``ODT_STEM_KERNEL=0``
    (unset or "auto" is on) or ``stem_algo`` is not "direct". With both off
    the spec is the unfused chain, the cross-check of the two kernels.

    ``stem_algo="s2d"`` (the space-to-depth stem) and ``img_pack`` (image
    pairs packed into channels; ``None`` reads ``ODT_IMG_PACK``) are layout
    devices of the reference's TPU path that give the same codes. They are
    accepted and computed in the direct, unpacked form; with no packed
    stage, stage 1's later blocks run the bottleneck kernel too."""
    if stem_algo not in ("direct", "s2d"):
        raise ValueError(f"stem_algo must be 'direct' or 's2d', got {stem_algo!r}")
    if fused_bottleneck is None:
        fused_bottleneck = _env_tristate("ODT_FUSED_BOTTLENECK", auto=True)
    if img_pack is None:
        _env_tristate("ODT_IMG_PACK", auto=False)  # its grammar is checked; its value changes nothing
    stem_kernel = _env_tristate("ODT_STEM_KERNEL", auto=True) and stem_algo == "direct"
    if stem_kernel:
        spec: Spec = [StemPoolPallasOp()]
    else:
        spec = [
            ConvOp("backbone/stem_conv", kernel=7, stride=2, padding=3),
            PoolOp(3, 2, explicit_pad=1),
        ]
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for block in range(1, n_blocks + 1):
            base = f"backbone/stage{stage}_block{block}"
            stride, dilation = block_geometry(stage, block, dilate_c5)
            if block == 1:
                spec += [
                    SaveOp("in"),
                    ConvOp(f"{base}/proj", kernel=1, stride=stride, relu=False),
                    SaveOp("sc"),
                    LoadOp("in"),
                    ConvOp(f"{base}/conv1", kernel=1),
                    ConvOp(f"{base}/conv2", kernel=3, stride=stride),
                    ConvOp(f"{base}/conv3", kernel=1, relu=True, add_register="sc"),
                ]
            elif fused_bottleneck and dilation == 1:
                spec.append(BottleneckOp(base))
            else:
                spec += [
                    SaveOp("sc"),
                    ConvOp(f"{base}/conv1", kernel=1),
                    ConvOp(f"{base}/conv2", kernel=3, stride=stride, dilation=dilation),
                    ConvOp(f"{base}/conv3", kernel=1, relu=True, add_register="sc"),
                ]
        if stage >= 2:
            spec.append(TapOp(stage - 2))
    return spec


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def fold_resnet50(params: Mapping[str, Tensor], eps: float = 1e-5) -> Dict[str, Tensor]:
    """Fold every backbone BatchNorm (running statistics) into the conv
    before it: the state_dict of plain convs with biases that
    `build_resnet_ssd_spec` addresses. ``backbone.stem_bn`` folds into
    ``backbone.stem_conv``, a block's ``bn1..3`` into ``conv1..3`` and
    ``bn_proj`` into ``proj``. Extras and heads pass through. Computed in
    numpy float32, operation for operation the reference's."""
    out: Dict[str, Tensor] = {}
    for name, value in params.items():
        scope, _, leaf = name.rpartition(".")
        module = scope.rpartition(".")[2]
        if not name.startswith("backbone."):
            out[name] = value
        elif module in ("stem_bn", "bn1", "bn2", "bn3", "bn_proj"):
            continue  # folded below, with its conv
        elif leaf == "weight":
            # stem_conv -> stem_bn, proj -> bn_proj, conv<i> -> bn<i>
            bn_module = {"stem_conv": "stem_bn", "proj": "bn_proj"}.get(
                module, "bn" + module[len("conv"):])
            bn = f"{scope.rpartition('.')[0]}.{bn_module}"
            scale, bias, mean, var = (
                params[f"{bn}.{bn_leaf}"].detach().to("cpu", torch.float32).numpy()
                for bn_leaf in _BN_LEAVES)
            f = scale / np.sqrt(var + np.float32(eps))
            kernel = value.detach().to("cpu", torch.float32).numpy()  # OIHW
            out[name] = torch.from_numpy(kernel * f[:, None, None, None]).to(value.device)
            out[f"{scope}.bias"] = torch.from_numpy(bias - mean * f).to(value.device)
        else:
            raise KeyError(f"unexpected backbone entry {name!r}")
    return out


def build_ssd_spec(cfg: DetectorConfig, fused_stem: bool = False) -> Spec:
    """Op list mirroring models/ssd.py + models/vgg.py exactly (VGG16)."""
    if cfg.model.backbone != "vgg16":
        return build_spec(cfg)
    block1: Spec = (
        [FusedStemOp()]
        if fused_stem
        else [ConvOp("backbone/conv1_1"), ConvOp("backbone/conv1_2"), PoolOp()]
    )
    spec: Spec = block1 + [
        ConvOp("backbone/conv2_1"), ConvOp("backbone/conv2_2"), PoolOp(),
        ConvOp("backbone/conv3_1"), ConvOp("backbone/conv3_2"),
        ConvOp("backbone/conv3_3"), PadToEvenOp(), PoolOp(),
        ConvOp("backbone/conv4_1"), ConvOp("backbone/conv4_2"),
        ConvOp("backbone/conv4_3"), TapOp(0), PoolOp(),
        ConvOp("backbone/conv5_1"), ConvOp("backbone/conv5_2"),
        ConvOp("backbone/conv5_3"), PoolOp(3, 1, pad_same=True),
        ConvOp("backbone/fc6", dilation=6), ConvOp("backbone/fc7", kernel=1),
        TapOp(1),
    ]
    spec += _extras_spec(cfg, 2)
    return spec


def _num_taps(spec: Spec) -> int:
    return sum(1 for op in spec if isinstance(op, TapOp))


def required_scale_keys(spec: Spec, use_l2norm: bool = False) -> set:
    """Activation-scale keys `run_int8` looks up for this spec. The fused
    stem records its scales under the original conv paths, so fused and
    unfused specs share a key set."""
    keys = {"__input__"}
    keys.update(op.path for op in _expand_spec(spec) if isinstance(op, ConvOp))
    if use_l2norm:
        keys.add("__l2norm__")
    return keys


def _key(path: str) -> str:
    return path.replace("/", ".")


# --------------------------------------------------------------------------
# Float reference / calibration pass
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _full_float32() -> Iterator[None]:
    """float32 convs and matmuls on the card run in full float32, not TF32,
    for the duration (TF32 would move every absmax, and so every code)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv_float(x: Tensor, weight: Tensor, op: ConvOp) -> Tensor:
    """NHWC float conv (no bias) with the reference's padding rules."""
    xc = x.permute(0, 3, 1, 2)  # a channels-last view, no copy
    k = weight.shape[-1]
    ph = int8_ops.conv_pads(xc.shape[2], k, op.stride, op.dilation, op.padding)
    pw = int8_ops.conv_pads(xc.shape[3], k, op.stride, op.dilation, op.padding)
    pad = (0, 0)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, weight.to(x.dtype), stride=op.stride, padding=pad, dilation=op.dilation)
    return y.permute(0, 2, 3, 1)


def run_float(
    params: Mapping[str, Tensor],
    spec: Spec,
    images: Tensor,  # normalized float input (B, S, S, 3)
) -> Tuple[List[Tensor], Dict[str, Tensor]]:
    """Run the trunk in float32; returns (taps, absmax per stage).

    absmax holds the post-activation maximum magnitude of every conv output
    (0-dim tensors) and the trunk input's under ``"__input__"``."""
    absmax: Dict[str, Tensor] = {"__input__": images.abs().max()}
    x = images.to(torch.float32)
    regs: Dict[str, Tensor] = {}
    taps: List[Tensor] = [None] * _num_taps(spec)  # type: ignore[list-item]
    for op in _expand_spec(spec):  # the float path always runs unfused chains
        if isinstance(op, ConvOp):
            y = _conv_float(x, params[_key(op.path) + ".weight"], op)
            y = y + params[_key(op.path) + ".bias"].to(torch.float32)
            if op.add_register is not None:
                y = y + regs[op.add_register]
            x = torch.clamp_min(y, 0.0) if op.relu else y
            absmax[op.path] = x.abs().max()
        elif isinstance(op, SaveOp):
            regs[op.name] = x
        elif isinstance(op, LoadOp):
            x = regs[op.name]
        elif isinstance(op, PoolOp):
            x = int8_ops.max_pool(x, op.size, op.stride, op.pad_same, op.explicit_pad)
        elif isinstance(op, PadToEvenOp):
            x = int8_ops.pad_to_even(x)
        elif isinstance(op, TapOp):
            taps[op.index] = x
        else:
            raise NotImplementedError(f"op {op!r} is not ported yet")
    return taps, absmax


# --------------------------------------------------------------------------
# Quantization
# --------------------------------------------------------------------------

@dataclasses.dataclass
class QuantParams:
    """Int8 trunk and head weights, their scales, the activation scales,
    and the float params (the L2Norm scale, the float heads)."""

    w_int8: Dict[str, Tensor]  # path -> int8 HWIO kernel
    w_scale: Dict[str, Tensor]  # path -> (out_ch,) float32
    bias: Dict[str, Tensor]  # path -> (out_ch,) float32
    act_scale: Dict[str, float]  # stage path (or __input__, __l2norm__) -> scale
    float_params: Dict[str, Tensor]  # the model's state_dict
    # Constants derived from the fields above on their device (GEMM operands,
    # deq vectors, scale tensors, the kernels' packed weights), each made on
    # first use and kept.
    _derived: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def derived(self, key: Any, make: Callable[[], Any]) -> Any:
        """``make()``, computed once per ``key``. The fields must not change
        after the first call."""
        value = self._derived.get(key)
        if value is None:
            value = self._derived[key] = make()
        return value

    def scale(self, s: float, device: torch.device) -> Tensor:
        """The scale ``s`` as a 0-dim float32 tensor on ``device``."""
        return self.derived(("scale", s, device), lambda: int8_ops.scale_tensor(s, device))

    def deq(self, path: str, in_scale: float, device: torch.device) -> Tensor:
        """float32(in_scale) * w_scale[path], the conv's dequant vector."""
        return self.derived(("deq", path, in_scale, device),
                            lambda: self.scale(in_scale, device) * self.w_scale[path])

    def gemm_operand(self, path: str) -> Tensor:
        """w_int8[path] laid out as `int8_ops.int_matmul`'s right operand."""
        return self.derived(("gemm", path), lambda: int8_ops.gemm_operand(self.w_int8[path]))

    def to(self, device: str | torch.device) -> "QuantParams":
        def move(d: Mapping[str, Tensor]) -> Dict[str, Tensor]:
            return {k: v.to(device) for k, v in d.items()}

        return QuantParams(
            w_int8=move(self.w_int8), w_scale=move(self.w_scale), bias=move(self.bias),
            act_scale=dict(self.act_scale), float_params=move(self.float_params),
        )


def calibrate_scales(
    params: Mapping[str, Tensor], spec: Spec, batches: Sequence[Tensor],
    use_l2norm: bool = True, fpn_cfg: Optional[DetectorConfig] = None,
) -> Dict[str, float]:
    """Per-tensor activation scales (absmax / 127) over calibration batches,
    computed in float32 (TF32 off on the card). With ``use_l2norm`` (VGG)
    also records ``"__l2norm__"``, the absmax of the L2Norm'd tap 0 that
    feeds head 0; with ``fpn_cfg`` (RetinaNet) every requant point of the
    FPN and heads over the trunk's taps (`run_float_fpn_heads`)."""
    agg: Dict[str, float] = {}
    with _full_float32(), torch.inference_mode():
        for images in batches:
            taps, absmax = run_float(params, spec, images)
            if fpn_cfg is not None:
                absmax.update(run_float_fpn_heads(params, fpn_cfg, taps)[2])
            if use_l2norm:
                t0 = taps[0]
                sq = (t0 * t0).sum(dim=-1, keepdim=True)
                ln = t0 * torch.rsqrt(sq + 1e-12) * params["l2norm.scale"].to(torch.float32)
                absmax["__l2norm__"] = ln.abs().max()
            values = torch.stack(list(absmax.values())).tolist()
            for key, val in zip(absmax, values):
                agg[key] = max(agg.get(key, 0.0), float(val))
    return {k: max(v, 1e-6) / 127.0 for k, v in agg.items()}


def _quantize_kernel(p: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    w = np.asarray(p["kernel"], np.float32)  # (kh, kw, in, out)
    s = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0  # per out-ch
    s = np.maximum(s, 1e-8).astype(np.float32)
    w_q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return w_q, s, np.asarray(p["bias"], np.float32)


def _flax_conv(params: Mapping[str, Tensor], path: str) -> Dict[str, np.ndarray]:
    """The conv at ``path`` as the reference holds it: HWIO kernel, bias."""
    weight = params[_key(path) + ".weight"].detach().to("cpu", torch.float32)
    bias = params[_key(path) + ".bias"].detach().to("cpu", torch.float32)
    return {"kernel": weight.permute(2, 3, 1, 0).numpy(), "bias": bias.numpy()}


def quantize_params(
    params: Mapping[str, Tensor], spec: Spec, act_scale: Dict[str, float],
    head_paths: Optional[Sequence[str]] = None,
) -> QuantParams:
    """Per-output-channel int8 weights of every trunk conv (fused ops
    expanded to their convs) and of ``head_paths``: by default the SSD
    heads of every tap (RetinaNet passes its FPN and heads)."""
    paths = [op.path for op in _expand_spec(spec) if isinstance(op, ConvOp)]
    if head_paths is None:
        head_paths = [f"head{level}/{kind}" for level in range(_num_taps(spec))
                      for kind in ("cls", "box")]
    paths += list(head_paths)
    w_int8: Dict[str, Tensor] = {}
    w_scale: Dict[str, Tensor] = {}
    bias: Dict[str, Tensor] = {}
    for path in paths:
        w_q, s, b = _quantize_kernel(_flax_conv(params, path))
        w_int8[path], w_scale[path], bias[path] = (torch.from_numpy(a) for a in (w_q, s, b))
    return QuantParams(
        w_int8=w_int8, w_scale=w_scale, bias=bias, act_scale=dict(act_scale),
        float_params={k: v.detach().to("cpu") for k, v in params.items()},
    )


def quantize_ssd(
    cfg: DetectorConfig,
    params: Mapping[str, Tensor],
    calibration_batches: Sequence[Tensor],
    spec: Optional[Spec] = None,
) -> Tuple[QuantParams, Spec]:
    """One-call PTQ: [fold BatchNorm] + calibrate + quantize.
    ``calibration_batches`` are normalized float image batches (B, S, S, 3);
    ``params`` is the model's state_dict, with the running statistics of a
    BatchNorm backbone (ResNet-50); ``spec`` overrides `build_spec`'s op
    list."""
    if spec is None:
        spec = build_spec(cfg)
    if cfg.model.backbone == "resnet50":
        params = fold_resnet50(params)
    scales = calibrate_scales(params, spec, calibration_batches,
                              use_l2norm=cfg.model.backbone == "vgg16")
    return quantize_params(params, spec, scales), spec


# --------------------------------------------------------------------------
# Int8 inference pass
# --------------------------------------------------------------------------

def _count_epilogue(*tensors: Optional[Tensor]) -> None:
    """Adds to `EPILOGUE_BYTES` the least bytes of one epilogue step: each
    of ``tensors`` (its int32 accumulator, an addend, its output; None
    skipped) moved once. Shapes only, while a profiler records."""
    if profiling.enabled():
        profiling.count(EPILOGUE_BYTES, sum(t.numel() * t.element_size()
                                            for t in tensors if t is not None))


def _count_conv(x_q: Tensor, w: Tensor, out: epilogue_kernel.Epilogue) -> None:
    """Adds to `CONV_OPS` the one-kernel conv's 2 * M * K * N operations (M
    output pixels, K = 9 * Cin, N = Cout) and to `CONV_BYTES` its least
    bytes: the codes in, the kernel and the output each moved once. Shapes
    only, while a profiler records."""
    if profiling.enabled():
        y = out.sum if out.codes is None else out.codes
        profiling.count(CONV_OPS, 2 * y.numel() * (w.numel() // w.shape[-1]))
        profiling.count(CONV_BYTES, x_q.numel() + w.numel() + y.numel() * y.element_size())


def _conv_step(
    qp: QuantParams, x_q: Tensor, s_in: float, path: str, stride: int = 1,
    padding: Any = "SAME", dilation: int = 1, out_scale: Optional[float] = None,
    relu: bool = False, resid: Optional[Tensor] = None, resid_scale: Optional[float] = None,
    addend: Optional[Tensor] = None, sum_dtype: Optional[torch.dtype] = None,
    relu_codes: bool = False,
) -> epilogue_kernel.Epilogue:
    """One int8 conv step of the codes ``x_q`` (at scale ``s_in``) by the
    conv at ``path``, with the epilogue's arguments after ``dilation``.

    A 3x3 stride-1 step over channels `kernels.conv3x3` takes, with one
    output (the codes or the sum), no ``resid``, no ``addend`` and no
    ``relu_codes``, is one call of
    `kernels.conv3x3.conv3x3` under ``odt.int8.conv``, counted by
    `_count_conv`. Every other step is the int8 conv, then one call of
    `kernels.requant_epilogue.epilogue` under ``odt.int8.epilogue``, which
    counts the accumulator, the residual, the addend and the codes where they
    are asked for, else the sum; with ReLU codes also the codes in and the
    ReLU codes out, as many bytes as the ReLU codes twice."""
    w = qp.w_int8[path]
    kh, kw, cin, _ = w.shape
    if (kh == kw == 3 and stride == 1 and cin % conv3x3_kernel.CIN_MULTIPLE == 0
            and (out_scale is None) != (sum_dtype is None)
            and resid is None and addend is None and not relu_codes):
        with span("odt.int8.conv"):
            out = conv3x3_kernel.conv3x3(x_q, w, qp.deq(path, s_in, x_q.device), qp.bias[path],
                                         padding, dilation, out_scale, relu, sum_dtype,
                                         operand=qp.gemm_operand(path))
        _count_conv(x_q, w, out)
        return out
    acc = int8_ops.conv_int8(x_q, w, stride, padding, dilation, operand=qp.gemm_operand(path))
    with span("odt.int8.epilogue"):
        out = epilogue_kernel.epilogue(acc, qp.deq(path, s_in, x_q.device), qp.bias[path],
                                       out_scale, relu, resid, resid_scale, addend, sum_dtype,
                                       relu_codes)
    _count_epilogue(acc, resid, addend, out.sum if out.codes is None else out.codes,
                    out.relu_codes, out.relu_codes)
    return out


def _head_out(
    qp: QuantParams, cfg: DetectorConfig, x_q: Tensor, s_in: float, path: str, cls: bool,
    anchors: int, logits_dtype: torch.dtype, concat: bool,
) -> Tensor:
    """A head's out conv on one level: its float sum, no requant (the class
    logits in ``logits_dtype``, the box offsets in float32), as (B, H*W*a,
    width), or the conv's native (B, H, W, a*width) where not ``concat``."""
    y = _conv_step(qp, x_q, s_in, path,
                   sum_dtype=logits_dtype if cls else torch.float32).sum
    if not concat:
        return y
    b, h, w, _ = y.shape
    return y.reshape(b, h * w * anchors, _head_width(cfg, cls))


def _head_outputs(cls_out: List[Tensor], box_out: List[Tensor],
                  concat: bool) -> Tuple[Any, Any]:
    """The heads' levels concatenated under ``odt.int8.concat``, or the
    per-level tuples where not ``concat``."""
    if not concat:
        return tuple(cls_out), tuple(box_out)
    with span("odt.int8.concat"):
        return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)


def run_int8(
    qp: QuantParams,
    spec: Spec,
    images: Tensor,  # normalized float input (B, S, S, 3)
    dequantize_taps: bool = True,
    stem_fn: KernelFn = stem_conv12_pool,
    resnet_stem_fn: KernelFn = resnet_stem,
    bottleneck_fn: KernelFn = fused_bottleneck,
    stem_fp_fn: KernelFn = stem_fused_producer,
) -> List[Any]:
    """Int8 trunk forward.

    dequantize_taps=True  -> list of bf16 float taps (for float heads)
    dequantize_taps=False -> list of (int8 tap, scale) (for int8 heads)

    ``stem_fn`` is VGG block 1's conv1_2 + pool, ``stem_fp_fn`` all of VGG
    block 1 (run instead of conv1_1 and ``stem_fn`` where `stem_fp_on`),
    ``resnet_stem_fn`` the fused ResNet stem and ``bottleneck_fn`` the fused
    bottleneck: each the kernel wrapper unless a caller swaps in its plain
    version (`stem_conv12_pool_reference`, `stem_fused_producer_reference`,
    `resnet_stem_reference`, `fused_bottleneck_reference`)."""
    dev = images.device
    cur_scale = qp.act_scale["__input__"]
    with span("odt.int8.input"):
        if spec and isinstance(spec[0], StemPoolPallasOp):
            x = images.to(torch.float32)  # the stem kernel quantizes its input itself
        else:
            x = int8_ops.quantize(images.to(torch.float32, copy=True), qp.scale(cur_scale, dev))
    regs: Dict[str, Tuple[Tensor, float]] = {}
    taps: List[Any] = [None] * _num_taps(spec)
    for op in spec:
        if isinstance(op, ConvOp):
            resid, resid_scale = (None, None) if op.add_register is None \
                else regs[op.add_register]
            out_scale = qp.act_scale[op.path]
            x = _conv_step(qp, x, cur_scale, op.path, op.stride, op.padding, op.dilation,
                           out_scale, op.relu, resid, resid_scale).codes
            cur_scale = out_scale
        elif isinstance(op, StemPoolPallasOp):
            out_scale = qp.act_scale[op.path]
            packed = qp.derived(("resnet_stem", op.path), lambda: resnet_stem_kernel.pack_weights(
                qp.w_int8[op.path]))
            x = resnet_stem_fn(x, qp.w_int8[op.path], qp.deq(op.path, cur_scale, dev),
                               qp.bias[op.path], cur_scale, out_scale, packed=packed)
            cur_scale = out_scale
        elif isinstance(op, BottleneckOp):
            c1, c2, c3 = op.conv_paths
            s1, s2, s3 = (qp.act_scale[c] for c in op.conv_paths)
            cin, cm = qp.w_int8[c1].shape[-2:]
            packed = qp.derived(("bottleneck", op.base), lambda: bottleneck_kernel.pack_weights(
                qp.w_int8[c1].reshape(cin, cm), qp.w_int8[c2], qp.w_int8[c3].reshape(cm, cin)))
            x = bottleneck_fn(
                x,
                qp.w_int8[c1].reshape(cin, cm), qp.deq(c1, cur_scale, dev), qp.bias[c1],
                qp.w_int8[c2], qp.deq(c2, s1, dev), qp.bias[c2],
                qp.w_int8[c3].reshape(cm, cin), qp.deq(c3, s2, dev), qp.bias[c3],
                s1=s1, s2=s2, s3=s3, resid_scale=cur_scale, packed=packed,
            )
            cur_scale = s3
        elif isinstance(op, FusedStemOp):
            s1, s2 = qp.act_scale[op.path1], qp.act_scale[op.path2]
            if stem_fp_on():
                packed = qp.derived(("stem_fp", op.path1), lambda: stem_fp_kernel.pack_weights(
                    qp.w_int8[op.path1], qp.w_int8[op.path2]))
                x = stem_fp_fn(x, qp.w_int8[op.path1], qp.deq(op.path1, cur_scale, dev),
                               qp.bias[op.path1], s1, qp.w_int8[op.path2],
                               qp.deq(op.path2, s1, dev), qp.bias[op.path2], s2, packed=packed)
            else:
                packed = qp.derived(("stem", op.path2), lambda: stem_kernel.pack_weights(
                    qp.w_int8[op.path2]))
                x = _conv_step(qp, x, cur_scale, op.path1, out_scale=s1, relu=True).codes
                x = stem_fn(x, qp.w_int8[op.path2], qp.deq(op.path2, s1, dev), qp.bias[op.path2],
                            s2, packed=packed)
            cur_scale = s2
        elif isinstance(op, SaveOp):
            regs[op.name] = (x, cur_scale)
        elif isinstance(op, LoadOp):
            x, cur_scale = regs[op.name]
        elif isinstance(op, PoolOp):
            x = int8_ops.max_pool(x, op.size, op.stride, op.pad_same, op.explicit_pad)
        elif isinstance(op, PadToEvenOp):
            x = int8_ops.pad_to_even(x)
        elif isinstance(op, TapOp):
            if dequantize_taps:
                with span("odt.int8.concat"):
                    s = torch.full((), cur_scale, dtype=torch.bfloat16, device=dev)
                    taps[op.index] = x.to(torch.bfloat16) * s
            else:
                taps[op.index] = (x, cur_scale)
        else:
            raise NotImplementedError(f"op {op!r} is not ported yet")
    return taps


def apply_heads_int8(
    qp: QuantParams,
    taps_q: List[Tuple[Tensor, float]],
    cfg: DetectorConfig,
    pallas_l2norm: Optional[bool] = None,
    logits_dtype: torch.dtype = torch.float32,
    concat: bool = True,
    l2norm_fn: KernelFn = l2norm_requant,
) -> Tuple[Tensor, Tensor]:
    """Int8 prediction heads over int8 taps -> (cls_logits, box_offsets),
    concatenated over levels; with ``concat=False`` per-level tuples of the
    convs' native (B, H, W, a*C) and (B, H, W, a*4) outputs, for
    `ops.postprocess.postprocess_levels`.

    L2Norm on tap 0 (VGG) runs on the int8 codes (it is scale-invariant in
    its input) through ``l2norm_fn`` (the kernel wrapper unless a caller
    swaps in `l2norm_requant_reference`) and requants with the calibrated
    ``"__l2norm__"`` scale. ``pallas_l2norm`` is accepted and changes
    nothing: the port has one arithmetic for this step. Head convs are int8
    with float32 dequantized outputs (the final logits)."""
    del pallas_l2norm
    taps = list(taps_q)
    if "__l2norm__" in qp.act_scale:
        q0, _ = taps[0]
        gamma = qp.float_params["l2norm.scale"].to(torch.float32)
        s0 = qp.act_scale["__l2norm__"]
        taps[0] = (l2norm_fn(q0, gamma, s0), s0)

    cls_out, box_out = [], []
    for level, ((tap, s_tap), a) in enumerate(zip(taps, cfg.anchors.anchors_per_level)):
        for kind, out in (("cls", cls_out), ("box", box_out)):
            out.append(_head_out(qp, cfg, tap, s_tap, f"head{level}/{kind}", kind == "cls", a,
                                 logits_dtype, concat))
    return _head_outputs(cls_out, box_out, concat)


def _head_conv(x: Tensor, weight: Tensor, bias: Tensor, dtype: torch.dtype) -> Tensor:
    # Inputs rounded to ``dtype``, products and sums in float32 (the
    # reference's preferred_element_type=float32).
    op = ConvOp("head", relu=False)
    y = _conv_float(x.to(dtype).to(torch.float32), weight.to(dtype).to(torch.float32), op)
    return y + bias.to(torch.float32)


def apply_heads(
    params: Mapping[str, Tensor],
    taps: List[Tensor],
    cfg: DetectorConfig,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Tensor, Tensor]:
    """Float heads over dequantized taps: L2Norm on tap 0 (VGG) in ``dtype``
    with the sum of squares in float32, then per-level cls/box convs."""
    taps = list(taps)
    if cfg.model.backbone == "vgg16":
        scale = params["l2norm.scale"].to(dtype)
        t0 = taps[0].to(dtype)
        sq = (t0 * t0).to(torch.float32).sum(dim=-1, keepdim=True)
        taps[0] = t0 * torch.rsqrt(sq + 1e-12).to(dtype) * scale

    cls_out, box_out = [], []
    for level, (tap, a) in enumerate(zip(taps, cfg.anchors.anchors_per_level)):
        b, h, w, _ = tap.shape
        for kind, out, width in (("cls", cls_out, cfg.model.num_classes), ("box", box_out, 4)):
            key = f"head{level}.{kind}"
            y = _head_conv(tap, params[key + ".weight"], params[key + ".bias"], dtype)
            out.append(y.reshape(b, h * w * a, width))
    return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)


def int8_forward(
    qp: QuantParams,
    spec: Spec,
    cfg: DetectorConfig,
    images: Tensor,
    int8_heads: bool = True,
    concat_heads: bool = True,
    stem_fn: KernelFn = stem_conv12_pool,
    l2norm_fn: KernelFn = l2norm_requant,
    resnet_stem_fn: KernelFn = resnet_stem,
    bottleneck_fn: KernelFn = fused_bottleneck,
    stem_fp_fn: KernelFn = stem_fused_producer,
) -> Tuple[Tensor, Tensor]:
    """Normalized float images (B, S, S, 3) -> (cls_logits, box_offsets),
    int8 trunk. ``concat_heads=False`` (int8 heads only) gives the heads'
    per-level tuples (`apply_heads_int8`). The five kernel functions as in
    `run_int8` and `apply_heads_int8`."""
    fns = dict(stem_fn=stem_fn, resnet_stem_fn=resnet_stem_fn, bottleneck_fn=bottleneck_fn,
               stem_fp_fn=stem_fp_fn)
    with span("odt.forward"):
        if int8_heads:
            taps_q = run_int8(qp, spec, images, dequantize_taps=False, **fns)
            logits_dtype = torch.bfloat16 if cfg.eval.int8_logits_bf16 else torch.float32
            return apply_heads_int8(qp, taps_q, cfg, logits_dtype=logits_dtype,
                                    concat=concat_heads, l2norm_fn=l2norm_fn)
        taps = run_int8(qp, spec, images, **fns)
        return apply_heads(qp.float_params, taps, cfg)


# --------------------------------------------------------------------------
# RetinaNet: int8 ResNet trunk + int8 FPN + int8 shared heads
# --------------------------------------------------------------------------
#
# The int8 dataflow (the reference's quant/engine.py:1397-1411):
#
#   laterals (1x1, int8, float32 out) -> float32 upsample-adds -> requant ->
#   smooths (3x3, int8) -> requant -> P3..P5; P6, a stride-2 int8 conv on
#   C5, requant; ReLU on P6's codes (the requant is monotone and keeps the
#   sign) feeds P7's stride-2 conv; heads: shared int8 weights, per-level
#   activation scales at every intermediate, the out conv emits float32
#   logits (no requant).
#
# The float calibration runner mirrors this dataflow node for node, so the
# absmax is recorded at exactly the tensors the int8 path requants.

FPN_LEVELS = ("P3", "P4", "P5", "P6", "P7")


def fpn_head_conv_paths(cfg: DetectorConfig) -> List[str]:
    """Every conv path of the FPN and the shared heads (their weights are
    quantized)."""
    paths = [f"fpn/lateral{i}" for i in (3, 4, 5)]
    paths += [f"fpn/smooth{i}" for i in (3, 4, 5)]
    paths += ["fpn/p6", "fpn/p7"]
    for head in ("cls_head", "box_head"):
        paths += [f"{head}/conv{i}" for i in range(cfg.model.head_depth)]
        paths.append(f"{head}/out")
    return paths


def _head_width(cfg: DetectorConfig, cls: bool) -> int:
    return cfg.model.num_classes if cls else 4


def run_float_fpn_heads(
    params: Mapping[str, Tensor], cfg: DetectorConfig, taps: List[Tensor],
) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Float32 FPN + heads over the trunk's float taps (NHWC), mirroring the
    int8 dataflow; returns (cls_logits, box_offsets, absmax at every requant
    point): ``fpn/pre3..5`` (the lateral sums), ``fpn/P3..P7`` and
    ``{head}/conv{i}@P{3..7}``. ``params`` is the (folded) state_dict; the
    FPN and head entries are the model's own."""
    absmax: Dict[str, Tensor] = {}

    def conv(x: Tensor, path: str, stride: int = 1) -> Tensor:
        w = params[_key(path) + ".weight"].to(torch.float32)
        y = _conv_float(x, w, ConvOp(path, kernel=w.shape[-1], stride=stride))
        return y + params[_key(path) + ".bias"].to(torch.float32)

    c3, c4, c5 = (t.to(torch.float32) for t in taps)
    pre5 = conv(c5, "fpn/lateral5")
    pre4 = conv(c4, "fpn/lateral4") + fpn_upsample2x(pre5)
    pre3 = conv(c3, "fpn/lateral3") + fpn_upsample2x(pre4)
    pyramid: Dict[str, Tensor] = {}
    for lvl, pre in (("P3", pre3), ("P4", pre4), ("P5", pre5)):
        absmax[f"fpn/pre{lvl[1]}"] = pre.abs().max()
        pyramid[lvl] = conv(pre, f"fpn/smooth{lvl[1]}")
    pyramid["P6"] = conv(c5, "fpn/p6", stride=2)
    pyramid["P7"] = conv(torch.clamp_min(pyramid["P6"], 0.0), "fpn/p7", stride=2)
    for lvl in FPN_LEVELS:
        absmax[f"fpn/{lvl}"] = pyramid[lvl].abs().max()

    outs: Dict[str, List[Tensor]] = {"cls_head": [], "box_head": []}
    for head in outs:
        for lvl in FPN_LEVELS:
            x = pyramid[lvl]
            for i in range(cfg.model.head_depth):
                x = torch.clamp_min(conv(x, f"{head}/conv{i}"), 0.0)
                absmax[f"{head}/conv{i}@{lvl}"] = x.abs().max()
            y = conv(x, f"{head}/out")
            b, h, w, _ = y.shape
            outs[head].append(y.reshape(b, h * w * ANCHORS_PER_LOCATION,
                                        _head_width(cfg, head == "cls_head")))
    return torch.cat(outs["cls_head"], dim=1), torch.cat(outs["box_head"], dim=1), absmax


def run_int8_fpn_heads(
    qp: QuantParams, cfg: DetectorConfig, taps_q: List[Tuple[Tensor, float]],
    logits_dtype: torch.dtype = torch.float32,
    concat: bool = True,
    codes: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Int8 FPN + shared heads over the int8 trunk taps (C3, C4, C5 codes and
    their scales) -> (cls_logits in ``logits_dtype``, box_offsets float32),
    concatenated over levels; with ``concat=False`` per-level tuples of the
    out convs' native (B, H, W, 9*C) and (B, H, W, 9*4) outputs.

    The FPN's lateral sums are float32 and requanted before the smooth convs,
    each lateral's epilogue adding the coarser sum's upsample and writing the
    float32 sum only where the next level reads it; P6's epilogue also writes
    its ReLU'd codes, P7's input. The heads requant each level with its own
    scales; the out conv emits float32. ``codes``, where given, receives the
    int8 codes at every requant point, keyed as their scales are, in the
    reference's order of requants."""
    (q3, s3), (q4, s4), (q5, s5) = taps_q

    def requant(x_q: Tensor, s_in: float, path: str, key: str, relu: bool = False,
                stride: int = 1) -> Tuple[Tensor, float]:
        s = qp.act_scale[key]
        q = _conv_step(qp, x_q, s_in, path, stride, out_scale=s, relu=relu).codes
        if codes is not None:
            codes[key] = q
        return q, s

    def lateral(x_q: Tensor, s_in: float, level: int, coarse: Optional[Tensor] = None,
                keep_sum: bool = False) -> epilogue_kernel.Epilogue:
        return _conv_step(qp, x_q, s_in, f"fpn/lateral{level}",
                          out_scale=qp.act_scale[f"fpn/pre{level}"], addend=coarse,
                          sum_dtype=torch.float32 if keep_sum else None)

    pre5 = lateral(q5, s5, 5, keep_sum=True)
    pre4 = lateral(q4, s4, 4, pre5.sum, keep_sum=True)
    pre3 = lateral(q3, s3, 3, pre4.sum)
    pyramid: Dict[str, Tuple[Tensor, float]] = {}
    for lvl, pre in (("P3", pre3), ("P4", pre4), ("P5", pre5)):
        key = f"fpn/pre{lvl[1]}"
        if codes is not None:
            codes[key] = pre.codes
        pyramid[lvl] = requant(pre.codes, qp.act_scale[key], f"fpn/smooth{lvl[1]}", f"fpn/{lvl}")
    s_p6 = qp.act_scale["fpn/P6"]
    p6 = _conv_step(qp, q5, s5, "fpn/p6", 2, out_scale=s_p6, relu_codes=True)
    if codes is not None:
        codes["fpn/P6"] = p6.codes
    pyramid["P6"] = (p6.codes, s_p6)
    pyramid["P7"] = requant(p6.relu_codes, s_p6, "fpn/p7", "fpn/P7", stride=2)

    outs: Dict[str, List[Tensor]] = {"cls_head": [], "box_head": []}
    for head in outs:
        for lvl in FPN_LEVELS:
            x_q, s_x = pyramid[lvl]
            for i in range(cfg.model.head_depth):
                x_q, s_x = requant(x_q, s_x, f"{head}/conv{i}", f"{head}/conv{i}@{lvl}",
                                   relu=True)
            outs[head].append(_head_out(qp, cfg, x_q, s_x, f"{head}/out", head == "cls_head",
                                        ANCHORS_PER_LOCATION, logits_dtype, concat))
    return _head_outputs(outs["cls_head"], outs["box_head"], concat)


def quantize_retinanet(
    cfg: DetectorConfig,
    params: Mapping[str, Tensor],
    calibration_batches: Sequence[Tensor],
    quantize_fpn_heads: bool = True,
    spec: Optional[Spec] = None,
) -> Tuple[QuantParams, Spec]:
    """PTQ for RetinaNet: fold the backbone's BatchNorm, calibrate the trunk
    and (``quantize_fpn_heads``) the FPN and heads on the same batches (the
    maximum absmax over batches, then ``max(v, 1e-6) / 127``), and quantize
    the trunk without SSD heads plus every path of `fpn_head_conv_paths`.
    ``params`` is the model's state_dict with the running statistics;
    ``spec`` overrides `build_resnet_trunk_spec`'s op list."""
    if spec is None:
        spec = build_resnet_trunk_spec()
    folded = fold_resnet50(params)
    scales = calibrate_scales(folded, spec, calibration_batches, use_l2norm=False,
                              fpn_cfg=cfg if quantize_fpn_heads else None)
    heads = fpn_head_conv_paths(cfg) if quantize_fpn_heads else ()
    return quantize_params(folded, spec, scales, head_paths=heads), spec


def _float_fpn_heads(qp: QuantParams, cfg: DetectorConfig, device: torch.device):
    """The model's FPN and heads on ``qp.float_params``, on ``device``, made
    once per QuantParams."""
    def make():
        model = RetinaNetModel(cfg)
        parts = (model.fpn, model.cls_head, model.box_head)
        for name, part in zip(("fpn", "cls_head", "box_head"), parts):
            part.load_state_dict({k[len(name) + 1:]: v for k, v in qp.float_params.items()
                                  if k.startswith(name + ".")})
            part.requires_grad_(False).to(device).eval()
        return parts

    return qp.derived(("float_fpn_heads", device), make)


def retinanet_int8_forward(
    qp: QuantParams,
    spec: Spec,
    cfg: DetectorConfig,
    images: Tensor,
    dtype: torch.dtype = torch.bfloat16,
    concat_heads: bool = True,
    resnet_stem_fn: KernelFn = resnet_stem,
    bottleneck_fn: KernelFn = fused_bottleneck,
) -> Tuple[Tensor, Tensor]:
    """Normalized float images (B, S, S, 3) -> (cls_logits, box_offsets),
    int8 trunk. With the FPN's weights in ``qp`` (`quantize_retinanet`'s
    default) the FPN and heads run int8 (`run_int8_fpn_heads`); otherwise
    the model's float FPN and heads run in ``dtype`` over the dequantized
    taps. ``concat_heads=False`` (int8 FPN and heads only) gives the heads'
    per-level tuples (`run_int8_fpn_heads`). The two kernel functions as in
    `run_int8`."""
    fns = dict(resnet_stem_fn=resnet_stem_fn, bottleneck_fn=bottleneck_fn)
    with span("odt.forward"):
        if "fpn/lateral3" in qp.w_int8:
            taps_q = run_int8(qp, spec, images, dequantize_taps=False, **fns)
            logits_dtype = torch.bfloat16 if cfg.eval.int8_logits_bf16 else torch.float32
            return run_int8_fpn_heads(qp, cfg, taps_q, logits_dtype=logits_dtype,
                                      concat=concat_heads)
        taps = run_int8(qp, spec, images, **fns)
        fpn, cls_head, box_head = _float_fpn_heads(qp, cfg, images.device)
        pyramid = fpn([t.to(dtype).permute(0, 3, 1, 2) for t in taps])
        cls = [cls_head(p).float() for p in pyramid]
        box = [box_head(p).float() for p in pyramid]
        return torch.cat(cls, dim=1), torch.cat(box, dim=1)


# --------------------------------------------------------------------------
# DETR: int8 ResNet-50-DC5 trunk + bfloat16 transformer + float32 heads
# --------------------------------------------------------------------------
#
# The trunk runs int8 as RetinaNet's does (B6 stem, B7 for the stride-1
# undilated blocks, the unfused chain for DC5's dilated ones). Its C5 codes
# go into ``input_proj`` as bfloat16 integers, the dequant scale folded into
# the projection's weight; the transformer runs in bfloat16 (LayerNorm and
# the attention's softmax keep their statistics in float32), the heads in
# float32 (`models.detr.DETRModel.transform`).

# The float modules of DETR after the trunk, which stay float.
DETR_FLOAT_PARTS = ("input_proj", "transformer", "query_embed", "class_embed", "bbox_embed")
# The dtype of ``input_proj`` and the transformer on the int8 path.
DETR_DTYPE = torch.bfloat16


def quantize_detr(
    cfg: DetectorConfig,
    params: Mapping[str, Tensor],
    calibration_batches: Sequence[Tensor],
) -> Tuple[QuantParams, Spec]:
    """PTQ for DETR: fold the trunk's BatchNorm, calibrate the trunk on the
    batches (normalized canvases, zero beyond each image's extent) and
    quantize its convs. Everything after the trunk stays in
    ``qp.float_params``."""
    spec = build_resnet_trunk_spec(dilate_c5=cfg.transformer.dilate_c5)
    folded = fold_resnet50(params)
    scales = calibrate_scales(folded, spec, calibration_batches, use_l2norm=False)
    return quantize_params(folded, spec, scales, head_paths=()), spec


def _float_after_trunk(qp: QuantParams, cfg: DetectorConfig,
                       device: torch.device) -> torch.nn.Module:
    """The model's parts after the trunk on ``qp.float_params`` (DETR's or
    Deformable DETR's, `DETR_FLOAT_PARTS`), on ``device``, the transformer
    in `DETR_DTYPE`; made once per QuantParams."""
    def make():
        with torch.device("meta"):
            model = build_model(cfg)
        model.backbone = None
        for name in DETR_FLOAT_PARTS:
            getattr(model, name).load_state_dict(
                {k[len(name) + 1:]: v for k, v in qp.float_params.items()
                 if k.startswith(name + ".")}, assign=True)
        model.requires_grad_(False).to(device).eval()
        model.hold_transformer_in(DETR_DTYPE)
        return model

    return qp.derived(("float_after_trunk", device), make)


def _detr_input_proj(model: DETRModel, c5_scale: float):
    """``input_proj`` on C5 codes: its (d, 2048) weight times the codes'
    scale and its bias, in `DETR_DTYPE`."""
    conv = model.input_proj
    weight = conv.weight.reshape(conv.weight.shape[0], -1)
    scale = int8_ops.scale_tensor(c5_scale, weight.device)
    return (weight * scale).to(DETR_DTYPE), conv.bias.to(DETR_DTYPE)


def detr_int8_forward(
    qp: QuantParams,
    spec: Spec,
    cfg: DetectorConfig,
    images: Tensor,
    extents: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Normalized canvases (B, S, S, 3), zero beyond each image's (B, 2)
    extent (h, w), -> (logits (B, Q, C + 1), boxes (B, Q, 4) cx, cy, w, h
    in [0, 1] of the extent), float32. The trunk under
    ``odt.detr.backbone`` with ``input_proj``, then the transformer and
    heads of `DETRModel.transform`."""
    dev = images.device
    model = _float_after_trunk(qp, cfg, dev)
    with span("odt.forward"):
        with span("odt.detr.backbone"):
            c5, s5 = run_int8(qp, spec, images, dequantize_taps=False)[-1]
            weight, bias = qp.derived(("detr_input_proj", s5, dev),
                                      lambda: _detr_input_proj(model, s5))
            b, h, w, c = c5.shape
            src = F.linear(c5.reshape(b, h * w, c).to(DETR_DTYPE), weight, bias)
        return model.transform(src, extents, tuple(images.shape[1:3]), (h, w), DETR_DTYPE)


# --------------------------------------------------------------------------
# Deformable DETR: int8 ResNet-50 trunk + bfloat16 levels and transformer
# --------------------------------------------------------------------------
#
# The trunk is RetinaNet's (undilated: B6, B7, the one-kernel 3x3 convs), and
# all three of its taps leave it as codes. Each level's projection takes its
# tap's codes as bfloat16 integers, the tap's scale folded into its weight;
# GroupNorm, the transformer and its sampling core (`kernels.msda`) then run
# as in the float model, in bfloat16 with their statistics, offsets and
# softmax weights in float32, the heads in float32
# (`models.deformable_detr.DeformableDETRModel.transform`).


def quantize_deformable_detr(
    cfg: DetectorConfig,
    params: Mapping[str, Tensor],
    calibration_batches: Sequence[Tensor],
) -> Tuple[QuantParams, Spec]:
    """PTQ for Deformable DETR: fold the trunk's BatchNorm, calibrate the
    undilated trunk on the batches (normalized canvases, zero beyond each
    image's extent) and quantize its convs. Everything after the trunk stays
    in ``qp.float_params``."""
    spec = build_resnet_trunk_spec()
    folded = fold_resnet50(params)
    scales = calibrate_scales(folded, spec, calibration_batches, use_l2norm=False)
    return quantize_params(folded, spec, scales, head_paths=()), spec


def deformable_detr_int8_forward(
    qp: QuantParams,
    spec: Spec,
    cfg: DetectorConfig,
    images: Tensor,
    extents: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Normalized canvases (B, S, S, 3), zero beyond each image's (B, 2)
    extent (h, w), -> (logits (B, Q, C), boxes (B, Q, 4) cx, cy, w, h in
    [0, 1] of the extent), float32. The trunk and the four levels under
    ``odt.deformable.backbone``, then the transformer and heads of
    `DeformableDETRModel.transform`."""
    dev = images.device
    model = _float_after_trunk(qp, cfg, dev)
    with span("odt.forward"):
        with span("odt.deformable.backbone"):
            taps = run_int8(qp, spec, images, dequantize_taps=False)
            scales = tuple(s for _, s in taps)
            proj = qp.derived(("deformable_proj", scales, dev),
                              lambda: model.projections(DETR_DTYPE, scales))
            srcs, shapes = model.levels([codes.to(DETR_DTYPE) for codes, _ in taps], proj)
        return model.transform(srcs, shapes, extents, tuple(images.shape[1:3]), DETR_DTYPE)
