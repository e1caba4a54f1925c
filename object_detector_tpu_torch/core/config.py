"""Frozen dataclass configuration schema + named presets.

The port's own copy of ``object_detector_tpu/core/config.py``: the same
fields, defaults and presets, so a preset resolves to the same values in
both packages (``tests/test_torch_config.py`` compares them). The reasons
behind each default are documented beside the reference's copy.

The port adds what the reference does not have: the DETR family
(``family="detr"``, `TransformerConfig`, the preset ``detr_r50_dc5_coco``
and `tiny_detr_config`) and Deformable DETR (``family="deformable_detr"``,
`DeformableConfig`, the preset ``deformable_detr_r50_coco`` and
`tiny_deformable_detr_config`). Each family's section sits in a field of its
own (``transformer``, ``deformable``), so every section the reference has,
and DETR's, resolves as before.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Prior-box (anchor) generation parameters (SSD arXiv:1512.02325 §2.2)."""

    feature_sizes: Tuple[int, ...] = (38, 19, 10, 5, 3, 1)
    # Per-level (min_size, max_size) in input pixels.
    sizes: Tuple[Tuple[float, float], ...] = (
        (30.0, 60.0),
        (60.0, 111.0),
        (111.0, 162.0),
        (162.0, 213.0),
        (213.0, 264.0),
        (264.0, 315.0),
    )
    aspect_ratios: Tuple[Tuple[float, ...], ...] = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,))
    center_variance: float = 0.1
    size_variance: float = 0.2
    clip: bool = True
    # Non-None overrides the SSD 2+2r per-location count (RetinaNet: 9).
    explicit_anchors_per_location: Tuple[int, ...] | None = None

    @property
    def anchors_per_level(self) -> Tuple[int, ...]:
        if self.explicit_anchors_per_location is not None:
            return self.explicit_anchors_per_location
        return tuple(2 + 2 * len(r) for r in self.aspect_ratios)

    @property
    def num_anchors(self) -> int:
        return sum(
            f * f * a for f, a in zip(self.feature_sizes, self.anchors_per_level)
        )


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    positive_iou: float = 0.5
    negative_iou: float = 0.5
    force_match_best: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    family: str = "ssd"  # "ssd" | "retinanet" | "detr" | "deformable_detr"
    backbone: str = "vgg16"  # "vgg16" | "resnet50"
    image_size: int = 300
    num_classes: int = 20  # foreground classes (VOC=20, COCO=80)
    fpn_channels: int = 256
    head_depth: int = 4
    l2norm_scale: float = 20.0
    # Compute dtype for conv stacks; params stay float32.
    compute_dtype: str = "bfloat16"
    # TPU layout / memory devices of the reference with unchanged math; the
    # port accepts them and ignores them.
    pack_block1: bool = True
    pool_grad_kernel: bool = False
    remat_block1: bool = False

    @property
    def num_levels(self) -> int:
        if self.family == "retinanet":
            return 5
        return 7 if self.image_size >= 512 else 6


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip_prob: float = 0.5
    crop_prob: float = 0.875
    crop_candidates: int = 16
    crop_min_ious: Tuple[float, ...] = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9)
    crop_area_range: Tuple[float, float] = (0.1, 1.0)
    crop_aspect_range: Tuple[float, float] = (0.5, 2.0)
    brightness_delta: float = 32.0 / 255.0
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    saturation_range: Tuple[float, float] = (0.5, 1.5)
    hue_delta: float = 18.0 / 360.0
    expand_prob: float = 0.5
    expand_max_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "voc"  # "voc" | "coco" | "synthetic"
    root: str = ""
    train_split: str = "trainval"
    val_split: str = "test"
    max_boxes: int = 100
    num_workers: int = 4
    prefetch: int = 2
    cache_decoded: bool = True
    max_cache_ram_gb: float = 8.0
    cache_spill_dir: str = ""
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    num_steps: int = 120_000
    optimizer: str = "sgd"  # "sgd" | "adamw"
    base_lr: float = 1e-3
    warmup_steps: int = 1000
    schedule: str = "cosine"  # "cosine" | "step"
    momentum: float = 0.9
    weight_decay: float = 5e-4
    grad_clip_norm: float = 10.0
    ema_decay: float = 0.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 1.0
    box_loss_weight: float = 1.0
    use_focal: bool = True
    negatives_per_positive: int = 3
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    log_every: int = 50
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 64
    score_threshold: float = 0.01
    nms_iou_threshold: float = 0.45
    pre_nms_top_k: int = 256  # candidates M = 2 * pre_nms_top_k
    max_detections: int = 200  # per image, after NMS
    map_style: str = "voc07"  # "voc07" | "voc10" | "coco"
    use_pallas_nms: bool = True  # True: the hand-written NMS kernel path
    # False asks the reference for approx_max_k on a TPU; the port, like the
    # reference off a TPU, always selects exactly.
    nms_exact_prefilter: bool = True
    nms_recall_target: float = 0.95
    nms_max_per_class: int = 100
    # Not ported yet (raise NotImplementedError when set): nms_class_top_k > 0,
    # nms_packed_sort, nms_coord_bf16, per_level_heads.
    nms_class_top_k: int = 0
    int8_logits_bf16: bool = False
    nms_packed_sort: bool = False
    nms_coord_bf16: bool = False
    per_level_heads: bool = False


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """DETR's transformer and the trunk variant it sits on (arXiv:2005.12872
    section 3.2): post-norm encoder and decoder layers of width ``d_model``
    with ``heads`` attention heads and a ReLU feed-forward of ``ffn``,
    ``queries`` learned object queries, and with ``dilate_c5`` the DC5
    trunk (stage 4 at stride 1, its blocks 2 and 3 dilated by 2). Read only
    by the DETR family."""

    d_model: int = 256
    heads: int = 8
    ffn: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    queries: int = 100
    dilate_c5: bool = True


@dataclasses.dataclass(frozen=True)
class DeformableConfig:
    """Deformable DETR's transformer (arXiv:2010.04159 section 4.1 and
    section 5's defaults; single-stage, no box refinement): post-norm layers
    of width ``d_model`` with ``heads`` heads and a ReLU feed-forward of
    ``ffn``, multi-scale deformable attention over ``levels`` feature levels
    (C3 to C5 and a stride-2 conv on C5) with ``enc_points`` and
    ``dec_points`` sampling points a level and head, GroupNorm of
    ``gn_groups`` groups after each input projection, ``queries`` learned
    queries, and the ``top_k`` detections an image of its postprocess. Read
    only by the deformable_detr family."""

    d_model: int = 256
    heads: int = 8
    ffn: int = 1024
    enc_layers: int = 6
    dec_layers: int = 6
    queries: int = 300
    levels: int = 4
    enc_points: int = 4
    dec_points: int = 4
    gn_groups: int = 32
    top_k: int = 100


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    data_parallel: int = -1


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    name: str = "ssd300_vgg16_voc"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    transformer: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    deformable: DeformableConfig = dataclasses.field(default_factory=DeformableConfig)

    def replace(self, **kw: Any) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)

    def override(self, dotted: Mapping[str, Any]) -> "DetectorConfig":
        """Apply {'eval.score_threshold': 0.05}-style overrides (CLI surface)."""
        cfg = self
        for key, value in dotted.items():
            cfg = _set_dotted(cfg, key.split("."), value)
        return cfg


def _set_dotted(node: Any, parts: Sequence[str], value: Any) -> Any:
    if len(parts) == 1:
        field_names = {f.name for f in dataclasses.fields(node)}
        if parts[0] not in field_names:
            raise KeyError(f"unknown config field {parts[0]!r} on {type(node).__name__}")
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(node, **{parts[0]: _set_dotted(child, parts[1:], value)})


# --------------------------------------------------------------------------
# Anchor geometry per model family
# --------------------------------------------------------------------------

def ssd300_anchor_config() -> AnchorConfig:
    return AnchorConfig()  # defaults are the canonical SSD-300 set (8732)


def ssd512_anchor_config() -> AnchorConfig:
    return AnchorConfig(
        feature_sizes=(64, 32, 16, 8, 4, 2, 1),
        sizes=(
            (35.84, 76.8),
            (76.8, 153.6),
            (153.6, 230.4),
            (230.4, 307.2),
            (307.2, 384.0),
            (384.0, 460.8),
            (460.8, 537.6),
        ),
        aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,)),
    )


def retinanet_anchor_config(image_size: int = 512) -> AnchorConfig:
    feats = tuple(max(1, image_size // s) for s in (8, 16, 32, 64, 128))
    base = tuple((4.0 * s, 4.0 * s * 2 ** (1 / 3)) for s in (8, 16, 32, 64, 128))
    return AnchorConfig(
        feature_sizes=feats,
        sizes=base,
        aspect_ratios=((0.5, 2.0),) * 5,  # unused: explicit count below wins
        center_variance=0.1,
        size_variance=0.2,
        explicit_anchors_per_location=(9,) * 5,
    )


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------

def _ssd300_vgg16_voc() -> DetectorConfig:
    return DetectorConfig(
        name="ssd300_vgg16_voc",
        model=ModelConfig(family="ssd", backbone="vgg16", image_size=300, num_classes=20),
        anchors=ssd300_anchor_config(),
        data=DataConfig(dataset="voc"),
    )


def _ssd300_infer_bs64() -> DetectorConfig:
    cfg = _ssd300_vgg16_voc()
    return cfg.replace(name="ssd300_infer_bs64", eval=dataclasses.replace(cfg.eval, batch_size=64))


def _ssd512_resnet50_coco() -> DetectorConfig:
    return DetectorConfig(
        name="ssd512_resnet50_coco",
        model=ModelConfig(family="ssd", backbone="resnet50", image_size=512, num_classes=80),
        anchors=ssd512_anchor_config(),
        data=DataConfig(dataset="coco"),
        eval=EvalConfig(map_style="coco", int8_logits_bf16=True,
                        nms_exact_prefilter=True),
    )


def _ssd300_voc_train_dp8() -> DetectorConfig:
    cfg = _ssd300_vgg16_voc()
    return cfg.replace(
        name="ssd300_voc_train_dp8",
        train=dataclasses.replace(cfg.train, batch_size=256),
        mesh=MeshConfig(data_parallel=8),
    )


def _retinanet_fpn_coco() -> DetectorConfig:
    return DetectorConfig(
        name="retinanet_fpn_coco",
        model=ModelConfig(family="retinanet", backbone="resnet50", image_size=512, num_classes=80),
        anchors=retinanet_anchor_config(512),
        data=DataConfig(dataset="coco"),
        eval=EvalConfig(map_style="coco", int8_logits_bf16=True,
                        nms_exact_prefilter=False),
        mesh=MeshConfig(data_parallel=16),
    )


def _detr_r50_dc5_coco() -> DetectorConfig:
    """DETR-DC5 on ResNet-50 (arXiv:2005.12872 Table 1), served on 1088 x
    1088 canvases: section 4's images (shortest side 800, longest at most
    1333) padded to the canvas, each with its extent. 91 COCO ids, so 92
    logits with "no object"."""
    return DetectorConfig(
        name="detr_r50_dc5_coco",
        model=ModelConfig(family="detr", backbone="resnet50", image_size=1088, num_classes=91),
        data=DataConfig(dataset="coco"),
        eval=EvalConfig(batch_size=32, map_style="coco"),
        transformer=TransformerConfig(),
    )


def _deformable_detr_r50_coco() -> DetectorConfig:
    """Deformable DETR on ResNet-50 (arXiv:2010.04159 Table 1, single-stage,
    no box refinement), served on 1088 x 1088 canvases as DETR-DC5 is: each
    image padded to the canvas with its extent. 91 COCO ids, sigmoid scores
    (no "no object" logit)."""
    return DetectorConfig(
        name="deformable_detr_r50_coco",
        model=ModelConfig(family="deformable_detr", backbone="resnet50", image_size=1088,
                          num_classes=91),
        data=DataConfig(dataset="coco"),
        eval=EvalConfig(batch_size=32, map_style="coco"),
        deformable=DeformableConfig(),
    )


_PRESETS = {
    "tiny_test": lambda: tiny_test_config(),
    "ssd300_vgg16_voc": _ssd300_vgg16_voc,
    "ssd300_infer_bs64": _ssd300_infer_bs64,
    "ssd512_resnet50_coco": _ssd512_resnet50_coco,
    "ssd300_voc_train_dp8": _ssd300_voc_train_dp8,
    "retinanet_fpn_coco": _retinanet_fpn_coco,
    "detr_r50_dc5_coco": _detr_r50_dc5_coco,
    "deformable_detr_r50_coco": _deformable_detr_r50_coco,
}


def tiny_test_config(num_classes: int = 3) -> DetectorConfig:
    """Small SSD/VGG config (64px, 2 levels) for CPU tests and dry runs."""
    return DetectorConfig(
        name="tiny_test",
        model=ModelConfig(family="ssd", backbone="vgg16", image_size=64,
                          num_classes=num_classes, compute_dtype="float32"),
        anchors=AnchorConfig(
            feature_sizes=(8, 4),
            sizes=((16.0, 32.0), (32.0, 48.0)),
            aspect_ratios=((2.0,), (2.0,)),
        ),
        data=DataConfig(dataset="synthetic", max_boxes=8),
        train=TrainConfig(batch_size=8, num_steps=50, warmup_steps=0,
                          base_lr=1e-2, checkpoint_every=10**9, log_every=10),
        eval=EvalConfig(batch_size=8, pre_nms_top_k=64, max_detections=16,
                        use_pallas_nms=False),
    )


def tiny_retinanet_config(num_classes: int = 3) -> DetectorConfig:
    """Small RetinaNet/FPN config (128 px, the smallest size where P7 is
    1x1) for CPU tests."""
    size = 128
    return DetectorConfig(
        name="tiny_retinanet",
        model=ModelConfig(
            family="retinanet", backbone="resnet50", image_size=size,
            num_classes=num_classes, fpn_channels=32, head_depth=1,
            compute_dtype="float32",
        ),
        anchors=retinanet_anchor_config(size),
        data=DataConfig(dataset="synthetic", max_boxes=4),
        train=TrainConfig(batch_size=8, num_steps=10, warmup_steps=0,
                          base_lr=1e-2, optimizer="sgd",
                          checkpoint_every=10**9, log_every=10),
        eval=EvalConfig(batch_size=8, pre_nms_top_k=64, max_detections=16,
                        use_pallas_nms=False),
    )


def tiny_detr_config(num_classes: int = 5) -> DetectorConfig:
    """Small DETR-DC5 (128 px canvas, C5 of 8 x 8, d_model 64, 4 heads,
    2 + 2 layers, 10 queries) for CPU tests."""
    return DetectorConfig(
        name="tiny_detr",
        model=ModelConfig(family="detr", backbone="resnet50", image_size=128,
                          num_classes=num_classes, compute_dtype="float32"),
        data=DataConfig(dataset="synthetic", max_boxes=4),
        eval=EvalConfig(batch_size=4, map_style="coco"),
        transformer=TransformerConfig(d_model=64, heads=4, ffn=128, enc_layers=2,
                                      dec_layers=2, queries=10),
    )


def tiny_deformable_detr_config(num_classes: int = 5) -> DetectorConfig:
    """Small Deformable DETR (128 px canvas, levels of 16, 8, 4 and 2 cells,
    d_model 64 in 2 heads of 32, 2 + 2 layers, 10 queries, the top 20) for
    CPU tests."""
    return DetectorConfig(
        name="tiny_deformable_detr",
        model=ModelConfig(family="deformable_detr", backbone="resnet50", image_size=128,
                          num_classes=num_classes, compute_dtype="float32"),
        data=DataConfig(dataset="synthetic", max_boxes=4),
        eval=EvalConfig(batch_size=4, map_style="coco"),
        deformable=DeformableConfig(d_model=64, heads=2, ffn=128, enc_layers=2, dec_layers=2,
                                    queries=10, gn_groups=8, top_k=20),
    )


def list_presets() -> Tuple[str, ...]:
    return tuple(_PRESETS)


def get_config(name: str) -> DetectorConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]()
