"""CLI entry points of the port.

    python -m object_detector_tpu_torch train    --preset ssd300_vgg16_voc --data-root /data/VOCdevkit --checkpoint ckpt/
    python -m object_detector_tpu_torch predict  --preset ssd300_vgg16_voc --checkpoint ckpt/ --image dog.jpg --output out.jpg
    python -m object_detector_tpu_torch evaluate --preset ssd300_vgg16_voc --checkpoint ckpt/ --data-root /data/VOCdevkit [--int8]

``train`` trains any preset's model (SSD-300/VGG16, SSD-512/ResNet-50 and
RetinaNet/FPN, the last two with BatchNorm batch statistics), data-parallel
over ``mesh.data_parallel`` devices: started by torchrun
(``python -m torch.distributed.run --nproc_per_node 8 -m
object_detector_tpu_torch train ...``) each process is one rank; started
alone with ``mesh.data_parallel`` above 1 it spawns a process a card.
``predict`` serves the float model of any preset, or with ``--int8`` the
int8 engine (calibrated on 8 random images from a seed), with the weights
of ``--checkpoint`` (a directory ``train`` wrote; the EMA weights if it
holds them, with the running statistics) or random weights from a seed
(smoke mode). ``evaluate`` sweeps a split (``--split``, default
``data.val_split``) through the float model or, with ``--int8``, the int8
engine, and prints the mAP dict of ``eval.map_style``. ``train`` and
``evaluate`` read ``data.dataset``: VOC, COCO or the synthetic set. All
three run on the card unless ``--device cpu`` is given. Config fields are
overridable with ``--set eval.score_threshold=0.05`` (repeatable).
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from typing import Any, Dict, List

import torch

from object_detector_tpu_torch.core.config import DetectorConfig, get_config, list_presets

def _parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if not raw:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def _load_config(args: argparse.Namespace) -> DetectorConfig:
    cfg = get_config(args.preset)
    overrides = _parse_overrides(args.set or [])
    if getattr(args, "data_root", None):
        overrides.setdefault("data.root", args.data_root)
    return cfg.override(overrides)


def _load_dataset(cfg: DetectorConfig, split: str):
    if cfg.data.dataset == "voc":
        from object_detector_tpu_torch.data.voc import load_voc

        return load_voc(cfg.data.root, split)
    if cfg.data.dataset == "coco":
        from object_detector_tpu_torch.data.coco import load_coco

        return load_coco(cfg.data.root, split)
    from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(image_size=cfg.model.image_size)


def _restore_variables(cfg: DetectorConfig, checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """The state_dict to serve from a directory `train` wrote: the EMA
    weights if the checkpoint holds them, else the parameters, with the
    BatchNorm running statistics (which have no EMA)."""
    from object_detector_tpu_torch.train.checkpoint import CheckpointManager
    from object_detector_tpu_torch.train.loop import init_model_state

    _, state = init_model_state(cfg, seed=0, device="cpu")
    restored = CheckpointManager(checkpoint_dir).restore(state, torch.Generator())
    if restored is None:
        raise SystemExit(f"no checkpoint found in {checkpoint_dir}")
    state = restored[0]
    params = state.ema_params if state.ema_params is not None else state.params
    return {k: v.detach() for k, v in {**params, **state.batch_stats}.items()}


def cmd_train(args: argparse.Namespace) -> int:
    import torch.distributed as dist

    from object_detector_tpu_torch.parallel.mesh import maybe_init_distributed, world_size
    from object_detector_tpu_torch.train.loop import train

    made_group = maybe_init_distributed(args.device)
    try:
        cfg = _load_config(args)
        # Too few devices for mesh.data_parallel fails here, before the
        # dataset is read.
        world_size(cfg.mesh.data_parallel, args.device)
        dataset = _load_dataset(cfg, cfg.data.train_split)
        train(
            cfg,
            dataset,
            num_steps=args.steps,
            metrics_path=args.metrics,
            resume=args.resume,
            checkpoint_dir=args.checkpoint,
            profile_dir=args.profile,
            device=args.device,
        )
    finally:
        if made_group:
            dist.destroy_process_group()
    return 0


def cmd_predict(args: argparse.Namespace) -> int:
    cfg = _load_config(args)
    from object_detector_tpu_torch.cli.predictor import Predictor
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.models.retinanet import build_model

    if args.checkpoint:
        params = _restore_variables(cfg, args.checkpoint)
    else:  # random weights: smoke mode
        params = init_params(build_model(cfg), seed=0).state_dict()
    class_names = None
    if cfg.data.dataset == "voc":
        from object_detector_tpu_torch.data.voc import VOC_CLASSES

        class_names = VOC_CLASSES
    predictor = Predictor(cfg, params, class_names, device=args.device, int8=args.int8)
    dets = predictor.predict_file(args.image, args.score_threshold, args.output)
    for d in dets:
        print(
            json.dumps(
                {
                    "class": d.class_name,
                    "score": round(d.score, 4),
                    "box": [round(float(v), 1) for v in d.box],
                }
            )
        )
    return 0


def cmd_evaluate(args: argparse.Namespace) -> int:
    cfg = _load_config(args)
    from object_detector_tpu_torch.eval.evaluator import evaluate_dataset

    dataset = _load_dataset(cfg, args.split or cfg.data.val_split)
    params = _restore_variables(cfg, args.checkpoint)
    result = evaluate_dataset(cfg, params, dataset, int8=args.int8, device=args.device)
    print(json.dumps(result))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="object_detector_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--preset", default="ssd300_vgg16_voc", choices=list_presets())
        sp.add_argument("--set", action="append", metavar="KEY=VALUE")
        sp.add_argument("--data-root", default=None)
        sp.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    sp = sub.add_parser("train", help="train a detector")
    common(sp)
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--metrics", default=None, help="JSONL metrics path")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--profile", default=None, help="torch.profiler trace dir")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("predict", help="detect objects in one image")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--checkpoint", default=None, help="a directory `train` wrote")
    sp.add_argument("--output", default=None, help="draw detections here")
    sp.add_argument("--score-threshold", type=float, default=0.3)
    sp.add_argument("--int8", action="store_true", help="serve the int8 PTQ engine")
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("evaluate", help="compute mAP on a val split")
    common(sp)
    sp.add_argument("--checkpoint", required=True, help="a directory `train` wrote")
    sp.add_argument("--split", default=None)
    sp.add_argument("--int8", action="store_true", help="serve through the int8 PTQ engine")
    sp.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
