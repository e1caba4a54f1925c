"""CLI entry points of the port.

    python -m object_detector_tpu_torch predict --preset ssd300_vgg16_voc --image dog.jpg --output out.jpg

``predict`` serves the float model, or with ``--int8`` the int8 engine
(calibrated on 8 random images from a seed), with random weights from a seed
(smoke mode), on the card unless ``--device cpu`` is given. Checkpoint
restore, ``train`` and ``evaluate`` are not ported yet: they say so and exit
with code 2. Config fields are overridable with
``--set eval.score_threshold=0.05`` (repeatable).
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from typing import Any, Dict, List

from object_detector_tpu_torch.core.config import DetectorConfig, get_config, list_presets

NOT_PORTED = 2


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


def _not_ported(what: str) -> int:
    print(f"{what} is not ported yet", file=sys.stderr)
    return NOT_PORTED


def cmd_predict(args: argparse.Namespace) -> int:
    if args.checkpoint:
        return _not_ported("checkpoint restore (--checkpoint)")
    cfg = _load_config(args)
    from object_detector_tpu_torch.cli.predictor import Predictor
    from object_detector_tpu_torch.convert import init_params
    from object_detector_tpu_torch.models.ssd import SSDModel

    params = init_params(SSDModel(cfg), seed=0).state_dict()  # smoke mode
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="object_detector_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("predict", help="detect objects in one image")
    sp.add_argument("--preset", default="ssd300_vgg16_voc", choices=list_presets())
    sp.add_argument("--set", action="append", metavar="KEY=VALUE")
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--image", required=True)
    sp.add_argument("--checkpoint", default=None, help="not ported yet")
    sp.add_argument("--output", default=None, help="draw detections here")
    sp.add_argument("--score-threshold", type=float, default=0.3)
    sp.add_argument("--int8", action="store_true", help="serve the int8 PTQ engine")
    sp.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_predict)

    for name in ("train", "evaluate"):
        sp = sub.add_parser(name, help="not ported yet")
        sp.set_defaults(fn=lambda a, name=name: _not_ported(f"the {name} command"))
    return p


def main(argv=None) -> int:
    parser = build_parser()
    # Unported commands take whatever flags the reference's do.
    args, unknown = parser.parse_known_args(argv)
    if unknown and args.command == "predict":
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
