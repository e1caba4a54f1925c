"""Structured JSONL metrics logging + stderr echo (the port's own copy of
``object_detector_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

_LOG = logging.getLogger("object_detector_tpu_torch")


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    if not _LOG.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        _LOG.addHandler(handler)
        _LOG.setLevel(level)
    return _LOG


class MetricsLogger:
    """Append-only JSONL metrics stream, one object per step/event."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._file = open(path, "a", buffering=1) if path else None
        self._echo = echo
        self._log = setup_logging()

    def log(self, kind: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"ts": time.time(), "kind": kind}
        rec.update(
            {k: (float(v) if hasattr(v, "item") else v) for k, v in fields.items()}
        )
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
        if self._echo:
            body = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("ts", "kind")
            )
            self._log.info("%s %s", kind, body)

    def close(self) -> None:
        if self._file:
            self._file.close()
