"""One run of one cell: find its files by name, run its driver, check what
the timed path produced against the reference, print the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (the configuration as run), ``traffic/<mix>.json``
(its ``mode`` names the driver, ``drivers/<mode>.py``),
``cells/<workload>.json`` (the limits of the correctness check) and
``metrics/<metric>.py`` (one reader per per-layer metric).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from port_bench import check

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "object_detector_tpu")
# The traced part of a --trace 1 window: its last TRACE_SECONDS, at most half.
TRACE_SECONDS = 2.0
EXIT_NO_CARD, EXIT_BAD_CELL, EXIT_FORBIDDEN = 3, 2, 4


class NoCard(RuntimeError):
    pass


class UnknownCell(LookupError):
    pass


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def cell_files(m: dict, workload: str) -> dict:
    """The cell's entry and the files it names."""
    cells = {c["name"]: c for c in m["workloads"]}
    if workload not in cells:
        raise UnknownCell(f"no workload {workload!r} in {MANIFEST.name}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "cells" / f"{workload}.json")
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits}


def reported_metrics(m: dict, workload: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones:
    those that list it, or list no cells and move an end-to-end metric it
    reports."""
    def here(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [x for x in m["end_to_end"] if here(x)]
    if not traced:
        return e2e
    names = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if (workload in x["workloads"] if "workloads" in x else x["moves"] in names)]


def program_config(config: dict):
    """The program's configuration for a configuration file: its preset with
    its ``set`` overrides, held to the ``resolved`` numbers in the file."""
    from object_detector_tpu_torch.core.config import get_config

    cfg = get_config(config["preset"]).override(config.get("set", {}))
    got = json.loads(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                 for k in config["resolved"]}))
    if got != config["resolved"]:
        raise ValueError(f"preset {config['preset']!r} no longer resolves to the configuration "
                         "file's numbers")
    return cfg


@dataclasses.dataclass
class Run:
    """What a driver gets, and what it leaves for the readers and the line."""
    workload: str
    seed: int
    seconds: float
    traced: bool
    variant: str
    t_start: float
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    cfg: Any = None
    device: Any = None
    trace: Any = None
    host: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def arch(self) -> dict:
        return self.config["resolved"]

    @property
    def trace_seconds(self) -> float:
        return min(TRACE_SECONDS, self.seconds / 2)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_per_layer(m: dict, r: Run) -> Dict[str, dict]:
    out = {}
    for metric in reported_metrics(m, r.workload, traced=True):
        value = load_module(BENCH / "metrics" / f"{metric['name']}.py").read(r)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def execute(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
            variant: str = "program", need_card: bool = True,
            device: Optional[str] = None, files: Optional[dict] = None) -> dict:
    """Runs the cell and returns the result line's object. ``need_card`` and
    ``device`` exist for the tests, which drive the rest of a run on the
    CPU; ``files`` stands in for the cell's files there."""
    import torch

    phases = {"imports": elapsed(t_start)}
    m = manifest() if files is None or "manifest" not in files else files["manifest"]
    f = files or cell_files(m, workload)
    r = Run(workload, seed, seconds, traced, variant, t_start, f["cell"], f["config"],
            f["traffic"], f["limits"])
    if need_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < r.cell["chips"]:
            raise NoCard(f"{workload} needs {r.cell['chips']} CUDA device(s); "
                         f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                         f"device_count() is {torch.cuda.device_count()}")
        r.device = torch.device("cuda", 0)
        torch.cuda.init()
        phases["cuda"] = elapsed(t_start)
    else:
        r.device = torch.device(device or "cpu")
    r.cfg = program_config(r.config)
    driver = importlib.import_module(f"port_bench.drivers.{r.traffic['mode']}")
    out = driver.run(r)
    print(json.dumps({"phases_s": {**phases, **out["phases"]}, "served": out["served"],
                      "gaps": out["spread"],
                      "trace_clock": ([r.trace.clock_ratio] + r.trace.clock_pieces
                                      if r.trace else None)}))
    numbers = out["numbers"]
    correct = check.verdict(numbers, r.limits["limits"]) and out["failed"] == 0
    if traced:
        metrics = read_per_layer(m, r)
    else:
        metrics = {x["name"]: {"value": out["e2e"][x["name"]], "unit": x["unit"]}
                   for x in reported_metrics(m, workload, traced=False)}
    dev = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
           "kind": torch.cuda.get_device_name(0) if r.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if traced and r.trace is not None:
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        result["breakdown"] = {"device_ops": r.trace.device_ops(),
                               "idle_gaps": r.trace.idle_gaps()}
    result["check"] = {k: {"value": numbers[k], "limit": v} for k, v in r.limits["limits"].items()}
    result["check"]["failed"] = {"value": out["failed"], "limit": 0}
    return result


def main(args, t_start: float) -> int:
    try:
        result = execute(args.workload, args.seed, float(args.seconds), bool(args.trace),
                         t_start, variant=args.variant)
    except NoCard as e:
        print(f"port_bench: {e}; no result without a card", file=sys.stderr)
        return EXIT_NO_CARD
    except UnknownCell as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return EXIT_BAD_CELL
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules loaded that a run may not load: {found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    print(f"card: {card_line()}")
    lines = [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in result["check"].items()]
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def elapsed(t_start: float) -> float:
    return time.perf_counter() - t_start
