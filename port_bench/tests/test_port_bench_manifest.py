"""BENCHMARK.json against the contract's form, and every file it names
found by name."""

import dataclasses
import json
import re

import pytest
import torch

from port_bench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(M) == KEYS["top"]
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind, entries in (("config", M["configs"]), ("workload", M["workloads"]),
                          ("end_to_end", M["end_to_end"]), ("per_layer", M["per_layer"])):
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), kind
        for e in entries:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= M["run_seconds"] <= 51 and all(_line(word) for word in M["command"])


def test_metrics_follow_the_contract():
    e2e = {x["name"]: x for x in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for x in e2e.values():
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in M["workloads"]}
    for x in M["per_layer"]:
        assert x["moves"] in e2e
        for cell in x["workloads"]:
            assert cell in cells
            assert cell in e2e[x["moves"]].get("workloads", [cell])
        if "roofline" in x["name"] or "mfu" in x["name"] or x["name"].startswith("idle_pct"):
            assert x["unit"] == "%"
    for cell in cells:
        reported = harness.reported_metrics(M, cell, traced=False)
        assert "setup_s" in {x["name"] for x in reported} and len(reported) >= 2
        assert harness.reported_metrics(M, cell, traced=True)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files(cell):
    f = harness.cell_files(M, cell)
    assert (harness.BENCH / "drivers" / f"{f['traffic']['mode']}.py").is_file()
    assert f["limits"]["limits"]
    for metric in harness.reported_metrics(M, cell, traced=True):
        assert callable(harness.load_module(
            harness.BENCH / "metrics" / f"{metric['name']}.py").read)
    harness.program_config(f["config"])  # the preset still resolves to the file's numbers


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_reference_layout_is_the_programs(config):
    from object_detector_tpu_torch.models.retinanet import build_model
    from port_bench.reference import detector

    entry = {c["name"]: c for c in M["configs"]}[config]
    assert entry["file"].startswith("port_bench/")
    spec = harness.load_json(harness.ROOT / entry["file"])
    cfg = harness.program_config(spec)
    with torch.device("meta"):
        model = build_model(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in detector.param_spec(spec["resolved"])} == want
    assert json.loads(json.dumps(dataclasses.asdict(cfg.model))) == spec["resolved"]["model"]
