"""Every cell, configuration, traffic kind and per-layer metric is found by
name, and a new cell and metric are found once their files and entries are
added, with no file that is there edited."""

import json
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

BENCH = harness.BENCH
SPEC = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c["name"] == cell and c["config"]["name"] == entry["config"] and c["chips"] == entry["chips"]
    assert c["why"] == entry["why"]
    traffic = harness.traffic_class(c["kind"])
    assert traffic.role in ("train", "infer")
    spec = harness.reference_module(c["config"]).parameter_spec(c["config"])
    assert sum(__import__("math").prod(s) for _, s, _ in spec) == c["config"]["parameters"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    read = harness.reader(metric)
    assert callable(read)


def test_configs_files_and_names():
    for cfg in SPEC["configs"]:
        data = json.loads((harness.ROOT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]


def test_a_new_cell_and_metric_are_found_from_files_alone(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cell = json.loads((bench / "workloads" / "minkunet34.train.scan5cm.json").read_text())
    cell["name"] = "minkunet34.train.scan10cm"
    cell["traffic"]["voxel_size"] = 0.1
    (bench / "workloads" / "minkunet34.train.scan10cm.json").write_text(json.dumps(cell))
    (bench / "metrics" / "steps_profiled.train.py").write_text(
        "def read(s):\n    return s['profiled_steps'] or None\n")
    assert all(p.read_bytes() == b for p, b in before.items())
    found = harness.load_cell("minkunet34.train.scan10cm", bench=bench)
    assert found["traffic"]["voxel_size"] == 0.1 and found["config"]["name"] == "minkunet34"
    assert harness.reader("steps_profiled.train", bench=bench)({"profiled_steps": 3}) == 3
    entry = {"name": "steps_profiled.train", "workloads": ["minkunet34.train.scan10cm"]}
    assert harness.applies(entry, "minkunet34.train.scan10cm")
    assert not harness.applies(entry, "minkunet34.train.scan5cm")


def test_benchmark_json_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"step", "coordinate phase", "layers and dispatch", "sparse conv", "device"}
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
