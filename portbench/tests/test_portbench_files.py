"""The benchmark's files: ``BENCHMARK.json`` keeps to the contract's shape
and names, and every configuration, cell, entry, metric reader and kernel
file it names loads and names things that exist."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.lib.harness import ROOT, load_cell, metric_reader
from portbench.lib.trace import _resolve, kernel_spec

CHECKOUT = ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
KERNELS = sorted({n.split("_roofline")[0] for n in PER_LAYER
                  if "_roofline" in n})


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + PER_LAYER)
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"train_samples_per_s", "infer_samples_per_s",
                        "infer_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = CHECKOUT / config["file"]
    assert path.parts[len(CHECKOUT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert config["source"].startswith("https://")
    for key in config["reduced"]:
        assert key in data and key in data["reduced_from"], key
        assert not key.endswith(("_dim", "_rank", "_size", "_width")) or \
            key == "dataset_size"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    traffic, config, entry = load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert traffic["config"] == w["config"]
    assert entry.KIND in ("train", "infer")
    assert hasattr(entry, "Cell")
    assert traffic["limits"]
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    mine = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert mine
    for m in mine:
        assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader(name):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert set(m["workloads"]) <= set(CELLS)
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert callable(metric_reader(name))
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers and "\n" not in m["layer"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_file(kernel):
    spec = kernel_spec(kernel)
    owner, attr = _resolve(spec.ENTRY)
    assert callable(getattr(owner, attr))
    owner, attr = _resolve(spec.COUNTER)
    assert isinstance(getattr(owner, attr).launches, int)
    assert callable(spec.bound)


def test_files_are_named_from_names():
    for path in Path(ROOT).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
