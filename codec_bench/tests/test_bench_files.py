"""The harness finds every configuration, mix, driver, limit file and
metric reader by the names in BENCHMARK.json, and the file keeps to the
benchmark's contract."""

import json
import re

import pytest

from codec_bench import harness

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["codec_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    data = json.loads((harness.REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert cfg["file"] == f"codec_bench/configs/{cfg['name']}.json"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200 and cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = harness.read_json("traffic", cell["traffic"])
    assert hasattr(harness.driver(mix["driver"]), "drive")
    limits = harness.read_json("checks", cell["name"])
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    kinds = {m["name"] for m in harness.metrics_of(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert harness.metrics_of(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert callable(harness.reader(metric["name"]))
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
