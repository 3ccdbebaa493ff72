"""BENCHMARK.json against the contract framebench is built to: its keys,
names and units, every cell's files found by name, every per-layer metric's
reader and the end-to-end metric it moves."""

import json
import os
import re

import pytest

from fbench import manifest

ROOT = os.path.dirname(manifest.HERE)
BENCH = manifest.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "framebench/run.py"]
    assert BENCH["paths"] == ["framebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_no_problems():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entry_keys_and_text(group):
    for x in BENCH[group]:
        keys = set(x) - {"workloads"}
        assert keys == ENTRY_KEYS[group], x["name"]
        for k in ("why", "layer", "source"):
            if k in x:
                assert LINE.match(x[k]), (x["name"], k)
        if "unit" in x:
            assert len(x["unit"]) <= 16 and manifest.UNIT.match(x["unit"])
        if "better" in x:
            assert x["better"] in ("lower", "higher")


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = manifest.cell(BENCH, name)
    assert cell.chips in (1, 4)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits, "a cell compares at least one number"
    for key in ("width", "height", "frames_in_flight", "dt", "pan"):
        assert key in cell.traffic
    cfg = next(c for c in BENCH["configs"]
               if c["name"] == name.split(".")[0])
    assert cfg["file"] == f"framebench/configs/{cfg['name']}.json"
    assert cell.config["reduced"] == cfg["reduced"]


def test_metric_readers_load():
    for m in BENCH["per_layer"]:
        mod = manifest.reader(m["name"])
        assert set(mod.NEEDS) <= {"trace", "cut"}
        assert callable(mod.read)


def test_layers_spelt_alike():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


def test_problems_catch_a_bad_entry():
    bad = json.loads(json.dumps(BENCH))
    bad["per_layer"][0]["moves"] = "no_such_metric"
    bad["workloads"][0]["traffic"] = "no_such_traffic"
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["end_to_end"][1]["name"] = "frames_per_s.device_paced"
    found = manifest.problems(bad)
    assert any("no quantity 'frames_per_s'" in p for p in found)
    assert any("no_such_metric" in p for p in found)
    assert any("no_such_traffic" in p or "not <config>" in p for p in found)
    assert any("bad unit" in p for p in found)
