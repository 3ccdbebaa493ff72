"""BENCHMARK.json and the files it names: a cell `<config>.<traffic>` resolves
by name to framebench/configs/<config>.json, framebench/traffic/
<traffic>.json and framebench/limits/<cell>.json, and a per-layer metric to
framebench/metrics/<metric>.py.  Nothing here needs an edit when a later
change adds a cell, a configuration, a traffic mix or a metric: it adds
the files and the entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the end-to-end quantities a run measures (fbench/harness.py); a metric
# named "<quantity>.<qualifier>" reports the quantity under its own bound
QUANTITIES = ("frame_ms", "frame_ms_p95", "setup_s")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list   # the manifest's entries this cell reports
    per_layer: list


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: every cell, or those its
    `workloads` list names."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    """The workload `name` with its configuration, traffic, limits and
    metrics.  Raises KeyError for a name the manifest does not hold."""
    w = {x["name"]: x for x in bench["workloads"]}[name]
    return Cell(name=name, config=_json("configs", w["config"] + ".json"),
                traffic=_json("traffic", w["traffic"] + ".json"),
                limits=_json("limits", name + ".json"), chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name)])


def reader(metric: str):
    """The reader module of a per-layer metric: framebench/metrics/
    <metric>.py, with NEEDS (the traced parts it reads: "trace", "cut")
    and read(ctx) -> float or None."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "fbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(bench: dict) -> list:
    """What in the manifest breaks the names, units and references that
    framebench relies on (an empty list when nothing does)."""
    out = []
    e2e = {m["name"] for m in bench["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in bench[group]:
            if not NAME.match(x["name"]):
                out.append(f"{group}: bad name {x['name']!r}")
            if "unit" in x and not UNIT.match(x["unit"]):
                out.append(f"{x['name']}: bad unit {x['unit']!r}")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        out += [f"{group}: {n!r} twice" for n in set(names)
                if names.count(n) > 1]
    metrics = [m["name"] for g in ("end_to_end", "per_layer")
               for m in bench[g]]
    out += [f"metric {n!r} twice" for n in set(metrics)
            if metrics.count(n) > 1]
    out += [f"{m['name']}: no quantity {m['name'].split('.')[0]!r}"
            for m in bench["end_to_end"]
            if m["name"].split(".")[0] not in QUANTITIES]
    for w in bench["workloads"]:
        if w["name"] != f"{w['config']}.{w['traffic']}":
            out.append(f"{w['name']}: not <config>.<traffic>")
        for d, f in (("configs", w["config"]), ("traffic", w["traffic"])):
            if not os.path.exists(os.path.join(HERE, d, f + ".json")):
                out.append(f"{w['name']}: no {d}/{f}.json")
        if not os.path.exists(os.path.join(HERE, "limits",
                                           w["name"] + ".json")):
            out.append(f"{w['name']}: no limits/{w['name']}.json")
    for m in bench["per_layer"]:
        if not os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")):
            out.append(f"{m['name']}: no metrics/{m['name']}.py")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}, no end-to-end "
                       "metric")
        for w in bench["workloads"]:
            if reports(m, w["name"]) and not any(
                    x["name"] == m["moves"] and reports(x, w["name"])
                    for x in bench["end_to_end"]):
                out.append(f"{m['name']}: {w['name']} does not report "
                           f"{m['moves']}")
    return out
