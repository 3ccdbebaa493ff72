"""Whole runs with the chip's look skipped: the plain versions of the port
on the CPU at the smallest bucket (480x270) of a smaller terrain, against
the plain reference; a sound run is correct, and a run whose timed path is
broken underneath is not, once for each fault a cell can have.  And the
result line's shape from a stubbed run of main().

The faults (a one-chip cell has no exchange between chips to leave out):
  state_unchanged  each frame hands back the state it was given;
  half_rows        K2 traces the top half of the rows, and the bottom half
                   repeats them;
  image_altered    the u8 image altered where the frame produces it;
  history_never_valid  each frame's history handed on marked invalid, so
                   nothing accumulates: every one-step number reads 0,
                   only the chain from the start state sees it;
  stale_tables     (the rebuild-every-frame cell) the rebuild left out, so
                   the frame traces the rest pose's tables.
"""

import dataclasses
import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from fbench import harness, manifest

BENCH = manifest.load(manifest.HERE + "/..")
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name):
    cell = manifest.cell(BENCH, name)
    cfg = dict(cell.config, terrain=dict(cell.config["terrain"], chunks_x=2,
                                         chunks_z=2))
    traffic = dict(cell.traffic, width=480, height=270, warmup_frames=2,
                   trace_frames=2, gap_frames=1, cut_frames=1)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def cpu_run(name, tmp_path, fault=None):
    torch.manual_seed(0)
    return harness.run_cell(small_cell(name), 2 ** 32 + 5, 0.0, False,
                            str(tmp_path), time.perf_counter(),
                            device="cpu", fault=fault)


def state_unchanged(eng, drv):
    frame = eng.render_frame_device

    def stuck(dt=None):
        state = eng.state
        image = frame(dt)
        eng.state = state
        return image

    eng.render_frame_device = stuck


def half_rows(eng, drv, monkeypatch):
    from rtrt_tpu_torch.engine import frame as F
    trace = F.path_trace_mega

    def half(scene, rays, pixel_ids, *a, **k):
        h = pixel_ids.shape[0] // 2
        top = dataclasses.replace(rays, **{
            f.name: getattr(rays, f.name)[:h]
            for f in dataclasses.fields(rays)})
        if k.get("bn") is not None:
            k["bn"] = k["bn"][:h]
        g = trace(scene, top, pixel_ids[:h], *a, **k)
        return dataclasses.replace(g, **{
            f.name: torch.cat([getattr(g, f.name)] * 2)
            for f in dataclasses.fields(g)})

    monkeypatch.setattr(F, "path_trace_mega", half)


def image_altered(eng, drv):
    frame = eng.render_frame_device

    def altered(dt=None):
        image = frame(dt).clone()
        image[..., 0] ^= 16
        return image

    eng.render_frame_device = altered


def history_never_valid(eng, drv):
    frame = eng.render_frame_device

    def unaccumulated(dt=None):
        image = frame(dt)
        eng.state.history = eng.state.history._replace(valid=False)
        return image

    eng.render_frame_device = unaccumulated


def stale_tables(eng, drv, monkeypatch):
    from rtrt_tpu_torch.engine import frame as F
    monkeypatch.setattr(F, "rebuild_tables", lambda tables, mesh, t: None)


FAULTS = {"state_unchanged": state_unchanged, "half_rows": half_rows,
          "image_altered": image_altered,
          "history_never_valid": history_never_valid,
          "stale_tables": stale_tables}
# the number each fault moves past its limit
CAUGHT_BY = {"state_unchanged": "hist_p90", "half_rows": "gbuf_surface_share",
             "image_altered": "image_mean",
             "history_never_valid": "chain_count_share",
             "stale_tables": "tris_max"}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "stale_tables" or c.startswith("terrain_lbvh")]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    r = cpu_run(name, tmp_path)
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(r)[-1] == "check"
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in
                                 manifest.cell(BENCH, name).end_to_end}
    assert r["metrics"]["frame_ms"]["value"] > 0


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, tmp_path, monkeypatch):
    make = FAULTS[fault]
    if make in (half_rows, stale_tables):
        apply = lambda eng, drv: make(eng, drv, monkeypatch)
    else:
        apply = make
    r = cpu_run(name, tmp_path, fault=apply)
    assert not r["correct"], r["check"]
    assert r["failed"] == 1
    value, limit = r["check"][CAUGHT_BY[fault]]
    assert value > limit, r["check"]


def test_last_line_of_a_stubbed_run(monkeypatch, tmp_path):
    canned = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"frame_ms": {"value": 1.5, "unit": "ms"}},
              "device": {"platform": "gpu", "kind": "stub", "count": 1,
                         "memory_peak_bytes": 1},
              "check": {"image_mean": [0.001, 0.025]}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: canned)
    monkeypatch.chdir(manifest.HERE + "/..")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == list(canned)
    assert err.getvalue().strip().splitlines()[-1] == \
        "check image_mean 0.001 limit 0.025"


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(manifest.HERE + "/..")
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
