"""Each configuration's `k2_counts` against the mesh that framebench makes
for it: tools/k2_counts.py recomputed on the CPU at a coarse pixel
subsample (every STRIDE-th pixel of every STRIDE-th row, the file's views),
each visit and hit count within REL of the file's (measured on the card at
stride 4), the tables' bytes exactly.  A change to the mesh, its triangle
order or the tree moves the counts by more: the LBVH over the terrain in
its generator's case-by-case order took 6x the node visits."""

import json
import os

import pytest

from fbench import manifest

import k2_counts

BENCH = manifest.load(os.path.dirname(manifest.HERE))
PAIRS = sorted({(w["config"], w["traffic"]) for w in BENCH["workloads"]})
STRIDE = 32
# the subsample's own spread against stride 4 (PERF.md §4), with room
REL = 0.10
COUNTS = ("node_visits", "leaf_visits", "shaded_hits", "textured_hits",
          "sampled_hits")


@pytest.mark.parametrize("config,traffic", PAIRS)
def test_k2_counts_match_the_mesh(config, traffic):
    with open(os.path.join(manifest.HERE, "configs", config + ".json")) as f:
        kept = json.load(f)["k2_counts"]
    views = int(kept["source"].split("--views ")[1].split()[0])
    got = k2_counts.main([config, traffic, "--stride", str(STRIDE),
                          "--views", str(views), "--device", "cpu"])
    assert got["tree"] == kept["tree"]
    assert got["table_bytes"] == kept["table_bytes"]
    for k in COUNTS:
        assert got[k] == pytest.approx(kept[k], rel=REL), k
