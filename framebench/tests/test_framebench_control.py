"""The control on the card: the reference with bfloat16 planes put in the
program's place is not correct under each cell's limits, where the
program's own frame is; at the smallest bucket (480x270) of a smaller
terrain, so that a test run holds it.  Run on the card with

    python -m pytest framebench/tests -m gpu

(tools/readings.py reads the same at each cell's own size)."""

import time

import pytest
import torch

from fbench import compare, harness, manifest

from test_framebench_run import CELLS, small_cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "precision on the card")
    cell = small_cell(name)
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.5, False, str(tmp_path),
                         time.perf_counter(), control_run=True)
    assert r["correct"], r["check"]
    ok, check = compare.judge(r["control"], cell.limits)
    assert not ok, check
