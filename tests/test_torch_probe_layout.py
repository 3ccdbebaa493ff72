"""K6's launch geometry and bound, the SASS counter of the probe tools, and
one JAX parity case of the plain K6 at a cluster-split row count, on the
CPU.

K6 (rtrt_tpu_torch/csrc/probe_step.cu) splits a (rows, 128) tile over a
thread-block cluster of c blocks, c the smallest of 1, 2, 4 with rows <=
16 c; `ubench_step.launch_geometry` computes c and the rows a block for
every row count the wrapper accepts, and `ubench_step.bound` scales the
card's rates by the c SMs the launch fills.  The kernels themselves run
only on the card (tests/test_torch_kernels_gpu.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rtrt_tpu_torch.tools import sass_loops, ubench_step
from rtrt_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = {8: (1, 8), 16: (1, 16), 24: (2, 12), 32: (2, 16), 40: (4, 10),
            48: (4, 12), 56: (4, 14), 64: (4, 16)}


@pytest.mark.parametrize("rows", sorted(GEOMETRY))
def test_launch_geometry(rows):
    c, block_rows = ubench_step.launch_geometry(rows)
    assert (c, block_rows) == GEOMETRY[rows]
    assert c * block_rows == rows and c in ubench_step.CLUSTERS
    # 32 threads a row, whole warps, at most 512 threads a block
    assert block_rows * 128 // 4 <= 512
    # the smallest cluster that holds the tile
    assert all(rows > ubench_step.MAX_BLOCK_ROWS * s
               for s in ubench_step.CLUSTERS if s < c)


@pytest.mark.parametrize("rows", [0, 4, 12, 72, -8])
def test_launch_geometry_refuses(rows):
    with pytest.raises(ValueError, match="rows"):
        ubench_step.launch_geometry(rows)


@pytest.mark.parametrize("mode", ["slab", "cond12"])
def test_bound_scales_with_the_cluster(mode):
    steps = 4000
    for rows, (c, _) in GEOMETRY.items():
        ms, by = ubench_step.bound(mode, rows, steps)
        ops = ubench_step.LANE_OPS[mode] * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
    # the same per-block work on 4 SMs takes the time of 16 rows on one
    assert ubench_step.bound(mode, 64, steps)[0] == pytest.approx(
        ubench_step.bound(mode, 16, steps)[0], rel=1e-12)


_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_111step_kernelILi4ELb1EEEvPKfS2_PfS3_i
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0020*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0030*/               @P1 BRA `(.L_x_0) ;
.L_x_1:
        /*0040*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0050*/                   FADD R5, R4, -R6 ;
        /*0060*/              @!P0 FMNMX R7, R5, R7, PT ;
        /*0070*/                   STL [R1], R7 ;
        /*0080*/                   SHFL.BFLY PT, R9, R7, 0x10, 0x1f ;
        /*0090*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x210], PT ;
        /*00a0*/               @P0 BRA `(.L_x_1) ;
        /*00b0*/                   EXIT ;
.L_x_2:
        /*00c0*/                   BRA `(.L_x_2);
"""


def test_sass_loops_counts_the_step_loop():
    (name, body), = sass_loops.functions(_SASS).items()
    assert "step_kernelILi4ELb1E" in name
    loop, loops = sass_loops.step_loop(body)
    assert [op.split(".")[0] for _, op, _ in loop] == [
        "LDG", "FADD", "FMNMX", "STL", "SHFL", "ISETP", "BRA"]
    assert len(loops) == 2  # the 2-instruction loop is not the step loop
    kinds = [sass_loops.kind(op) for _, op, _ in loop]
    assert kinds == ["load/store", "fp32 add/mul/fma", "fp32 cmp/min/max/sel",
                     "local (spill)", "shuffle/vote", "int cmp/sel", "control"]


def _jax_ubench():
    spec = importlib.util.spec_from_file_location(
        "_jax_tools_ubench_step_layout",
        os.path.join(REPO, "tools", "ubench_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_k6_matches_jax_at_a_split_tile():
    """24 rows (a cluster of 2 on the card), 3 steps, reduce4: the plain
    version that chip_smoke holds the cluster kernel to, against the JAX
    tool's kernel in Pallas interpret mode (tolerance as
    tests/test_torch_probes.py: rtol 2^-20, XLA's FMA in iy / iz)."""
    rows, steps = 24, 3
    tab, ox = ubench_step.tool_inputs(rows, "cpu")
    kern = _jax_ubench().make_kernel("reduce4", steps, rows)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    ref = np.asarray(pl.pallas_call(
        kern, in_specs=[vmem] * 2, out_specs=vmem,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        interpret=True)(tab.numpy(), ox.numpy()))
    got = ubench_step.step_probe("reduce4", tab, ox, steps).numpy()
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -20, atol=0)
