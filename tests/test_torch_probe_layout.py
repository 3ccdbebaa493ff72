"""K6's, K8's, K10's, K11's, K13's-K16's launch geometries and bounds,
the SASS counter of the probe tools, and one JAX parity case of the plain
K6 at a cluster-split row count, on the CPU.

K6 (rtrt_tpu_torch/csrc/probe_step.cu) splits a (rows, 128) tile over a
thread-block cluster of c blocks, c the smallest of 1, 2, 4 with rows <=
16 c; `ubench_step.launch_geometry` computes c and the rows a block for
every row count the wrapper accepts, and `ubench_step.bound` scales the
card's rates by the c SMs the launch fills.  K16
(rtrt_tpu_torch/csrc/probe_bf16.cu) splits its tile over a grid of c =
ceil(rows / 16) plain blocks of ceil(rows / c) rows (`probe_bf16.
launch_geometry`), and `probe_bf16.bound` takes c / 132 of the card.  K8 /
K9 (rtrt_tpu_torch/csrc/probe_cores.cu) run a tile on a cluster of 1 block
up to 16 rows and 2 beyond (`probe_cores.launch_geometry`), and
`probe_cores.bound` takes tiles x c / 132.  K13
(rtrt_tpu_torch/csrc/probe_consume.cu::pressure_kernel) splits its tile
over c = rows / 16 plain blocks (1 at 8 rows), each with its own shadow of
element (0, 0), and
K15 (csrc/probe_record.cu::xpose_kernel) over c = rows / 8 blocks of 8
rows; their bounds take c / 132.  K10 and K12
(csrc/probe_consume.cu::free_consume_kernel) split over c = ceil(rows /
16) plain blocks (`probe_cond.launch_geometry`), every thread stepping a
shadow of element (0, 0); their bounds take c / 132, and what the design
relies on is checked here: the shadow's premise (element (0, 0) alone
gives the tile's acc[0, 0]), the staged read's modulo that never wraps,
and the wrapper's refusal of a table that is not 16-byte aligned.  K14
(csrc/probe_record.cu::broadcast_kernel) runs on a thread-block cluster
by K6's rule (`probe_broadcast.launch_geometry`) and K11
(csrc/probe_consume.cu::alloc_kernel) on a grid of rows / 8 blocks
(`probe_smem.alloc_blocks`); their bounds take c / 132.  The kernels
themselves run only on the card (tests/test_torch_kernels_gpu.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rtrt_tpu_torch.tools import (probe_bf16, probe_broadcast, probe_cond,
                                  probe_cores, probe_pressure, probe_smem,
                                  probe_xpose, sass_loops, ubench_step)
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


K16_GEOMETRY = {8: (1, 8), 16: (1, 16), 24: (2, 12), 32: (2, 16),
                40: (3, 14), 48: (3, 16), 56: (4, 14), 64: (4, 16)}


@pytest.mark.parametrize("rows", sorted(K16_GEOMETRY))
def test_k16_launch_geometry(rows):
    c, block_rows = probe_bf16.launch_geometry(rows)
    assert (c, block_rows) == K16_GEOMETRY[rows]
    # the blocks cover the tile, the last one by less than a block
    assert (c - 1) * block_rows < rows <= c * block_rows
    assert block_rows <= probe_bf16.MAX_BLOCK_ROWS
    assert block_rows * 128 // 2 <= 1024  # 2 lanes a thread


@pytest.mark.parametrize("rows", [0, 4, 12, 72, -8])
def test_k16_launch_geometry_refuses(rows):
    with pytest.raises(ValueError, match="rows"):
        probe_bf16.launch_geometry(rows)


@pytest.mark.parametrize("dtype", list(probe_bf16.DTYPES))
def test_k16_bound_scales_with_its_sms(dtype):
    steps = 4000
    rate = timing.BF16_OPS if dtype == "bf16" else timing.F32_OPS
    for rows, (c, _) in K16_GEOMETRY.items():
        ms, by = probe_bf16.bound(dtype, rows, steps)
        ops = probe_bf16.LANE_OPS * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (rate * c / timing.SMS) * 1e3,
                                   rel=1e-12)
    # 64 rows on 4 SMs: the time of 16 rows on one
    assert probe_bf16.bound(dtype, 64, steps)[0] == pytest.approx(
        probe_bf16.bound(dtype, 16, steps)[0], rel=1e-12)


K8_GEOMETRY = {8: (1, 8), 16: (1, 16), 24: (2, 12), 32: (2, 16)}


@pytest.mark.parametrize("rows", sorted(K8_GEOMETRY))
def test_k8_launch_geometry(rows):
    c, block_rows = probe_cores.launch_geometry(rows)
    assert (c, block_rows) == K8_GEOMETRY[rows]
    assert c * block_rows == rows
    assert block_rows * 128 // 4 <= 512  # 4 lanes a thread


@pytest.mark.parametrize("rows", [0, 4, 12, 40, -8])
def test_k8_launch_geometry_refuses(rows):
    with pytest.raises(ValueError, match="rows"):
        probe_cores.launch_geometry(rows)


def test_k8_bound_scales_with_its_clusters():
    visits = torch.tensor([364, 36])
    for rows, (c, _) in K8_GEOMETRY.items():
        ntab, ttab, planes = probe_cores.tool_inputs(rows, device="cpu")
        ms, by = probe_cores.bound(ntab, ttab, planes[:, 0], visits)
        ops = (364 * probe_cores.LEAF_OPS + 36 * probe_cores.INT_OPS) \
            * rows * 128
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
        grid = probe_cores.bound(ntab, ttab, torch.cat([planes] * 8, 1),
                                 visits.repeat(8, 1))
        assert grid[0] == pytest.approx(ms, rel=1e-9)  # 8 tiles, 8 c SMs


K13_GEOMETRY = {64: (4, 16), 8: (1, 8)}


@pytest.mark.parametrize("rows", sorted(K13_GEOMETRY))
def test_k13_launch_geometry(rows):
    c, block_rows = probe_pressure.launch_geometry(rows)
    assert (c, block_rows) == K13_GEOMETRY[rows]
    assert c * block_rows == rows
    assert block_rows <= probe_pressure.MAX_BLOCK_ROWS
    # csrc's lanes a thread: whole warps, at most 1,024 threads a block
    n = sass_loops.lanes(REPO, "probe_consume.cu", "PRESSURE_L")
    assert block_rows * 128 % (32 * n) == 0
    assert block_rows * 128 // n <= 1024


@pytest.mark.parametrize("rows", [0, 4, 16, 24, 32, 72, -8])
def test_k13_launch_geometry_refuses(rows):
    """Only the JAX tool's tiles (64 and 8 rows)."""
    with pytest.raises(ValueError, match="rows"):
        probe_pressure.launch_geometry(rows)


@pytest.mark.parametrize("n_inv", probe_pressure.N_INV)
def test_k13_bound_scales_with_its_sms(n_inv):
    steps = 400
    for rows, (c, _) in K13_GEOMETRY.items():
        ms, by = probe_pressure.bound(rows, steps,
                                      probe_pressure.lane_ops(n_inv))
        ops = probe_pressure.lane_ops(n_inv) * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
    # 64 rows on 4 SMs: twice the time of 8 rows on one
    b = lambda rows: probe_pressure.bound(rows, steps,
                                          probe_pressure.lane_ops(n_inv))[0]
    assert b(64) == pytest.approx(2 * b(8), rel=1e-12)


K15_GEOMETRY = {8: (1, 8), 16: (2, 8), 24: (3, 8), 32: (4, 8)}


@pytest.mark.parametrize("rows", sorted(K15_GEOMETRY))
def test_k15_launch_geometry(rows):
    c, block_rows = probe_xpose.launch_geometry(rows)
    assert (c, block_rows) == K15_GEOMETRY[rows]
    assert c * block_rows == rows
    n = sass_loops.lanes(REPO, "probe_record.cu", "XPOSE_L")
    assert n in (1, 2, 4)
    assert block_rows * 128 % (32 * n) == 0


@pytest.mark.parametrize("rows", [0, 4, 12, 40, -8])
def test_k15_launch_geometry_refuses(rows):
    with pytest.raises(ValueError, match="rows"):
        probe_xpose.launch_geometry(rows)


def test_k15_bound_scales_with_its_sms():
    steps = 300
    for rows, (c, _) in K15_GEOMETRY.items():
        ms, by = probe_xpose.bound(rows, steps)
        ops = probe_xpose.LANE_OPS * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
    # the same 8 rows a block on every SM: one time at every row count
    assert probe_xpose.bound(32, steps)[0] == pytest.approx(
        probe_xpose.bound(8, steps)[0], rel=1e-12)


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


_SASS_BF16 = """
\t\tFunction : _ZN12_GLOBAL__N_111chains_bf16ILi8EEEvPKfPffii
.L_x_3:
        /*0000*/                   HMUL2.BF16_V2 R4, R2.H0_H0, R5 ;
        /*0010*/                   HFMA2.BF16_V2 R6, R4, 1, 1, R7 ;
        /*0020*/                   HADD2.BF16_V2 R6, R6, -R8 ;
        /*0030*/                   HMNMX2.BF16_V2 R6, R6, -3, -3, !PT ;
        /*0040*/                   HMNMX2.BF16_V2 R6, R6, 3, 3, PT ;
        /*0050*/                   FMNMX R9, R9, 3, PT ;
        /*0060*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x210], PT ;
        /*0070*/               @P0 BRA `(.L_x_3) ;
"""


def test_sass_loops_counts_half_precision():
    """HADD2, HMUL2, HFMA2 and HMNMX2 (bf16x2 here) are a kind of their
    own, and K16's loop is read by its min / max count: 2 a pair (f32: a
    lane) of each of the 8 chains a step."""
    (name, body), = sass_loops.functions(_SASS_BF16).items()
    loop, _ = sass_loops.step_loop(body)
    kinds = [sass_loops.kind(op) for _, op, _ in loop]
    assert kinds[:5] == ["fp16/bf16x2"] * 5
    assert kinds[5:] == ["fp32 cmp/min/max/sel", "int cmp/sel", "control"]
    assert sass_loops.steps_in_body("chains_bf16", 8, loop) == 2 / 64
    assert sass_loops.steps_in_body("chains_f32", 8, loop) == 1 / 128
    assert sass_loops.steps_in_body("cores_kernel", 4, loop) == 1
    # csrc/probe_bf16.cu's lanes a thread, and the 1024 threads (32 warps)
    # of its block at the CLI's 64 rows
    assert sass_loops.k16_lanes(REPO) == 2
    warps = sass_loops.default_warps()
    assert warps["chains_f32"] == warps["chains_bf16"] == 32


_SASS_K13 = """
\t\tFunction : _ZN12_GLOBAL__N_115pressure_kernelILi20EEEvPKfS2_S2_Pfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GT.U32.AND P1, PT, R0, 0x1f, PT ;
        /*0020*/               @P1 BRA `(.L_x_1) ;
.L_x_0:
        /*0030*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0040*/                   FMUL R5, R4, R6 ;
        /*0050*/                   FMUL R10, R4, R11 ;
        /*0060*/                   FMNMX R7, R5, R7, PT ;
        /*0070*/                   LDS R12, [R9] ;
        /*0080*/                   FMUL R13, R12, R4 ;
        /*0090*/                   FMNMX R14, R13, R14, PT ;
        /*00a0*/                   STS [R9], R7 ;
        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00c0*/                   ISETP.GE.AND P0, PT, R13, c[0x0][0x210], PT ;
        /*00d0*/              @!P0 BRA `(.L_x_0) ;
        /*00e0*/                   BRA `(.L_x_3) ;
.L_x_1:
        /*00f0*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0100*/                   FMUL R5, R4, R6 ;
        /*0110*/                   FMUL R10, R4, R11 ;
        /*0120*/                   FMNMX R7, R5, R7, PT ;
        /*0130*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0140*/                   LDS R8, [R9] ;
        /*0150*/                   ISETP.GE.AND P0, PT, R13, c[0x0][0x210], PT ;
        /*0160*/              @!P0 BRA `(.L_x_1) ;
.L_x_3:
        /*0170*/                   EXIT ;
.L_x_2:
        /*0180*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0190*/               @P1 BRA `(.L_x_2) ;
"""


def test_sass_loops_counts_k13_and_its_shadow():
    """Warp 0 runs its own copy of K13's step loop, which also steps the
    shadow of element (0, 0): the largest loop; the other warps' loop is
    the next that holds a barrier (the 2-instruction loop has none); each
    holds one step (one barrier)."""
    (name, body), = sass_loops.functions(_SASS_K13).items()
    n = sass_loops.lanes(REPO, "probe_consume.cu", "PRESSURE_L")
    assert sass_loops._mode(REPO, "pressure_kernel", name) == \
        (f"n_inv 20 lanes {n}", n)
    warp0, loops = sass_loops.step_loop(body)
    assert len(warp0) == 11 and len(loops) == 3
    tile = sass_loops.tile_loop(body)
    assert [op.split(".")[0] for _, op, _ in tile] == [
        "LDG", "FMUL", "FMUL", "FMNMX", "BAR", "LDS", "ISETP", "BRA"]
    assert sass_loops.steps_in_body("pressure_kernel", n, warp0) == 1
    assert sass_loops.steps_in_body("pressure_kernel", n, tile) == 1
    # an older tree's consume_kernel: its K10 / K12 instantiations (n_inv
    # -1) count as K10 or K12 by their source, its K13 ones (before K13's
    # own kernel) as K13, each with its lanes (K13: 1 at 8 rows, 8 at 64)
    sig = "EEEvPKfS2_S2_Pfiiii"
    k10 = "_ZN12_GLOBAL__N_114consume_kernelILi8ELi0ELi0ELin1" + sig
    assert sass_loops._mode(REPO, "consume_kernel", k10) == \
        ("flat (and K12 extract) one block", 8)
    assert sass_loops._kernel("consume_kernel", k10) == "K10"
    k13 = "_ZN12_GLOBAL__N_114consume_kernelILi8ELi0ELi0ELi20" + sig
    assert sass_loops._mode(REPO, "consume_kernel", k13) == \
        ("rows 64 n_inv 20 one block", 8)
    assert sass_loops._kernel("consume_kernel", k13) == "K13"


def test_sass_loops_counts_k15_by_its_reciprocals():
    """K15's steps in a loop body: its MUFU.RCP over 8 a lane, lanes the
    XPOSE_L of csrc/probe_record.cu; its mode from the template index."""
    loop = [(0, "MUFU.RCP", ""), (16, "FFMA", ""), (32, "MUFU.RCP", "")] * 8
    assert sass_loops.steps_in_body("xpose_kernel", 2, loop) == 1
    assert sass_loops.steps_in_body("xpose_kernel", 1, loop) == 2
    name = "_ZN12_GLOBAL__N_112xpose_kernelILi1EEEvPKfS2_Pfii"
    n = sass_loops.lanes(REPO, "probe_record.cu", "XPOSE_L")
    assert sass_loops._mode(REPO, "xpose_kernel", name) == \
        (f"xpose lanes {n}", n)
    # the warps an SM at the tools' default rows: 8 rows a block (K15) and
    # 16 (K13)
    warps = sass_loops.default_warps()
    assert warps["xpose_kernel"] == 8 * 128 // n // 32
    assert warps["pressure_kernel"] == 16 * 128 // sass_loops.lanes(
        REPO, "probe_consume.cu", "PRESSURE_L") // 32
    assert warps["consume_kernel"] == 32


K10_GEOMETRY = K16_GEOMETRY  # one launch_geometry serves both


@pytest.mark.parametrize("rows", sorted(K10_GEOMETRY))
def test_k10_launch_geometry(rows):
    """K10 and K12 over c = ceil(rows / 16) blocks of ceil(rows / c) rows:
    the blocks cover the tile, the last by less than a block, and a
    block's threads (csrc's lanes a thread, whole warps) stay within the
    kernel's launch bound."""
    c, block_rows = probe_cond.launch_geometry(rows)
    assert (c, block_rows) == K10_GEOMETRY[rows]
    assert (c - 1) * block_rows < rows <= c * block_rows
    assert block_rows <= probe_cond.MAX_BLOCK_ROWS
    n = sass_loops.lanes(REPO, "probe_consume.cu", "CONSUME_L")
    threads = -(-block_rows * 128 // (32 * n)) * 32
    assert threads * n >= block_rows * 128
    assert threads <= probe_cond.MAX_BLOCK_ROWS * 128 // n


@pytest.mark.parametrize("rows", [0, 4, 12, 72, -8])
def test_k10_launch_geometry_refuses(rows):
    assert probe_bf16.launch_geometry is probe_cond.launch_geometry
    with pytest.raises(ValueError, match="rows"):
        probe_cond.launch_geometry(rows)


@pytest.mark.parametrize("tool", [probe_cond, probe_smem])
def test_k10_k12_bound_scales_with_its_sms(tool):
    """K10's and K12's bound (probe_smem's is probe_cond's): the function's
    operations at the float32 rate on c of the 132 SMs."""
    steps = 400
    for rows, (c, _) in K10_GEOMETRY.items():
        ms, by = tool.bound(rows, steps)
        ops = probe_cond.LANE_OPS * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
    # 64 rows on 4 SMs: the time of 16 rows on one
    assert tool.bound(64, steps)[0] == pytest.approx(
        tool.bound(16, steps)[0], rel=1e-12)


def _flat_values(tab):
    return lambda base: tab.reshape(-1)[
        (base + torch.tensor(probe_cond.OFFSETS)) % 8000]


@pytest.mark.parametrize("source", ["row", "staged"])
@pytest.mark.parametrize("recipe", list(probe_cond.RECIPES))
def test_consume_shadow_premise(recipe, source):
    """The shadow's premise: the consume loop on element (0, 0) alone gives
    the whole tile's acc[0, 0] bit for bit, with both sources of values
    (K10's row, K12's staged table), on every recipe at 40 steps."""
    tab, x = probe_cond.RECIPES[recipe](64, "cpu")
    values = (lambda b: probe_cond.row_values(tab, b)) if source == "row" \
        else _flat_values(tab)
    whole = probe_cond.consume_loop(x, 40, values)
    alone = probe_cond.consume_loop(x[:1, :1], 40, values)
    assert torch.equal(alone[0, 0], whole[0, 0])


def test_staged_read_never_wraps():
    """max((7 k) % 997) + max(OFFSETS) < 8000: K12's staged read drops the
    function's % 8000, which never changes an index."""
    bases = [(7 * k) % 997 for k in range(997)]
    assert max(bases) == 996 and max(probe_cond.OFFSETS) == 120
    assert max(bases) + max(probe_cond.OFFSETS) < 8000
    tab, _ = probe_cond.tool_inputs(8, "cpu")
    flat = tab.reshape(-1)
    offs = torch.tensor(probe_cond.OFFSETS)
    for b in bases:
        assert torch.equal(flat[(b + offs) % 8000], flat[b + offs])


def test_consume_inputs_refuse_unaligned_tab():
    """K10 / K12 read tab by float4 and stage it by bulk copies: a table
    one float off a 16-byte boundary is refused with a ValueError before
    any launch (checked on the CPU), an aligned one taken."""
    _, x = probe_cond.tool_inputs(8, "cpu")
    base = torch.zeros(128 * 128 + 4)
    assert base.data_ptr() % 16 == 0
    good = base[4:].view(128, 128)
    probe_cond.check_consume_inputs("cpu", good, x)
    bad = base[1:128 * 128 + 1].view(128, 128)
    assert bad.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_cond.check_consume_inputs("cpu", bad, x)


_SASS_K10 = """
\t\tFunction : _ZN12_GLOBAL__N_119free_consume_kernelILi1ELi0EEEvPKfS2_Pfiiiii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_0:
        /*0020*/                   FMUL R5, R4, R6 ;
        /*0030*/                   FADD R5, R5, R7 ;
        /*0040*/                   FADD R8, R9, R4 ;
        /*0050*/                   FMNMX R4, R5, R8, PT ;
        /*0060*/                   LDS R9, [R2+0x40] ;
        /*0070*/                   FSETP.GT.AND P0, PT, R10, 1e+30, PT ;
        /*0080*/               @!P0 BRA `(.L_x_1) ;
        /*0090*/                   IMAD.HI R11, R12, 0x41bd, RZ ;
        /*00a0*/                   LDS R9, [R11] ;
.L_x_1:
        /*00b0*/                   ISETP.GE.AND P1, PT, R12, c[0x0][0x214], PT ;
        /*00c0*/              @!P1 BRA `(.L_x_0) ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   YIELD ;
        /*00f0*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0+URZ], RZ ;
        /*0100*/              @!P0 BRA 0xe0 ;
        /*0110*/                   BRA 0x10 ;
"""


def test_sass_loops_counts_k10_k12_free_kernel():
    """free_consume_kernel's instantiations count as K10 (kSrc 0, a mode by
    kCond) or K12 smem (kSrc 1); the step loop holds one step, the
    flagged reload inside it, and no barrier (the staging's barrier sits
    before the loop); the staging's mbarrier wait retries out of line and
    jumps back to the kernel's start, a longer backward branch that holds
    the EXIT and is no step loop.  K10 / K12's warps an SM: 16 rows a
    block at csrc's lanes a thread."""
    (name, body), = sass_loops.functions(_SASS_K10).items()
    n = sass_loops.lanes(REPO, "probe_consume.cu", "CONSUME_L")
    kern = max((k for k in sass_loops.KERNELS if k in name), key=len)
    assert kern == "free_consume_kernel"
    assert sass_loops._kernel(kern, name) == "K12"
    assert sass_loops._mode(REPO, kern, name) == (f"smem lanes {n}", n)
    cond2 = name.replace("ILi1ELi0E", "ILi0ELi2E")
    assert sass_loops._kernel(kern, cond2) == "K10"
    assert sass_loops._mode(REPO, kern, cond2) == (f"cond2 lanes {n}", n)
    loop, loops = sass_loops.step_loop(body)
    assert [n for _, _, n in loops] == [11, 3]
    kinds = [sass_loops.kind(op) for _, op, _ in loop]
    assert len(loop) == 11 and "barrier/sync" not in kinds
    assert kinds.count("int add/mul/shift/logic") == 1
    assert sass_loops.steps_in_body(kern, n, loop) == 1
    assert sass_loops.default_warps()[kern] == 16 * 128 // n // 32
    # an older tree's one-block K12 smem
    old = ("_ZN12_GLOBAL__N_114consume_kernelILi8ELi1ELi0ELin1"
           "EEEvPKfS2_S2_Pfiiii")
    assert sass_loops._kernel("consume_kernel", old) == "K12"
    assert sass_loops._mode(REPO, "consume_kernel", old) == \
        ("smem one block", 8)


@pytest.mark.parametrize("rows", sorted(GEOMETRY))
def test_k14_launch_geometry(rows):
    """K14 on a cluster of c blocks by K6's rule (c = 1, 2, 4 for rows up
    to 16, 32, 64: K6's own launch_geometry, whose block rows csrc's K14
    takes), its block's threads at csrc's lanes a thread whole warps
    within the kernel's launch bound."""
    assert probe_broadcast.launch_geometry is ubench_step.launch_geometry
    c, block_rows = probe_broadcast.launch_geometry(rows)
    assert (c, block_rows) == GEOMETRY[rows]
    n = sass_loops.lanes(REPO, "probe_record.cu", "BCAST_L")
    top = sass_loops.lanes(REPO, "probe_record.cu", "BCAST_MAX_BLOCK_ROWS")
    assert top == ubench_step.MAX_BLOCK_ROWS and block_rows <= top
    assert block_rows * 128 % (32 * n) == 0
    assert block_rows * 128 // n <= top * 128 // n <= 1024


@pytest.mark.parametrize("rows", [0, 4, 12, 72, -8])
def test_k14_launch_geometry_refuses(rows):
    """A tile K14 cannot launch has no bound either."""
    with pytest.raises(ValueError, match="rows"):
        probe_broadcast.launch_geometry(rows)
    with pytest.raises(ValueError, match="rows"):
        probe_broadcast.bound(rows, 400)


def test_k14_bound_scales_with_its_sms():
    steps = 400
    for rows, (c, _) in GEOMETRY.items():
        ms, by = probe_broadcast.bound(rows, steps)
        ops = probe_broadcast.LANE_OPS * rows * 128 * steps
        assert by == "operations"
        assert ms == pytest.approx(ops / (timing.F32_OPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
    # 64 rows on 4 SMs: the time of 16 rows on one
    assert probe_broadcast.bound(64, steps)[0] == pytest.approx(
        probe_broadcast.bound(16, steps)[0], rel=1e-12)


def test_k11_bound_scales_with_its_sms():
    """K11 over rows / 8 blocks: its bytes at the memory rate on that
    share of the card, the same time at every row count; other rows are
    refused."""
    for rows in range(8, 65, 8):
        c = probe_smem.alloc_blocks(rows)
        assert c == rows // 8
        ms, by = probe_smem.alloc_bound(rows)
        assert by == "bytes"
        assert ms == pytest.approx(2 * rows * 128 * 4
                                   / (timing.HBM_BPS * c / timing.SMS)
                                   * 1e3, rel=1e-12)
        assert ms == pytest.approx(probe_smem.alloc_bound(8)[0], rel=1e-12)
    for rows in (0, 4, 12, 72):
        with pytest.raises(ValueError, match="rows"):
            probe_smem.alloc_blocks(rows)


_SASS_K14 = """
\t\tFunction : _ZN12_GLOBAL__N_116broadcast_kernelILi1ELb1EEEvPKfS2_PKiPfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   REDUX.MIN.S32 UR4, R3 ;
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0+URZ], RZ ;
.L_x_0:
        /*0030*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0040*/                   ISETP.NE.AND P1, PT, R5, R6, PT ;
        /*0050*/                   SEL R5, R5, 0x40000000, P1 ;
        /*0060*/                   IMNMX R7, R5, 0x40000000, PT ;
        /*0070*/                   REDUX.MIN.S32 UR5, R7 ;
        /*0080*/                   ST.E.STRONG.GPU [R8], R7 ;
        /*0090*/                   FADD R9, R9, R4 ;
        /*00a0*/                   FSEL R9, R9, R10, !P1 ;
        /*00b0*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0+URZ], RZ ;
        /*00c0*/                   LDS R11, [R12] ;
        /*00d0*/                   IMNMX R11, R11, R13, PT ;
        /*00e0*/                   REDUX.MIN.S32 UR6, R11 ;
        /*00f0*/                   ISETP.GE.AND P2, PT, R14, c[0x0][0x220], PT ;
        /*0100*/              @!P2 BRA `(.L_x_0) ;
        /*0110*/                   EXIT ;
"""


def test_sass_loops_counts_k14_step_loop(tmp_path):
    """broadcast_kernel's instantiations count as K14, a mode each (the
    cluster one marked), with csrc's lanes a thread; its step loop is
    read by its REDUX, 2 a step (the min posted and taken), in this tree
    and in a tree from before the split (two in the one block's
    reduction); K14's warps an SM at 64 rows: 16-row blocks at csrc's
    lanes a thread (a tree without BCAST_L: 32, its one 1,024-thread
    block)."""
    (name, body), = sass_loops.functions(_SASS_K14).items()
    kern = max((k for k in sass_loops.KERNELS if k in name), key=len)
    assert kern == "broadcast_kernel"
    assert sass_loops._kernel(kern, name) == "K14"
    n = sass_loops.lanes(REPO, "probe_record.cu", "BCAST_L")
    assert sass_loops._mode(REPO, kern, name) == \
        (f"bcast16 cluster lanes {n}", n)
    lone = name.replace("ILi1ELb1EE", "ILi0ELb0EE")
    assert sass_loops._mode(REPO, kern, lone) == (f"extract lanes {n}", n)
    loop, loops = sass_loops.step_loop(body)
    assert [k for _, _, k in loops] == [14]
    kinds = [sass_loops.kind(op) for _, op, _ in loop]
    assert kinds.count("shuffle/vote") == 2
    assert "local (spill)" not in kinds and "barrier/sync" not in kinds
    assert sass_loops.steps_in_body(kern, n, loop) == 1
    assert sass_loops.steps_in_body(kern, 8, loop * 2) == 2
    warps = sass_loops.default_warps()
    assert warps[kern] == ubench_step.MAX_BLOCK_ROWS * 128 // n // 32
    # a tree whose csrc/probe_record.cu has neither constant
    csrc = tmp_path / "rtrt_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for src in ("probe_consume.cu", "probe_bf16.cu"):
        (csrc / src).write_text(open(os.path.join(
            REPO, "rtrt_tpu_torch", "csrc", src)).read())
    (csrc / "probe_record.cu").write_text("constexpr int XPOSE_L = 1;\n")
    assert sass_loops.default_warps(str(tmp_path))[kern] == 32
    assert sass_loops._mode(str(tmp_path), kern, lone) == ("extract lanes 8",
                                                           8)


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
