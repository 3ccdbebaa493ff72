"""The SASS of the probe kernels' step loops, counted by kind, and the
issue-slot floor of a step.

    python -m rtrt_tpu_torch.tools.sass_loops [--tree DIR]
        [--warps step_kernel=16] [--warps leaf_kernel=32] ...

Builds (or finds) the kernel library of the package in DIR (this checkout
by default; another revision unpacked beside it works the same way: its
own utils/cuda.py builds it into DIR/build/), disassembles it with
`cuobjdump -sass` and, for every instantiation of K6 (`step_kernel`,
csrc/probe_step.cu; reduce2 and reduce4 have a lone-block and a cluster
instantiation), K7 (`leaf_kernel`, csrc/probe_leaf.cu), K8 / K9
(`cores_kernel`, csrc/probe_cores.cu; a lone-block and a cluster
instantiation a mode), K13 (`pressure_kernel`, csrc/probe_consume.cu, one
instantiation an n_inv; in a tree from before it had its own kernel, the
n_inv >= 0 instantiations of `consume_kernel`), K10 / K12
(`free_consume_kernel`, csrc/probe_consume.cu: K10's flat, cond and
cond2 and K12's smem, K12's extract being K10's flat; in a tree from
before it, the n_inv = -1 instantiations of `consume_kernel`), K14
(`broadcast_kernel`, csrc/probe_record.cu, a mode each, and a lone-block
and a cluster instantiation a mode where it runs on a cluster), K15
(`xpose_kernel`, csrc/probe_record.cu, a mode each) and K16
(`chains_f32`, `chains_bf16`, csrc/probe_bf16.cu), finds the step loop
(the backward branch that spans the most instructions: the other loops
of these kernels are a few instructions long) and counts its warp
instructions by kind.  ptxas' registers and spill stores of the same
instantiation come from the build log.  A K6-K8 step loop is not unrolled in this checkout,
so a loop body is one step; where the loop holds a branch that a run
never takes (K7's fat and carry4: the internal visit) or one of two
branches a step takes (K8's both and depcond: a leaf or an internal
visit), the count holds it too (K8's leafonly and intonly loops hold one
visit each).  K16's body may hold several steps (nvcc unrolls its bf16
loop by 4): `steps_in_body` is its min / max instructions over the 2 x 8
chains x lanes (f32) or pairs (bf16) of one step, the lanes a thread
being the `constexpr int L` of DIR's csrc/probe_bf16.cu.  K13's and an
older tree's `consume_kernel`'s steps in a body are their step barriers
(BAR: one a step); `free_consume_kernel`'s body is one step (no
barrier; K10's holds the never-taken reload of a flagged step and, in
the cond modes, the never-taken branch that skips the terms); K15's its
reciprocals (MUFU.RCP: 8 a lane a step, XPOSE_L lanes a thread, 4 where DIR's
csrc/probe_record.cu has no XPOSE_L), which stay in the loop body where
a warp skips them; K14's its REDUX over 2 (one warp step of the
tile-wide min where the tile's min goes out and one where it is taken,
in the cluster design; the warp's and warp 0's reductions in the
one-block design of a tree from before it).  K13's warp 0 runs its own
copy of the step loop, which also steps the shadow of element (0, 0): the largest loop; the
other warps' loop is the next that holds a barrier.  `instructions_per_
step` and `by_kind` are the other warps', `warp0_instructions_per_step`
warp 0's, which counts once, for one warp, in the issue floor.  Every
warp of `free_consume_kernel` steps the shadow in its one loop.

The issue-slot floor of a step: each SM issues at most 4 warp
instructions a clock (one a sub-partition, 128 threads), so a step costs
at least instructions a step x warps an SM / 4 clocks, at the card's
highest SM clock (`nvidia-smi --query-gpu=clocks.max.sm`).  `--warps
NAME=N`: the warps a launch puts on each SM (defaults: this checkout's
geometry at each CLI's default rows: K6 16 at 64 rows on 4 SMs, K7 32
at 32 rows, K8 16 at 32 rows on 2 SMs, K13 16 (16 rows a block at
DIR's PRESSURE_L of 4), K10 / K12 16 rows a block at DIR's CONSUME_L
(4 warps at 16 lanes), K15 32 (8 rows a block at DIR's XPOSE_L of 1),
K16 32: 16 rows a block at 2 lanes a thread, as the one-block K16 of 64
rows at 8 had; K14 at 64 rows DIR's BCAST_MAX_BLOCK_ROWS rows a block at
its BCAST_L lanes a thread (16 warps at 16 and 4), 32 where DIR's
csrc/probe_record.cu has neither (one 1,024-thread block); a tree from
before the splits ran one 1,024-thread block:
`consume_kernel` 32 (K10 / K12, and K13 before its split), and give
`--warps xpose_kernel=32`).  Prints one line ``SASS {json}`` per
instantiation.
Needs the CUDA toolkit (nvcc, cuobjdump) and a card for the clock.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

KERNELS = {"step_kernel": "K6", "leaf_kernel": "K7", "cores_kernel": "K8",
           "consume_kernel": "K13", "pressure_kernel": "K13",
           "free_consume_kernel": "K10", "broadcast_kernel": "K14",
           "xpose_kernel": "K15",
           "chains_f32": "K16", "chains_bf16": "K16"}
K16_CHAINS = 8
K15_RECORDS = 8  # reciprocals a lane a step
# consume_kernel<L, kSrc, kCond, n_inv> of an older tree: K13 (n_inv >= 0,
# before pressure_kernel) and K10 / K12 (n_inv = -1: "Lin1E"; kSrc 0 the
# global row, 1 the staged table), before free_consume_kernel
_CONSUME_K13 = re.compile(r"consume_kernelILi(\d+)ELi0ELi0ELi(\d+)E")
_CONSUME_K10 = re.compile(r"consume_kernelILi(\d+)ELi([01])ELi(\d)ELin1E")
# free_consume_kernel<kSrc, kCond>
_FREE_CONSUME = re.compile(r"free_consume_kernelILi([01])ELi(\d)E")
# SASS opcodes (the part before the first '.') by kind; anything else is
# "other" (moves, conversions, special registers, uniform ops).  Integer
# arithmetic counts as "int add/mul/shift/logic" (IMAD.MOV, a move, too)
KINDS = {
    "fp32 add/mul/fma": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I",
                         "FFMA32I"),
    "fp32 cmp/min/max/sel": ("FSETP", "FSET", "FMNMX", "FSEL", "FCHK"),
    "fp16/bf16x2": ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "HSETP2", "HSET2"),
    "int cmp/sel": ("ISETP", "SEL", "IMNMX", "PLOP3"),
    "int add/mul/shift/logic": ("IADD3", "IADD", "IMAD", "IMUL", "IABS",
                                "LEA", "SHF", "SHL", "SHR", "LOP3", "LOP",
                                "POPC", "FLO", "BREV", "PRMT", "BMSK"),
    "mufu": ("MUFU",),
    "load/store": ("LDG", "LDS", "LD", "STG", "STS", "ST", "LDGSTS",
                   "LDSM", "ATOMS", "ATOMG", "ATOM", "RED", "REDG"),
    "local (spill)": ("LDL", "STL"),
    "shuffle/vote": ("SHFL", "VOTE", "VOTEU", "REDUX", "MATCH"),
    "barrier/sync": ("BAR", "WARPSYNC", "UCGABAR_ARV", "UCGABAR_WAIT",
                     "CCTL", "MEMBAR", "DEPBAR", "LDGDEPBAR", "ERRBAR",
                     "FENCE"),
    "control": ("BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET", "EXIT",
                 "YIELD", "NOP", "JMP"),
}
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def kind(op: str) -> str:
    base = op.split(".")[0]
    for k, ops in KINDS.items():
        if base in ops:
            return k
    return "other"


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, text), ...], with labels as
    (address, None, label)} of `cuobjdump -sass` output."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"^\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            cur.append((None, None, lab.group(1)))
            continue
        ins = _INSTR.match(line)
        if ins:
            text = re.sub(r"^@!?U?P[T\d]+\s+", "", ins.group(2))
            cur.append((int(ins.group(1), 16), text.split()[0], ins.group(2)))
    return out


def step_loop(body, rank: int = 0):
    """The instructions of the backward branch that spans the most (rank
    0: the step loop; rank 1 the next, and so on), leaving out a branch
    whose span holds an EXIT: no step loop does, but the out-of-line retry
    of an mbarrier wait (K12 smem's staging) jumps back to the kernel's
    start.  Returns (instructions, all backward branches as (target,
    branch, length))."""
    labels, instrs = {}, []
    for addr, op, text in body:
        if op is None:
            labels[text] = None  # resolved to the next instruction below
            continue
        for k, v in labels.items():
            if v is None:
                labels[k] = addr
        instrs.append((addr, op, text))
    loops = []
    for i, (addr, op, text) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is not None and tgt < addr:
            j = next(j for j, x in enumerate(instrs) if x[0] == tgt)
            if any(op.startswith("EXIT") for _, op, _ in instrs[j:i + 1]):
                continue
            loops.append((tgt, addr, i - j + 1, j, i))
    if len(loops) <= rank:
        return [], [(hex(a), hex(b), n) for a, b, n, _, _ in loops]
    _, _, _, j, i = sorted(loops, key=lambda x: -x[2])[rank]
    return instrs[j:i + 1], [(hex(a), hex(b), n) for a, b, n, _, _ in loops]


def tile_loop(body):
    """K13's other warps' step loop: the largest loop after warp 0's (the
    step loop, which also steps the shadow) that holds a barrier ([] if
    none)."""
    rank = 1
    while True:
        loop, _ = step_loop(body, rank)
        if not loop or any(kind(op) == "barrier/sync" for _, op, _ in loop):
            return loop
        rank += 1


def ptxas(log: str, name: str):
    """(registers, spill stores in bytes) of the kernel `name` in the
    build log."""
    lines = log.splitlines()
    at = next((i for i, line in enumerate(lines)
               if "Compiling entry" in line and name in line), None)
    if at is None:
        return None, None
    spill = next(line for line in lines[at:] if "spill stores" in line)
    regs = next(line for line in lines[at:] if "registers" in line)
    return (int(re.search(r"Used (\d+) registers", regs).group(1)),
            int(re.search(r"(\d+) bytes spill stores", spill).group(1)))


def _tree_cuda(tree: str):
    """DIR/rtrt_tpu_torch/utils/cuda.py, loaded by path (it imports only
    the standard library and torch, and builds DIR's csrc/)."""
    path = os.path.join(tree, "rtrt_tpu_torch", "utils", "cuda.py")
    spec = importlib.util.spec_from_file_location("sass_loops_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: needs the CUDA toolkit")


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0])


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_warps(tree: str = _ROOT) -> dict:
    """Warps an SM of each probe's launch at its CLI's default rows: K6-K8
    have 32 threads (one warp) a row of their block, K6's block_rows of
    64, K7's 32, K8's block_rows of 32; K16 has 64 threads (2 lanes a
    thread) a row of its block_rows of 64; K10 / K12, K13 (its tile warps)
    and K15 128 / lanes threads a row of their block_rows at 64, 64 and 32
    rows, K14 at 64 rows of DIR's largest block, the lanes a thread DIR's
    (`lanes`); the one-block K10, K12, K13 and K14 of a tree from before
    their split 32."""
    from . import probe_bf16, probe_cond, probe_cores, probe_pressure
    from . import probe_xpose, ubench_step
    k16 = probe_bf16.launch_geometry(probe_bf16.SHAPE[0])[1] * 2
    k10 = lanes(tree, "probe_consume.cu", "CONSUME_L") or 1
    k13 = lanes(tree, "probe_consume.cu", "PRESSURE_L") or 1
    k15 = lanes(tree, "probe_record.cu", "XPOSE_L") or 4
    k14 = lanes(tree, "probe_record.cu", "BCAST_L")
    k14_rows = lanes(tree, "probe_record.cu", "BCAST_MAX_BLOCK_ROWS")
    return {"step_kernel": ubench_step.launch_geometry(64)[1],
            "leaf_kernel": 32,
            "cores_kernel": probe_cores.launch_geometry(32)[1],
            "consume_kernel": 32,
            "free_consume_kernel":
                probe_cond.launch_geometry(64)[1] * 4 // k10,
            "pressure_kernel":
                probe_pressure.launch_geometry(64)[1] * 4 // k13,
            "xpose_kernel": probe_xpose.launch_geometry(32)[1] * 4 // k15,
            "broadcast_kernel":
                min(64, k14_rows) * 4 // k14 if k14 and k14_rows else 32,
            "chains_f32": k16, "chains_bf16": k16}


def lanes(tree: str, source: str, name: str):
    """The `constexpr int NAME = N;` of DIR's csrc/SOURCE (N), or None."""
    path = os.path.join(tree, "rtrt_tpu_torch", "csrc", source)
    with open(path) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1)) if m else None


def k16_lanes(tree: str) -> int:
    """K16's lanes a thread in DIR: the `constexpr int L` of its
    csrc/probe_bf16.cu."""
    return lanes(tree, "probe_bf16.cu", "L")


def steps_in_body(kern: str, lanes: int, loop) -> float:
    """The steps one pass of the loop body runs.  K16: its FMNMX or HMNMX2
    instructions over one step's; K13: its barriers (one a step); K15: its
    MUFU.RCP (8 a lane a step) over one step's; K14: its REDUX (2 a
    step); 1 for the other probes."""
    ops = [op.split(".")[0] for _, op, _ in loop]
    if kern in ("consume_kernel", "pressure_kernel"):
        return ops.count("BAR")
    if kern == "broadcast_kernel":
        return ops.count("REDUX") / 2
    if kern == "xpose_kernel":
        rcp = sum(op.startswith("MUFU.RCP") for _, op, _ in loop)
        return rcp / (K15_RECORDS * lanes)
    if not kern.startswith("chains"):
        return 1
    f32 = kern == "chains_f32"
    mnmx = ops.count("FMNMX" if f32 else "HMNMX2")
    return mnmx / (2 * K16_CHAINS * (lanes if f32 else lanes // 2))


def _kernel(kern: str, fn: str) -> str:
    """The kernel number (K6 ... K16) of instantiation `fn` of `kern`:
    K10 or K12 by the consume's source (the global row: K10, whose flat
    mode is K12's extract; the staged table: K12)."""
    m = _FREE_CONSUME.search(fn) or _CONSUME_K10.search(fn)
    if m is not None and kern in ("consume_kernel", "free_consume_kernel"):
        src = m.group(1) if kern == "free_consume_kernel" else m.group(2)
        return "K12" if src == "1" else "K10"
    return KERNELS[kern]


def _mode(tree: str, kern: str, fn: str):
    """(mode label, lanes a thread or None) of instantiation `fn`, or None
    for an instantiation this tool does not count."""
    from . import (probe_broadcast, probe_cond, probe_cores, probe_leaf,
                   probe_xpose, ubench_step)
    modes = {"step_kernel": ubench_step.MODES,
             "leaf_kernel": probe_leaf.MODES,
             "cores_kernel": probe_cores.MODES,
             "broadcast_kernel": probe_broadcast.MODES,
             "xpose_kernel": probe_xpose.MODES}
    consume = lambda src, cond: "smem" if src == "1" else \
        probe_cond.MODES[int(cond)] + (" (and K12 extract)" * (cond == "0"))
    if kern == "free_consume_kernel":
        m = _FREE_CONSUME.search(fn)
        n = lanes(tree, "probe_consume.cu", "CONSUME_L")
        return f"{consume(m.group(1), m.group(2))} lanes {n}", n
    if kern == "consume_kernel":
        m = _CONSUME_K10.search(fn)
        if m is not None:
            return f"{consume(m.group(2), m.group(3))} one block", \
                int(m.group(1))
        m = _CONSUME_K13.search(fn)
        if m is None:
            return None
        n = int(m.group(1))  # 1 lane a thread at 8 rows, 8 at 64
        return f"rows {8 * n} n_inv {m.group(2)} one block", n
    if kern == "pressure_kernel":
        n = lanes(tree, "probe_consume.cu", "PRESSURE_L")
        m = re.search(r"pressure_kernelILi(\d+)E", fn)
        return f"n_inv {m.group(1)} lanes {n}", n
    if kern.startswith("chains"):
        n = k16_lanes(tree)
        return f"{kern[7:]} lanes {n}", n
    m = re.search(r"ILi(\d+)E(Lb1E)?", fn)
    mode = modes[kern][int(m.group(1))] if m else "?"
    if m and m.group(2):  # K6's reduce2 / reduce4 over a cluster
        mode += " cluster"
    if kern == "xpose_kernel":
        n = lanes(tree, "probe_record.cu", "XPOSE_L") or 4
        return f"{mode} lanes {n}", n
    if kern == "broadcast_kernel":
        n = lanes(tree, "probe_record.cu", "BCAST_L") or 8
        return f"{mode} lanes {n}", n
    return mode, None


def measure(tree: str, warps: dict, mhz: float) -> list:
    cuda = _tree_cuda(tree)
    lib = cuda.build()
    log = cuda.build_info.get("log", "")
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    rows = []
    for fn, body in sorted(functions(sass).items()):
        # the longest name that fn holds (consume_kernel is in
        # free_consume_kernel)
        kern = max((k for k in KERNELS if k in fn), key=len, default=None)
        label = _mode(tree, kern, fn) if kern else None
        if label is None:
            continue
        mode, n_lanes = label
        loop, loops = step_loop(body)
        warp0 = None
        if kern == "pressure_kernel":  # count the other warps' loop
            warp0, loop = loop, tile_loop(body)
        counts = {}
        for _, op, _ in loop:
            counts[kind(op)] = counts.get(kind(op), 0) + 1
        regs, spill = ptxas(log, fn)
        steps = steps_in_body(kern, n_lanes, loop)
        n = len(loop) / steps if steps else float("nan")
        w = warps[kern]
        row = dict(
            tree=tree, kernel=_kernel(kern, fn), mode=mode, registers=regs,
            spill_stores=spill, instructions=len(loop), by_kind=counts,
            steps_in_body=steps, instructions_per_step=n,
            backward_branches=loops, warps_per_sm=w, sm_mhz=mhz)
        slots = n * w
        if warp0 is not None:  # warp 0 runs its own loop, the shadow's too
            s0 = steps_in_body(kern, n_lanes, warp0)
            n0 = len(warp0) / s0 if s0 else float("nan")
            row["warp0_instructions_per_step"] = n0
            slots = n * (w - 1) + n0
        row["issue_floor_ns"] = slots / 4 / (mhz * 1e-3)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=_ROOT)
    ap.add_argument("--warps", action="append", default=[],
                    help="NAME=N: warps an SM of kernel NAME's launch")
    args = ap.parse_args(argv)
    from ..utils import timing
    card = timing.card()
    warps = default_warps(os.path.abspath(args.tree))
    for item in args.warps:
        k, v = item.split("=")
        warps[k] = int(v)
    mhz = max_sm_mhz()
    print(f"{card}; max SM clock {mhz:.0f} MHz; tree {args.tree}")
    rows = measure(os.path.abspath(args.tree), warps, mhz)
    for r in rows:
        print("SASS " + json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
