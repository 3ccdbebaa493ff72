"""A/B timing of the frame's kernels (K1, K2, K3, K4, K5) of several trees
of this package on one card, in one run.

    python rtrt_tpu_torch/tools/kernel_ab.py [--rounds 2] TREE [TREE ...]

Each TREE is a directory that holds an ``rtrt_tpu_torch`` package and
``resources/bluenoise64.npy`` (the Engine's blue-noise mask): this
checkout's root, or another revision unpacked beside it (``git archive
REV rtrt_tpu_torch resources/bluenoise64.npy`` into a directory that
.gitignore lists).  In each round the trees are
timed in the order given and then in reverse (A B ... B A), each in a fresh
process that imports the package from that tree only, builds its kernels
(into TREE/build/), builds the 1080p terrain Engine and times, with CUDA
events, at the main path's shapes:

  * K1: packet_intersect on the frame's 1920x1080 primary rays;
  * K2: megakernel_trace on the full frame (blue noise, frame 0), and its
    deepest traversal stack where the tree's K2 reports one;
  * K4: edge_aware_pass at each of the frame's four pass settings (7x7 half
    kernel, 5x5 at strides 3, 6, 12) on the G-buffer that tree's K2 renders;
  * K3: post_tail (ACES fitted, gamma 2.2, sharpen and dither on) on that
    frame's colour;
  * K5: reproject of that frame's planes as bfloat16 history under a
    camera motion (yaw 0.02 rad and 0.1 units), as chip_smoke does.

K2, K3 and K5 are timed twice: by CUDA events around chained calls ("K2",
"K3", "K5"; a call's Python wrapper costs as much as K3 or K5, so the host
can set the pace, and a busy host shifts even K2) and by replays of a CUDA
graph of the calls ("K2 graph", "K3 graph", "K5 graph": the kernels
alone).  The graph timer is this checkout's
`utils/timing.py::time_graph_ms`, loaded by path, so every tree is timed
by the same code.  Each process prints one line ``AB {json}`` (times in
ms, ptxas' registers and spills of K1-K5's kernels); the parent prints the
median of each tree's processes beside the card's name and power limit.
Needs a card.

With ``--probes`` each process times the probes instead: K6
(`tools/ubench_step.py::run`) in every mode at its CLI's defaults (64
rows, 4000 steps, 20 reps) and slab and reduce2 at 16 rows, K7
(`tools/probe_leaf.py::run`) in every mode at its defaults (32 rows, 400
steps, 10 reps, the tool's inputs), K8 (`tools/probe_cores.py::run`) in
every mode at 32 rows, 400 steps, 10 reps, and K9 (its 8-tile grid with
the big tables, mode both, 200 steps), K10 (`tools/probe_cond.py::run`)
in its three modes and K12 (`tools/probe_smem.py::run`) in both, at 64
rows, 400 steps, 10 reps, the tool's inputs, K13 (`tools/
probe_pressure.py::run`, 400 steps, 10 reps) at 64 rows with each n_inv
and at 8 rows with 20 planes, K14 (`tools/probe_broadcast.py::run`) in
both modes at 64 rows, 400 steps, 10 reps, K11 (`tools/probe_smem.py::
smem_alloc` at 48 KB on the tool's x, 64 rows: ms a launch by CUDA events
around 50 chained calls and by replays of a graph of 20 calls, both by
this checkout's `utils/timing.py`), K15 (`tools/probe_xpose.py::run`) in
both modes at 32 rows, 300 steps, 10 reps, and K16 (`tools/probe_bf16.py::
run`) in both modes at 64 rows, 4000 steps, 30 reps, each tree through
its own wrappers (ns a step, CUDA events); beside K8-K16 the tree's own
floor of a step ("... floor": its bound over the SMs the launch fills,
which a split over SMs changes; K11's a launch, in ms).  ``--only
K10,K12`` times only the probes named (by the key's first word).
ptxas' lines are those of the probes' kernels.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

W, H = 1920, 1080
PASSES = (("7x7", 3, 1, True, 0), ("s3", 2, 3, False, 0),
          ("s6", 2, 6, False, 0), ("s12", 2, 12, False, 0))


FRAME_KERNELS = ("megakernel", "traverse_kernel", "denoise_wide",
                 "post_tail", "reproject")
PROBE_KERNELS = ("step_kernel", "leaf_kernel", "cores_kernel",
                 "consume_kernel", "pressure_kernel", "alloc_kernel",
                 "broadcast_kernel", "xpose_kernel",
                 "chains_")  # consume_kernel: free_consume_kernel too


def _ptxas(log: str, kernels=FRAME_KERNELS) -> dict:
    """{mangled kernel name: ptxas' stack / spill and register lines} of
    the build log, for the kernels whose names hold one of `kernels`."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            cur = name if any(k in name for k in kernels) else None
        elif cur and ("spill stores" in line or "registers" in line):
            out.setdefault(cur, []).append(
                line.split("ptxas info    :")[-1].strip())
    return out


def _own_timing():
    """This checkout's utils/timing.py, whichever tree is imported."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utils", "timing.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str, reps2: int, reps4: int) -> dict:
    """Time K1-K5 of the package in `tree` (this process only)."""
    graph_ms = _own_timing().time_graph_ms
    sys.path.insert(0, os.path.abspath(tree))
    import inspect

    import torch
    import rtrt_tpu_torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.core.camera import (camera_basis, make_camera,
                                            motion_vector)
    from rtrt_tpu_torch.denoise.reproject import reproject
    from rtrt_tpu_torch.denoise.spatial import edge_aware_pass
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.post.pipeline import dither_mask
    from rtrt_tpu_torch.post.tail import post_tail, tail_params
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.render.raygen import generate_rays_padded
    from rtrt_tpu_torch.render.sampling import rand2_bn
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import (DynamicResolution, FeatureFlags,
                                             GlobalSettings, default_params)
    from rtrt_tpu_torch.utils.timing import time_ms

    pkg = os.path.dirname(os.path.abspath(rtrt_tpu_torch.__file__))
    assert pkg.startswith(os.path.abspath(tree)), pkg
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    dev = torch.device("cuda:0")
    cuda.library()
    eng = Engine(GlobalSettings(scene="terrain", render_width=W,
                                render_height=H, texture_size=256,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=FeatureFlags(denoise=False, bloom=False,
                                    lens_flare=False), device=dev)
    sc, consts = eng.scene_data, eng.consts
    rays = generate_rays_padded(camera_basis(eng.camera), W, H,
                                consts.pixel_ids, rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    res = dict(tree=tree, build=_ptxas(cuda.build_info["log"]))
    res["K1"] = time_ms(lambda: P.packet_intersect(sc.tables, org, dirs), 20)

    args = (sc.tables, pack_materials_rows(sc.materials).to(dev),
            M.pack_light_rows(sc.lights, dev), M.pack_sun_params(sc.sky), 0,
            rays.org, rays.dir, rays.cone_width, consts.pixel_ids)
    n_lights = 0 if sc.lights is None else sc.lights.center.shape[0]
    kw = dict(n_lights=n_lights, bn=consts.bn)
    if "stack_depth" in inspect.signature(M.megakernel_trace).parameters:
        depth = torch.zeros(1, dtype=torch.int32, device=dev)
        M.megakernel_trace(*args, stack_depth=depth, **kw)
        res["K2 deepest stack"] = int(depth)
    out = M.megakernel_trace(*args, **kw)
    k2 = lambda: M.megakernel_trace(*args, **kw)
    res["K2"] = time_ms(k2, reps2)
    res["K2 graph"] = graph_ms(k2, 5, reps2)

    gb = M.finish_gbuffer(sc.sky, rays, out, camera_basis(eng.camera), W / H)
    gb_in = (gb.color.contiguous(), gb.normal.contiguous(),
             gb.depth.contiguous(), gb.mat_id.contiguous(),
             default_params().denoise)
    k4 = []
    for label, rad, stride, half, par in PASSES:
        t = time_ms(lambda: edge_aware_pass(
            *gb_in, radius=rad, stride=stride, half_taps=half, parity=par),
            reps4)
        res[f"K4 {label}"] = t
        k4.append(t)
    res["K4 mean"] = sum(k4) / len(k4)

    final = (gb.color * gb.albedo).contiguous()
    par = tail_params(torch.tensor(0.9), 1.0, 2.2, 0.5, 0.37, dev)
    mask = dither_mask(dev)
    k3 = lambda: post_tail(final, par, mask, do_sharpen=True, do_dither=True)
    res["K3"] = time_ms(k3, reps4)
    res["K3 graph"] = graph_ms(k3, 20, reps4)

    bf = lambda x: x.to(torch.bfloat16).contiguous()
    count = torch.full((H, W), 4.0, device=dev)
    hist = (bf(gb.color), bf(final), bf(gb.depth), gb.mat_id.contiguous(),
            bf(count))
    cam = eng.camera
    prev = make_camera(pos=(cam.pos + torch.tensor([0.1, 0.0, 0.0],
                                                   device=dev)).tolist(),
                       yaw=float(cam.yaw) - 0.02, pitch=float(cam.pitch),
                       fov_y=float(cam.fov_y), device=dev)
    world = rays.org + rays.dir * torch.clamp(gb.depth, max=1e8)[..., None]
    mv = motion_vector(camera_basis(prev), rays.uv, world,
                       W / H).contiguous()
    k5 = lambda: reproject(*hist, mv)
    res["K5"] = time_ms(k5, reps4)
    res["K5 graph"] = graph_ms(k5, 20, reps4)
    return res


def probe_child(tree: str, only=()) -> dict:
    """Time K6-K16 of the package in `tree` (this process only); `only`:
    the probes to time (K numbers), all if empty."""
    own = _own_timing()
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import rtrt_tpu_torch
    from rtrt_tpu_torch.tools import (probe_bf16, probe_broadcast,
                                      probe_cond, probe_cores, probe_leaf,
                                      probe_pressure, probe_smem,
                                      probe_xpose, ubench_step)
    from rtrt_tpu_torch.utils import cuda

    pkg = os.path.dirname(os.path.abspath(rtrt_tpu_torch.__file__))
    assert pkg.startswith(os.path.abspath(tree)), pkg
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    cuda.library()
    res = dict(tree=tree, build=_ptxas(cuda.build_info["log"],
                                       PROBE_KERNELS))
    want = lambda k: not only or k in only
    if want("K6"):
        for m in ubench_step.MODES:
            res[f"K6 {m}"] = ubench_step.run(m, 64, 4000, 20)[0]
        for m in ("slab", "reduce2"):
            res[f"K6 {m} 16 rows"] = ubench_step.run(m, 16, 4000, 20)[0]
    if want("K7"):
        for m in probe_leaf.MODES:
            res[f"K7 {m}"] = probe_leaf.run(m, 32, 400, 10)[0]
    if want("K8"):
        for m in probe_cores.MODES:
            res[f"K8 {m}"], res[f"K8 {m} floor"] = probe_cores.run(
                m, 32, 400, 10)
    if want("K9"):
        res["K9 both"], res["K9 both floor"] = probe_cores.run(
            "both", 32, steps=200, grid_tiles=8, big_tables=True)
    if want("K10"):
        for m in probe_cond.MODES:
            res[f"K10 {m}"], res[f"K10 {m} floor"] = probe_cond.run(m)
    if want("K12"):
        for m in probe_smem.MODES:
            res[f"K12 {m}"], res[f"K12 {m} floor"] = probe_smem.run(m)
    if want("K13"):
        for rows, n_inv in [(64, n) for n in probe_pressure.N_INV] \
                + [(8, 20)]:
            key = f"K13 {rows} rows n_inv {n_inv}"
            res[key], res[f"{key} floor"] = probe_pressure.run(n_inv, rows)
    if want("K14"):
        for m in probe_broadcast.MODES:
            res[f"K14 {m}"], res[f"K14 {m} floor"] = probe_broadcast.run(
                m, 400, 10)
    if want("K11"):
        x = torch.ones((64, 128), device="cuda")
        k11 = lambda: probe_smem.smem_alloc(x, probe_smem.SMEM_DEFAULT // 4)
        res["K11 events ms"] = own.time_ms(k11, 50)
        res["K11 graph ms"] = own.time_graph_ms(k11, 20, 50)
        res["K11 floor ms"] = probe_smem.alloc_bound()[0]
    if want("K15"):
        for m in probe_xpose.MODES:
            res[f"K15 {m}"], res[f"K15 {m} floor"], _ = probe_xpose.run(
                m, 32, 300)
    if want("K16"):
        for m in probe_bf16.DTYPES:
            res[f"K16 {m}"], res[f"K16 {m} floor"] = probe_bf16.run(
                m, 4000, 30)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps2", type=int, default=10)
    ap.add_argument("--reps4", type=int, default=50)
    ap.add_argument("--probes", action="store_true",
                    help="time K6-K16 instead of K1-K5")
    ap.add_argument("--only", default="",
                    help="with --probes: the probes to time, e.g. K10,K12")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child is not None:
        only = tuple(k for k in a.only.split(",") if k)
        res = probe_child(a.child, only) if a.probes else \
            child(a.child, a.reps2, a.reps4)
        print("AB " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {t: [] for t in a.trees}
    failed = set()
    order = []
    for _ in range(a.rounds):
        order += list(a.trees) + list(reversed(a.trees))
    for tree in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree, "--reps2", str(a.reps2),
                            "--reps4", str(a.reps4), "--only", a.only]
                           + ["--probes"] * a.probes,
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode or not lines:
            print(f"AB {tree} failed (rc {p.returncode}):\n"
                  + p.stdout[-2000:] + p.stderr[-4000:], flush=True)
            failed.add(tree)
            continue
        r = json.loads(lines[-1][3:])
        print(lines[-1], flush=True)
        runs[tree].append(r)
    unit = "ns a step" if a.probes else "ms"
    print(f"median over {2 * a.rounds} processes per tree, {unit} "
          f"[{smi}]:")
    for tree, rs in runs.items():
        if not rs:
            continue
        keys = [k for k in rs[0] if isinstance(rs[0][k], float)]
        med = {k: round(statistics.median(r[k] for r in rs), 4)
               for k in keys}
        extra = {k: rs[0][k] for k in rs[0]
                 if k not in keys and k not in ("tree",)}
        print(f"  {tree}: {json.dumps(med)} {json.dumps(extra)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
