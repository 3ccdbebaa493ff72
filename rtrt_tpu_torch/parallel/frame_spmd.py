"""The product frame split into row bands over torch.distributed (port of
rtrt_tpu/parallel/frame_spmd.py).

One process per device.  Each rank owns one horizontal band of image rows
[r0, r1): it traces the band with its own K2 launch (or the wavefront's
loop route), denoises and post-processes it, fetching from the other
ranks only the planes that a stage reads outside the band, and carries
the band's history from frame to frame.  The frame it computes is the
single-device frame (engine/frame.py::render_frame with its `band` hook;
the stages' band forms are in denoise/pipeline.py and post/pipeline.py).
Scene tables, sky, materials and camera are replicated (`replicate`
broadcasts rank 0's tensors, so every rank traces the same bits); the
LBVH rebuild and the refit stay replicated too, as in JAX.

Why one process per device, not one thread driving N devices as JAX
does: every frame is already bound by the host's launches (PERF.md §5),
which one thread would pay N times over; and K2's launcher keeps
per-process `__constant__` state (the sun parameters and the Fourier
table, csrc/megakernel.cu), which N devices of one process would race on.
Each process has its own CUDA context and its own copy of those symbols,
and utils/cuda.py::launch enters the tensor's device, so K2's launcher is
unchanged.

The collectives (all on the rank's device; the mesh's process group):
  * `RowMesh.gather` — the whole image of band-sharded planes: one
    `all_gather` of their bytes.  It moves every band, not only the rows a
    stencil reads beyond its own (fetching only the neighbours' rows is
    later work); a halo may be deeper than a band (the 5x5 pass at stride
    12 reads 24 rows).  `band_rows` cuts rows [lo, hi), clamped to the
    image, from it.
  * `RowMesh.all_reduce_sum` — the sun pixel's depth, which one rank holds.
  * `replicate` — `broadcast` from rank 0.
All three take the rank's tensors as they are, on the card for NCCL and
for gloo alike (ranks that share one card run gloo: NCCL refuses two
ranks on one GPU).  What `RowMesh.fetched` counts is the bytes a rank
received from the others.

What JAX's frame_spmd.py:110-113 refuses, `make_spmd_frame_fn` refuses
(ValueError): render or screen heights that do not divide over the ranks
(equal bands; 1080 rows over 4 ranks are 270-row bands, which no stage
takes to be tile-aligned), and the wavefront route with K1
(use_packets=True, use_megakernel=False), whose row-sharded form JAX
routes through the megakernel.  The loop route (use_packets=False)
shards.  Interlaced frames need bands of an even row count.

Entry point (the counterpart of __graft_entry__.py::dryrun_multichip):

    python -m rtrt_tpu_torch.parallel.frame_spmd --ranks N
        [--device cuda | cpu] [--share-device] [--scene terrain]
        [--width 1920 --height 1080] [--frames 3] [--trace megakernel]

`--ranks N` spawns N processes with a file:// store in a temporary
directory (no TCP port); under `torchrun --nproc-per-node N -m
rtrt_tpu_torch.parallel.frame_spmd` the ranks come from RANK,
WORLD_SIZE and LOCAL_RANK.  The backend is nccl on CUDA (rank i on
cuda:i) and gloo with `--device cpu`; ranks that share cuda:0 over gloo
must be asked for with `--share-device`.  The frames are a slow yaw pan
(PAN_STEP a frame) at texture size TEXTURE_SIZE; rank 0 prints one JSON
line of each rank's ms/frame, launches and bytes fetched a frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..bvh.packet import LEAF_WIDTH
from ..bvh.refit import leaf_bounds, refit_nodes4
from ..engine.frame import (FrameState, FrameStatic, interlaced,
                            make_frame_consts, render_frame)
from ..ops.stencil import clamp_rows

TIMEOUT = datetime.timedelta(seconds=600)  # of any one collective
PAN_STEP = 0.002    # the entry point's yaw a frame (rad): a slow pan
TEXTURE_SIZE = 256  # the entry point's soil textures


@dataclasses.dataclass
class RowMesh:
    """One rank's view of the 1-D mesh of row bands: its process group,
    rank, world size and device, and its band of the image's rows at
    render size [r0, r1) of h and at screen size [s0, s1) of sh."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str
    h: int
    r0: int
    r1: int
    sh: int
    s0: int
    s1: int
    fetched: int = 0  # bytes received from the other ranks

    def gather(self, planes: list) -> list:
        """The whole image of each band-sharded plane (n, ...) of `planes`
        (the same n for all; any dtype): one all-gather of their bytes."""
        n = planes[0].shape[0]
        packed = torch.cat([p.contiguous().reshape(n, -1).view(torch.uint8)
                            for p in planes], 1)
        parts = [torch.empty_like(packed) for _ in range(self.world)]
        dist.all_gather(parts, packed, group=self.group)
        self.fetched += packed.numel() * (self.world - 1)
        whole = torch.cat(parts, 0)
        out, col = [], 0
        for p in planes:
            nb = p[0].numel() * p.element_size()
            out.append(whole[:, col:col + nb].contiguous().view(p.dtype)
                       .reshape((whole.shape[0],) + tuple(p.shape[1:])))
            col += nb
        return out

    def all_reduce_sum(self, t):
        """The sum over the ranks of tensor t (a new tensor)."""
        t = t.contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def extend(self, x, k: int):
        """Rows [r0 - k, r1 + k) of the whole-image plane x, each clamped to
        the image: the band and the k rows on each side that a stencil
        reads, the image's edge rows repeated beyond its edges as the
        stencils clamp."""
        return clamp_rows(x, self.r0 - k, self.r1 + k)


def _device(device):
    """The rank's device: "cuda" is the process's current card (set by
    `spawn` or the caller); no default picks the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda': no CUDA device")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_row_mesh(render_h: int, screen_h: int | None = None,
                  device="cuda", group=None) -> RowMesh:
    """The rank's RowMesh over the (initialised) process group: equal
    bands of render_h and screen_h (default render_h) rows; heights that do
    not divide over the ranks raise ValueError, as JAX's mesh rule."""
    if not dist.is_initialized():
        raise RuntimeError("make_row_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, `spawn` "
                           "or this module's entry point)")
    screen_h = render_h if screen_h is None else screen_h
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    for name, n in (("render_h", render_h), ("screen_h", screen_h)):
        if n % world:
            raise ValueError(f"{name}={n} must divide over {world} row "
                             "bands")
    rb, sb = render_h // world, screen_h // world
    return RowMesh(group=group, rank=rank, world=world,
                   device=_device(device), backend=dist.get_backend(group),
                   h=render_h, r0=rank * rb, r1=(rank + 1) * rb,
                   sh=screen_h, s0=rank * sb, s1=(rank + 1) * sb)


def band_rows(mesh: RowMesh, x, lo: int, hi: int):
    """Global rows [lo, hi) of the band-sharded plane x, clamped to the
    image, on every rank (a halo may reach beyond the next band)."""
    return clamp_rows(mesh.gather([x])[0], lo, hi)


def shard_frame_state(mesh: RowMesh, state: FrameState) -> FrameState:
    """The rank's part of a whole-image FrameState: the history planes cut
    to the band; exposure, frame_idx and time as they are (replicated)."""
    hist = state.history
    if hist is not None:
        if hist.color.shape[0] != mesh.h:
            raise ValueError(f"history of {hist.color.shape[0]} rows, the "
                             f"mesh's image {mesh.h}")
        cut = lambda x: x[mesh.r0:mesh.r1].contiguous()
        hist = hist._replace(color=cut(hist.color), color2=cut(hist.color2),
                             depth=cut(hist.depth), mat_id=cut(hist.mat_id),
                             count=cut(hist.count))
    return dataclasses.replace(state, history=hist)


def _tensors(obj):
    """The tensors of a nest of dataclasses, tuples, lists and dicts, in a
    fixed order."""
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def replicate(mesh: RowMesh, obj):
    """Overwrite every tensor of obj (scene tables, sky maps, materials,
    camera ...: a nest of dataclasses, tuples, lists and dicts, built alike
    on every rank) with rank 0's, in place; returns obj.  All ranks then
    trace identical tables, so a one-ulp difference between two rank-local
    builds cannot show up as a seam."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    for t in _tensors(obj):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf.reshape(-1).view(torch.uint8), src,
                       group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    return obj


def make_spmd_frame_fn(mesh: RowMesh, static: FrameStatic):
    """The rank's frame function: fn(scene, state, camera, prev_camera,
    params, dt, consts=None, overflow=None, stack_depth=None, rest=None),
    the arguments of engine/frame.py::render_frame, with the rank's part
    of the state (`shard_frame_state`) -> (the band's (s1 - s0, screen_w,
    3) u8 rows, the new band-sharded state, the band's G-buffer).  Refuses
    (ValueError) what JAX's make_spmd_frame_fn refuses."""
    for name, n, m in (("render_h", static.render_h, mesh.h),
                       ("screen_h", static.screen_h, mesh.sh)):
        if n % mesh.world:
            raise ValueError(f"{name}={n} must divide over {mesh.world} row "
                             "bands")
        if n != m:
            raise ValueError(f"{name}={n}, the mesh's {m}")
    if static.use_packets and not static.use_megakernel:
        raise ValueError("the row-sharded wavefront route takes the loop "
                         "traverser (use_packets=False); with packets it "
                         "goes through the megakernel (use_megakernel=True), "
                         "as in JAX")
    if interlaced(static) and (mesh.r1 - mesh.r0) % 2:
        raise ValueError(f"interlace needs bands of an even row count, not "
                         f"{mesh.r1 - mesh.r0}")
    band_consts = make_frame_consts(static, mesh.device, mesh)

    def frame(scene, state, camera, prev_camera, params, dt, consts=None,
              overflow=None, stack_depth=None, rest=None):
        return render_frame(static, scene, state, camera, prev_camera,
                            params, dt,
                            band_consts if consts is None else consts,
                            overflow, stack_depth, rest, band=mesh)

    return frame


def gather_image(mesh: RowMesh, band):
    """The whole image from the ranks' bands: on rank 0, None elsewhere."""
    img = mesh.gather([band])[0]
    return img if mesh.rank == 0 else None


def sharded_refit(mesh: RowMesh, plan, tris_t, n_leaves: int):
    """bvh/refit.py::refit_nodes4 with its leaf-bounds stage sharded: the
    bounds of this rank's share of the leaves, one all-gather of them, then
    the node refit (replicated).  n_leaves must divide over the ranks: pad
    the (9, P) table to it (the plan reads only its own leaves).  Returns
    the refitted raw (q, 32) records."""
    if n_leaves % mesh.world:
        raise ValueError(f"n_leaves={n_leaves} must divide over {mesh.world} "
                         "ranks (pad the table)")
    per = n_leaves // mesh.world
    a = mesh.rank * per * LEAF_WIDTH
    lo, hi = leaf_bounds(tris_t[:, a:a + per * LEAF_WIDTH], per)
    lo, hi = mesh.gather([lo, hi])
    return refit_nodes4(plan, lo, hi)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _backend(device: str, share_device: bool) -> str:
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    return "gloo" if share_device else "nccl"


def _rank_device(device: str, share_device: bool, local_rank: int):
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda': no CUDA device (ask for "
                           "--device cpu)")
    index = 0 if share_device else local_rank
    if index >= torch.cuda.device_count():
        raise ValueError(f"rank {local_rank}: {torch.cuda.device_count()} "
                         "cards (ranks that share one card: share_device)")
    return torch.device("cuda", index)


def _spawned(rank, world, init_method, device, share_device, fn, args):
    dev = _rank_device(device, share_device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(_backend(device, share_device),
                            init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), device: str = "cuda",
          share_device: bool = False):
    """Run fn(rank, *args) in `world` new processes, each a rank of one
    process group (a file:// store in a temporary directory, no TCP port)
    with its device current: nccl with rank i on cuda:i, gloo on cuda:0
    with share_device, gloo on the CPU with device "cpu" (one thread a
    rank).  fn must be importable by name.  Raises if a rank fails (and
    ends the others)."""
    import torch.multiprocessing as mp

    _backend(device, share_device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned, nprocs=world, start_method="spawn",
                           args=(world, f"file://{tmp}/store", device,
                                 share_device, fn, tuple(args)))


def run_rank(rank: int, cfg: dict, out_dir: str | None = None) -> dict:
    """One rank of the entry point's run, in a process of an initialised
    group with its device current: the Engine's scene (built on every rank,
    then replicated from rank 0), `cfg["frames"]` frames of a slow yaw pan
    (yaw + PAN_STEP k) through the rank's frame function, each
    frame's launches and bytes fetched; ms/frame by host clock over the
    frames after the first; then, on the card and but for the loop route
    (whose host-synced steps make ~10^5 profiler events, minutes of the
    profiler's own time), one more frame under torch.profiler for the
    rank's device-busy ms.  Returns (and with out_dir
    saves to rank{rank}.pt) the record: the gathered images on rank 0, and
    every frame's band stages (the G-buffer colour, the history's colour
    after the 7x7 pass and after the chain) on the host."""
    from ..bvh.packet import overflow_counter
    from ..engine.engine import Engine
    from ..utils import cuda
    from ..utils.config import (DynamicResolution, FeatureFlags,
                                GlobalSettings)

    dev = _device("cpu" if cfg["device"] == "cpu" else "cuda")
    eng = Engine(GlobalSettings(scene=cfg["scene"],
                                render_width=cfg["width"],
                                render_height=cfg["height"],
                                texture_size=TEXTURE_SIZE,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 FeatureFlags(), trace=cfg["trace"],
                 device=dev)
    mesh = make_row_mesh(eng.static.render_h, eng.static.screen_h, dev)
    replicate(mesh, eng.scene_data)
    fn = make_spmd_frame_fn(mesh, eng.static)
    state = shard_frame_state(mesh, eng.state)
    cam0 = eng.camera
    overflow = overflow_counter(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prev, rec = cam0, dict(rank=rank, world=mesh.world,
                           backend=mesh.backend, rows=(mesh.r0, mesh.r1),
                           images=[], stages=[], counts=[], fetched=[],
                           ms=[], busy_ms=None)
    profiled = dev.type == "cuda" and cfg["trace"] != "loop"
    for k in range(cfg["frames"] + int(profiled)):
        cam = dataclasses.replace(cam0, yaw=cam0.yaw + PAN_STEP * k)
        step = lambda: fn(eng.scene_data, state, cam, prev, eng.params,
                          1 / 60, overflow=overflow)
        cuda.reset_launch_counts()
        f0 = mesh.fetched
        sync()
        t0 = time.perf_counter()
        if k < cfg["frames"]:
            img, state, gbuf = step()
        else:  # the profiled frame: device busy, the top device ops
            img, state, gbuf, (rec["busy_ms"], rec["top_ops"],
                               rec["launches"]) = _profiled(step)
        sync()
        if k < cfg["frames"]:
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["counts"].append({n: c for n, c in cuda.launch_counts.items()
                                  if c})
            rec["fetched"].append(mesh.fetched - f0)
            hist = state.history
            rec["stages"].append(dict(
                trace=gbuf.color.cpu(),
                **({} if hist is None else dict(denoise_7x7=hist.color.cpu(),
                                               denoise=hist.color2.cpu()))))
            full = gather_image(mesh, img)
            if full is not None:
                rec["images"].append(full.cpu())
        prev = cam
    rec.update(overflow=int(overflow), band_shape=tuple(img.shape),
               history_shapes=None if state.history is None else {
                   f: tuple(getattr(state.history, f).shape)
                   for f in ("color", "color2", "depth", "mat_id",
                             "count")})
    if out_dir is not None:
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    return rec


def _profiled(step):
    """step() under torch.profiler: (its results..., (device-busy ms, the
    4 device ops of most time as (name, ms), kernel launches))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step()
        torch.cuda.synchronize()
    t = lambda e: getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    avg = prof.key_averages()
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=t, reverse=True)
    return (*out, (sum(map(t, kern)),
                   [(e.key[:48], round(t(e), 4)) for e in kern[:4]],
                   sum(e.count for e in avg if "LaunchKernel" in e.key)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="spawn this many ranks (else RANK / WORLD_SIZE / "
                        "LOCAL_RANK, as torchrun sets them)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--share-device", action="store_true",
                   help="the ranks share cuda:0 over gloo")
    p.add_argument("--scene", default="terrain")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--trace", default="megakernel",
                   choices=("megakernel", "loop"))
    a = p.parse_args(argv)
    cfg = dict(device=a.device, scene=a.scene, width=a.width,
               height=a.height, frames=a.frames, trace=a.trace)
    with tempfile.TemporaryDirectory() as out_dir:
        if a.ranks is not None:
            spawn(run_rank, a.ranks, (cfg, out_dir), a.device,
                  a.share_device)
            recs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                               weights_only=False) for r in range(a.ranks)]
        else:
            rank, world = int(os.environ["RANK"]), int(
                os.environ["WORLD_SIZE"])
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = _rank_device(a.device, a.share_device, local)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(_backend(a.device, a.share_device),
                                    init_method="env://", rank=rank,
                                    world_size=world, timeout=TIMEOUT)
            try:
                rec = run_rank(rank, cfg)
                recs = [None] * world
                dist.all_gather_object(recs, {k: rec[k] for k in (
                    "rank", "rows", "counts", "fetched", "ms", "busy_ms")})
            finally:
                dist.destroy_process_group()
            if rank:
                return 0
    print(json.dumps([dict(rank=r["rank"], rows=r["rows"],
                           ms_per_frame=r["ms"][1:],
                           busy_ms=r["busy_ms"],
                           fetched_bytes_per_frame=r["fetched"],
                           launches_per_frame=r["counts"])
                      for r in recs]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
