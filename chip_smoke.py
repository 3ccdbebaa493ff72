#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rtrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device: the card's name and power limit, whether the native content
     library loaded;
  2. build: nvcc builds the three kernels of csrc/ from this checkout and
     prints ptxas' registers / spills per kernel;
  3. each kernel vs its plain PyTorch version on the card, on the 1080p
     terrain scene's tables and the full 1920x1080 frame's rays: K1
     traversal (the primary rays + any-hit rays from their hits toward a
     low sun), K2 megakernel (all 18 output planes, and the finished
     G-buffer colour), K3 post tail (the frame K2 rendered); each kernel
     and its plain version are timed at that shape;
  4. main path: Engine(terrain, 1920x1080, slice flags) renders 3 warm-up
     and 10 timed frames; launch counters are reset just before, and K2's
     and K3's must read 13 after (K1's traversal runs inside K2); output,
     G-buffer and image checks.
Prints the per-kernel JSON line, then as its last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.  Exits 1 when CUDA is not available.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
WARMUP, TIMED = 3, 10


def _ms(fn, iters):
    """(mean milliseconds per call of fn over `iters` calls after one
    warm-up call, CUDA events; the last call's result)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, out


def _t_rounding_bound(tables, tri, o, d):
    """A-priori bound on float32 rounding in Moller-Trumbore's t of rays
    (o, d) on their hit slots: t = e2.((o - v0) x e1) / e1.(d x e2), each
    dot at most 13 roundings deep, bounded by the same products in
    absolute value (16 unit roundoffs, to first order)."""
    import torch

    def cross_abs(a, b):
        a, b = a.abs(), b.abs()
        return torch.stack([a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] + a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]], 1)

    rec = tables.tris[tri.long()].double()
    v0, e1, e2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    o, d = o.double(), d.double()
    det = (e1 * torch.cross(d, e2, dim=1)).sum(1).abs()
    t = (e2 * torch.cross(o - v0, e1, dim=1)).sum(1).abs() / det
    s_t = (e2.abs() * cross_abs(o.abs() + v0.abs(), e1)).sum(1)
    s_d = (e1.abs() * cross_abs(d, e2)).sum(1)
    return 16 * 2.0 ** -24 * (s_t + t * s_d) / det


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rtrt_tpu.content import native
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.core.camera import camera_basis
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.post.exposure import auto_exposure
    from rtrt_tpu_torch.post.pipeline import dither_mask
    from rtrt_tpu_torch.post.tail import post_tail, post_tail_plain, \
        tail_params
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.render.raygen import generate_rays_padded
    from rtrt_tpu_torch.render.sampling import rand2_bn
    from rtrt_tpu_torch.ops.resize import downsample4
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import DynamicResolution, \
        FeatureFlags, GlobalSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    print(smi)
    print(f"native content library loaded: {native.available()}")

    # ---- 2. build ----
    cuda.library()
    info = cuda.build_info
    print(f"build: {info['seconds']:.2f} s (cached={info['cached']}) "
          f"-> {os.path.relpath(info['path'], REPO)} {card}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("  " + line.strip())

    # ---- scene (the main path's Engine; no kernel runs in init) ----
    flags = FeatureFlags(denoise=False, bloom=False, lens_flare=False)
    eng = Engine(GlobalSettings(scene="terrain", render_width=W,
                                render_height=H, texture_size=256,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=flags, device="cuda")
    s = eng.init_seconds
    print(f"init: scene {s['scene']:.2f} s, SAH+BVH4 {s['sah']:.2f} s, "
          f"sky {s['sky']:.2f} s; {eng.scene.num_tris} tris, "
          f"{eng.scene_data.tables.nodes.shape[0]} BVH4 nodes {card}")
    sc, consts = eng.scene_data, eng.consts
    tables = sc.tables
    rays = generate_rays_padded(camera_basis(eng.camera), W, H,
                                consts.pixel_ids, rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))

    # ---- 3a. K1 traversal: the frame's primaries + a shadow-ray batch ----
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    ovf = P.overflow_counter(dev)
    g = P.packet_intersect(tables, org, dirs, overflow=ovf)
    r = P.packet_intersect_plain(tables, org, dirs)
    h = r.tri >= 0
    sh_org = (org + dirs * torch.where(h, r.t, 0.0)[:, None]
              + r.ng * 1e-3 * torch.sign((r.ng * -dirs).sum(-1, True)))[h]
    # any-hit rays toward a low sun (6 degrees above the horizon, the
    # sun's azimuth), so that the dunes occlude a share of them
    sd = sc.sky.sun_dir
    low = torch.stack([sd[0], torch.linalg.vector_norm(sd[0::2]) * 0.105,
                       sd[2]])
    sh_dir = (low / torch.linalg.vector_norm(low)).expand_as(
        sh_org).contiguous()
    gs = P.packet_intersect(tables, sh_org, sh_dir, any_hit=True,
                            overflow=ovf)
    rs = P.packet_intersect_plain(tables, sh_org, sh_dir, any_hit=True)
    torch.cuda.synchronize()
    # t tolerance, where the slots agree: rtol 1e-5 plus 4e-6 absolute
    # (the float32 spacing of the terrain's ~64-unit coordinates) on
    # >= 99.99% of the rays, and on every ray the larger of that and twice
    # the a-priori bound on float32 rounding in t.  Kernel and plain
    # version each round within that bound, in different ways (nvcc
    # contracts products into FMA); it exceeds 1e-5 t where Moller-Trumbore
    # is ill-conditioned: grazing rays (at 1080p a few horizon rays with
    # |cos| ~ 0.005-0.02 differ by ~2.5e-5 t) and short shadow rays from an
    # origin far from the triangle's v0
    k1_err = 0.0
    for name, o, d, a, b in (("primary", org, dirs, g, r),
                             ("shadow", sh_org, sh_dir, gs, rs)):
        same = a.tri == b.tri
        frac = same.float().mean().item()
        fin = same & torch.isfinite(b.t)
        dt = (a.t - b.t).abs()[fin].double()
        flat = 1e-5 * b.t.abs()[fin].double() + 4e-6
        cond = 2 * _t_rounding_bound(tables, b.tri[fin], o[fin], d[fin])
        worst = (dt / torch.maximum(flat, cond)).max().item() \
            if fin.any() else 0.0
        n_flat = int((dt > flat).sum())
        k1_err = max(k1_err, dt.max().item() if fin.any() else 0.0)
        print(f"K1 {name}: {a.tri.numel()} rays, {(b.tri >= 0).sum().item()}"
              f" hits, tri id equal on {frac:.6f}, t max abs err "
              f"{(dt.max().item() if fin.any() else 0.0):.3e}; {n_flat} "
              f"rays beyond 1e-5 t + 4e-6; worst error / rounding bound "
              f"{worst:.3f}")
        assert frac >= 0.999, f"K1 {name}: tri ids equal on only {frac}"
        assert n_flat <= 1e-4 * int(fin.sum()), \
            f"K1 {name}: t beyond rtol 1e-5 on {n_flat} rays"
        assert worst <= 1.0, f"K1 {name}: t error beyond bound ({worst})"
    assert int(ovf) == 0, f"K1 stack overflow count {int(ovf)}"
    k1_ms, _ = _ms(lambda: P.packet_intersect(tables, org, dirs), 10)
    k1_plain, _ = _ms(lambda: P.packet_intersect_plain(tables, org, dirs), 1)
    print(f"K1 time, {W}x{H} primary rays: kernel {k1_ms:.3f} ms, plain "
          f"{k1_plain:.1f} ms {card}")

    # ---- 3b. K2 megakernel: the full frame ----
    mat_rows = pack_materials_rows(sc.materials).to(dev)
    light_rows = M.pack_light_rows(sc.lights, dev)
    n_lights = 0 if sc.lights is None else sc.lights.center.shape[0]
    args = (tables, mat_rows, light_rows, M.pack_sun_params(sc.sky), 0,
            rays.org, rays.dir, rays.cone_width, consts.pixel_ids)
    ovf.zero_()
    a = M.megakernel_trace(*args, n_lights=n_lights, bn=consts.bn,
                           overflow=ovf)
    k2_ms, _ = _ms(lambda: M.megakernel_trace(*args, n_lights=n_lights,
                                              bn=consts.bn), 5)
    k2_plain, b = _ms(lambda: M.megakernel_trace_plain(
        *args, n_lights=n_lights, bn=consts.bn), 1)
    print(f"K2 time, {W}x{H}: kernel {k2_ms:.3f} ms, plain {k2_plain:.1f} "
          f"ms {card}")
    # per pixel on >= 99%: depth rtol 1e-4, mat id equal, normal, albedo,
    # esc_dir and esc_pdf atol 5e-3, esc_beta atol 5e-3 + rtol 1e-2 (nvcc's
    # FMA contraction moves a few bounce directions by an ulp, and a path
    # that crosses a decision boundary diverges; beyond that, esc_beta
    # carries 1 / (1 - q) of the shadow-or-scatter choice, whose q holds
    # the sun-disk limb term: one rounding of the sun sample's cosine moves
    # it by ~0.25%); the escape planes exactly where the primary ray
    # misses; mean radiance and finished colour per channel within 1%
    miss = (a.mat_id == -1) & (b.mat_id == -1)
    close = lambda x, y, rtol=0.0: (
        ((x - y).abs() - rtol * y.abs()).reshape(H, W, -1).amax(-1) <= 5e-3)
    oks = dict(
        depth=torch.isclose(a.depth, b.depth, rtol=1e-4, atol=0) | (
            torch.isinf(a.depth) & torch.isinf(b.depth)),
        mat_id=a.mat_id == b.mat_id,
        **{f: close(getattr(a, f), getattr(b, f))
           for f in ("normal", "albedo", "esc_dir", "esc_pdf")},
        esc_beta=close(a.esc_beta, b.esc_beta, 1e-2))
    fracs = {f: ok[~miss].float().mean().item() for f, ok in oks.items()
             if f.startswith("esc")}
    fracs.update({f: ok.float().mean().item() for f, ok in oks.items()
                  if not f.startswith("esc")})
    miss_exact = all(torch.equal(getattr(a, f)[miss], getattr(b, f)[miss])
                     for f in ("esc_dir", "esc_beta", "esc_pdf"))
    gba = M.finish_gbuffer(sc.sky, rays, a, camera_basis(eng.camera), W / H)
    gbb = M.finish_gbuffer(sc.sky, rays, b, camera_basis(eng.camera), W / H)
    rel = lambda x, y: ((x.mean((0, 1)) - y.mean((0, 1))).abs()
                        / y.mean((0, 1)).abs().clamp(min=1e-6)).max().item()
    rad_rel, col_rel = rel(a.radiance, b.radiance), rel(gba.color, gbb.color)
    m_ok = oks["mat_id"]
    k2_err = max((getattr(a, f) - getattr(b, f)).abs()[m_ok].max().item()
                 for f in ("normal", "albedo"))
    print(f"K2 {W}x{H}: share of pixels within bounds "
          f"{ {f: round(v, 6) for f, v in fracs.items()} } (escape planes "
          f"over the {(~miss).sum().item()} primary hits); escape planes "
          f"exact on the {miss.sum().item()} primary misses: {miss_exact}; "
          f"mean radiance rel err {rad_rel:.3e}, mean finished colour rel "
          f"err {col_rel:.3e}")
    for f, v in fracs.items():
        assert v >= 0.99, f"K2 {f} agrees on only {v}"
    assert miss_exact, "K2 escape planes differ on primary misses"
    assert rad_rel <= 0.01, f"K2 mean radiance differs by {rad_rel}"
    assert col_rel <= 0.01, f"K2 mean finished colour differs by {col_rel}"
    assert int(ovf) == 0, f"K2 stack overflow count {int(ovf)}"

    # ---- 3c. K3 post tail: the full frame of a real render ----
    final = (gba.color * gba.albedo).contiguous()
    small = downsample4(downsample4(downsample4(final)))
    expo = auto_exposure(small, eng.state.exposure, 1 / 60, 1.0)
    par = tail_params(expo[0], 1.0, 2.2, 0.5, 0.37, dev)
    mask = dither_mask(dev)
    u8 = post_tail(final, par, mask, do_sharpen=True, do_dither=True)
    u8p = post_tail_plain(final, par, mask, do_sharpen=True, do_dither=True)
    torch.cuda.synchronize()
    du = (u8.int() - u8p.int()).abs()
    eq = (du.amax(-1) == 0).float().mean().item()
    print(f"K3 {W}x{H}: max |du8| {int(du.max())}, equal on {eq:.6f}")
    assert int(du.max()) <= 1 and eq >= 0.999, "K3 disagrees with plain"
    k3_ms, _ = _ms(lambda: post_tail(final, par, mask, do_sharpen=True,
                                     do_dither=True), 50)
    k3_plain, _ = _ms(lambda: post_tail_plain(
        final, par, mask, do_sharpen=True, do_dither=True), 5)
    print(f"K3 time, {W}x{H}: kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms "
          f"{card}")

    # ---- 4. main path ----
    cuda.reset_launch_counts()
    eng.overflow.zero_()
    for _ in range(WARMUP):
        img = eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        img = eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / TIMED * 1e3
    counts = dict(cuda.launch_counts)
    print(f"main path: {frame_ms:.2f} ms/frame over {TIMED} frames "
          f"(host clock around synchronize), {W}x{H} terrain, "
          f"{1e3 / frame_ms:.1f} fps {card}")
    print(f"launch counts over {WARMUP + TIMED} frames: {counts}")
    n_frames = WARMUP + TIMED
    # the main path launches K2 and K3 once per frame; K1's traversal runs
    # inside K2, so its standalone launcher stays at 0
    for k in ("megakernel_trace", "post_tail"):
        assert counts.get(k, 0) == n_frames, \
            f"{k} launched {counts.get(k, 0)} times"
    assert int(eng.overflow) == 0, f"stack overflow {int(eng.overflow)}"
    assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
    gb = eng.last_gbuffer
    for f in ("color", "albedo", "normal", "motion", "depth"):
        assert not torch.isnan(getattr(gb, f)).any(), f"NaN in G-buffer {f}"
    top = img[: H // 10].float().mean((0, 1))
    bottom = img[H // 2:].float().mean()
    print(f"image: top rows mean RGB {top.tolist()}, lower half mean "
          f"{bottom.item():.1f}")
    assert top.mean() > 100 and top[2] > top[0], "sky rows not bright blue"
    assert bottom > 10, "lower half is black"

    route = "cuda"
    # K1's launcher is checked and timed above but the frame does not
    # launch it: K2 runs K1's traversal (traverse.cuh) inside
    standalone = dict(
        name="K1 traverse (BVH4 per-thread stack)", route=route,
        source="rtrt_tpu_torch/csrc/traverse.cu",
        replaces="rtrt_tpu/bvh/packet.py:1104",
        launches=counts.get("packet_intersect", 0), max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain)
    print(f"standalone K1 launcher (its traversal runs inside K2): "
          f"{json.dumps(standalone)}")
    # the kernels the main path launches
    kernels = [
        dict(name="K2 megakernel (5-segment path trace, K1's traversal "
             "inside)", route=route,
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=counts["megakernel_trace"], max_abs_err=float(k2_err),
             ms=k2_ms, plain_ms=k2_plain),
        dict(name="K3 post tail (tonemap/sharpen/dither/u8)", route=route,
             source="rtrt_tpu_torch/csrc/post_tail.cu",
             replaces="rtrt_tpu/post/tail.py:177",
             launches=counts["post_tail"], max_abs_err=float(du.max()),
             ms=k3_ms, plain_ms=k3_plain),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
