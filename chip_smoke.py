#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rtrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device: the card's name and power limit, whether the port's native
     content library (built from rtrt_tpu_torch/content/native) loaded or
     its numpy twins ran;
  2. build: nvcc builds the five kernels of csrc/ from this checkout, one
     process per source, and prints ptxas' registers / spills per kernel;
  3. each kernel vs its plain PyTorch version on the card, on the 1080p
     terrain scene's tables and the full 1920x1080 frame's rays: K1
     traversal (the primary rays + any-hit rays from their hits toward a
     low sun), K2 megakernel (all 18 output planes, and the finished
     G-buffer colour), K3 post tail (the frame K2 rendered), K4 a-trous
     pass (that frame's G-buffer; the 7x7 pass at both parities and the
     5x5 passes at strides 3, 6, 12), K5 history reprojection (that
     frame's planes as bf16 history; a camera's motion and a synthetic
     field); each kernel and its plain version are timed at that shape,
     and each kernel's bound (bytes or operations, see `_bound`) is
     computed from this run's inputs;
  4. the first slice's path: Engine(terrain, 1920x1080,
     FeatureFlags(denoise=False, bloom=False, lens_flare=False)) renders 2
     warm-up and 5 timed frames; K2 and K3 must each read 7 launches;
  5. the main path: Engine(terrain, 1920x1080, FeatureFlags()) — denoised,
     bloomed, lens-flared — renders 3 warm-up and 10 timed frames of a
     slow yaw pan; launch counters are reset just before and must read K2
     13, K3 13, K4 52, K5 13 after (K1's traversal runs inside K2, so its
     own launcher reads 0); output, G-buffer, history, image and denoise
     checks;
  --profile adds 6: torch.profiler over 5 main-path frames (device busy
     time, launches per frame, top device ops).
Prints the card's name and power limit, the per-kernel JSON line, then as
its last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX nor of the JAX package.  Exits 1 when CUDA is not
available.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
WARMUP, TIMED = 3, 10
SLICE_WARMUP, SLICE_TIMED = 2, 5

# the card's peaks (H100 SXM data sheet, at its 700 W limit): device memory
# bytes per second, float32 operations per second outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
# float operations counted from the kernels' code (csrc/): a BVH4 node
# visit is 4 slab tests of 20 (6 sub, 6 mul, 4 min/max, 1 mul, 3 compares)
# plus the 5-comparator sort and the prune test; a leaf visit is 8
# Moller-Trumbore tests of 59; the post tail ~160 per pixel (tone map of 3
# channels, 3x3 sharpen with min/max clamp, dither); a K4 tap 21 (normal
# dot 5, max, pow, depth 4, exp, 3 weight products, 4 sums + 3 products)
# plus 10 per pixel; K5 ~280 per pixel (positions, 8 Catmull-Rom weights,
# 16 taps x 6 channels multiply-add, nearest and ok).  pow / exp count as
# one operation each, so each count is a lower bound.
NODE_OPS, LEAF_OPS, TAIL_OPS_PX = 86, 8 * 59, 160
K4_TAP_OPS, K4_PX_OPS, K5_PX_OPS = 21, 10, 280


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


def _bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _table_bytes(tables):
    return sum(getattr(tables, f).numel() * 4
               for f in ("nodes", "tris", "nrm", "ng", "mat"))


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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.content import native
    from rtrt_tpu_torch.core.camera import (camera_basis, make_camera,
                                            motion_vector)
    from rtrt_tpu_torch.denoise.reproject import reproject, reproject_plain
    from rtrt_tpu_torch.denoise.spatial import (edge_aware_pass,
                                                edge_aware_pass_plain)
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
        FeatureFlags, GlobalSettings, default_params

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
    print(f"native content library loaded: {native.available()} (built "
          f"from rtrt_tpu_torch/content/native; numpy twins otherwise)")

    # ---- 2. build ----
    cuda.library()
    info = cuda.build_info
    print(f"build: {info['seconds']:.2f} s (cached={info['cached']}) "
          f"-> {os.path.relpath(info['path'], REPO)} {card}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("  " + line.strip())

    # ---- scene (the first slice's Engine; no kernel runs in init) ----
    settings = GlobalSettings(scene="terrain", render_width=W,
                              render_height=H, texture_size=256,
                              dynamic_resolution=DynamicResolution(
                                  enabled=False))
    eng = Engine(settings, flags=FeatureFlags(denoise=False, bloom=False,
                                              lens_flare=False),
                 device="cuda")
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
    k1_visits = [0, 0]
    r = P.packet_intersect_plain(tables, org, dirs, visits=k1_visits)
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
    n_rays = org.shape[0]
    k1_bound = _bound(n_rays * (28 + 44) + _table_bytes(tables),
                      k1_visits[0] * NODE_OPS + k1_visits[1] * LEAF_OPS)
    print(f"K1 time, {W}x{H} primary rays: kernel {k1_ms:.3f} ms, plain "
          f"{k1_plain:.1f} ms; {k1_visits[0] / n_rays:.2f} node and "
          f"{k1_visits[1] / n_rays:.2f} leaf visits per ray; bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) {card}")

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
    k2_visits = [0, 0]
    b = M.megakernel_trace_plain(*args, n_lights=n_lights, bn=consts.bn,
                                 visits=k2_visits)
    k2_plain, _ = _ms(lambda: M.megakernel_trace_plain(
        *args, n_lights=n_lights, bn=consts.bn), 1)
    # bytes: rays, cone, pixel id, blue-noise pair in; 18 planes out.
    # Operations: the traversal of all 5 segments only (shading excluded)
    k2_bound = _bound(W * H * (40 + 72) + _table_bytes(tables),
                      k2_visits[0] * NODE_OPS + k2_visits[1] * LEAF_OPS)
    print(f"K2 time, {W}x{H}: kernel {k2_ms:.3f} ms, plain {k2_plain:.1f} "
          f"ms; {k2_visits[0] / (W * H):.2f} node and "
          f"{k2_visits[1] / (W * H):.2f} leaf visits per pixel over the "
          f"segments; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) {card}")
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
    k3_bound = _bound(W * H * (12 + 3), W * H * TAIL_OPS_PX)
    print(f"K3 time, {W}x{H}: kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms"
          f"; bound {k3_bound[0]:.4f} ms ({k3_bound[1]}) {card}")

    # ---- 3d. K4 a-trous pass: the G-buffer of the frame K2 rendered ----
    dp = default_params().denoise
    gb_in = (gba.color.contiguous(), gba.normal.contiguous(),
             gba.depth.contiguous(), gba.mat_id.contiguous(), dp)
    k4_err, k4_ms, k4_plain = 0.0, [], []
    passes = [("7x7 parity 0", 3, 1, True, 0), ("7x7 parity 1", 3, 1, True, 1),
              ("5x5 stride 3", 2, 3, False, 0),
              ("5x5 stride 6", 2, 6, False, 0),
              ("5x5 stride 12", 2, 12, False, 0)]
    for label, rad, stride, half, par in passes:
        kw = dict(radius=rad, stride=stride, half_taps=half, parity=par)
        got = edge_aware_pass(*gb_in, **kw)
        ref = edge_aware_pass_plain(*gb_in, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        within = ((err - 1e-4 * ref.abs()).amax(-1) <= 1e-5).float().mean()
        k4_err = max(k4_err, err.max().item())
        t_k, _ = _ms(lambda: edge_aware_pass(*gb_in, **kw), 20)
        t_p, _ = _ms(lambda: edge_aware_pass_plain(*gb_in, **kw), 3)
        if label != "7x7 parity 1":  # the four passes of a frame
            k4_ms.append(t_k)
            k4_plain.append(t_p)
        print(f"K4 {label}, {W}x{H}: within rtol 1e-4 + atol 1e-5 on "
              f"{within.item():.6f} of pixels, max abs err "
              f"{err.max().item():.3e}; kernel {t_k:.4f} ms, plain "
              f"{t_p:.3f} ms {card}")
        assert within.item() >= 0.999, f"K4 {label} agrees on {within}"
    k4_ms, k4_plain = sum(k4_ms) / 4, sum(k4_plain) / 4
    # per pass: 25 taps (the 7x7 half kernel keeps 25 of 49); colour,
    # normal, depth, material in (32 B) and colour out (12 B) per pixel
    k4_bound = _bound(W * H * 44, W * H * (25 * K4_TAP_OPS + K4_PX_OPS))
    print(f"K4 mean of a frame's four passes: kernel {k4_ms:.4f} ms, plain "
          f"{k4_plain:.3f} ms; bound {k4_bound[0]:.4f} ms ({k4_bound[1]}) "
          f"{card}")

    # ---- 3e. K5 reprojection: that frame's planes as bf16 history ----
    bf = lambda x: x.to(torch.bfloat16).contiguous()
    rng = np.random.default_rng(5)
    count = torch.from_numpy(rng.integers(0, 9, (H, W)).astype(
        np.float32)).to(dev)
    hist = (bf(gba.color), bf(gba.color * gba.albedo), bf(gba.depth),
            gba.mat_id.contiguous(), bf(count))
    cam = eng.camera
    prev = make_camera(pos=(cam.pos + torch.tensor([0.1, 0.0, 0.0],
                                                   device=dev)).tolist(),
                       yaw=float(cam.yaw) - 0.02, pitch=float(cam.pitch),
                       fov_y=float(cam.fov_y), device=dev)
    world = rays.org + rays.dir * torch.clamp(gba.depth, max=1e8)[..., None]
    mv_cam = motion_vector(camera_basis(prev), rays.uv, world, W / H)
    q = H // 4
    px = np.concatenate([rng.uniform(-1, 1, (q, W, 2)),
                         rng.uniform(-30, 30, (q, W, 2)),
                         rng.integers(-4, 4, (q, W, 2)) + 0.5,
                         rng.uniform(-0.6, 0.6, (H - 3 * q, W, 2)) * [W, H]])
    mv_syn = torch.from_numpy((px / [W, H]).astype(np.float32)).to(dev)
    k5_err = 0.0
    wide = lambda x: x.to(torch.float32)
    for label, mv in (("camera yaw 0.02 rad + 0.1 units", mv_cam),
                      ("synthetic field", mv_syn)):
        mv = mv.contiguous()
        got = reproject(*hist, mv)
        ref = reproject_plain(wide(hist[0]), wide(hist[1]), wide(hist[2]),
                              hist[3], wide(hist[4]), mv)
        torch.cuda.synchronize()
        fr = {}
        for f in ("color", "color2"):
            a_, b_ = getattr(got, f), getattr(ref, f)
            err = (a_ - b_).abs()
            k5_err = max(k5_err, err.max().item())
            fr[f] = ((err <= 1e-6 + 1e-5 * b_.abs()).all(-1)
                     ).float().mean().item()
        exact = {f: torch.equal(getattr(got, f), getattr(ref, f))
                 for f in ("depth", "count", "mat_id", "ok")}
        print(f"K5 {label}, {W}x{H}: colour within rtol 1e-5 + atol 1e-6 on "
              f"{fr}; exact {exact}; ok on {got.ok.float().mean().item():.4f}"
              f" of pixels")
        assert min(fr.values()) >= 0.9999, f"K5 {label} colour {fr}"
        assert all(exact.values()), f"K5 {label} nearest planes {exact}"
    k5_ms, _ = _ms(lambda: reproject(*hist, mv_cam), 20)
    k5_plain, _ = _ms(lambda: reproject_plain(
        wide(hist[0]), wide(hist[1]), wide(hist[2]), hist[3], wide(hist[4]),
        mv_cam), 3)
    # 8 bf16 planes + mat i32 + motion 2 x f32 in; 9 f32 planes + ok out
    k5_bound = _bound(W * H * (28 + 37), W * H * K5_PX_OPS)
    print(f"K5 time, {W}x{H}: kernel {k5_ms:.4f} ms, plain {k5_plain:.3f} ms"
          f"; bound {k5_bound[0]:.4f} ms ({k5_bound[1]}) {card}")

    # ---- 4. the first slice's path (denoiser, bloom, lens flare off) ----
    cuda.reset_launch_counts()
    eng.overflow.zero_()
    for _ in range(SLICE_WARMUP):
        eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SLICE_TIMED):
        eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    slice_ms = (time.perf_counter() - t0) / SLICE_TIMED * 1e3
    counts = dict(cuda.launch_counts)
    n_slice = SLICE_WARMUP + SLICE_TIMED
    print(f"slice-flags path: {slice_ms:.2f} ms/frame over {SLICE_TIMED} "
          f"frames (host clock around synchronize), {W}x{H} terrain {card}")
    print(f"launch counts over {n_slice} slice-flag frames: {counts}")
    for k in ("megakernel_trace", "post_tail"):
        assert counts[k] == n_slice, f"{k} launched {counts[k]} times"
    assert int(eng.overflow) == 0, f"stack overflow {int(eng.overflow)}"
    del eng

    # ---- 5. the main path: default FeatureFlags(), a slow yaw pan ----
    main = Engine(settings, flags=FeatureFlags(), device="cuda")
    cam0 = main.camera

    def pan(k):  # on the device: no host sync
        main.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    cuda.reset_launch_counts()
    main.overflow.zero_()
    for k in range(WARMUP):
        pan(k)
        img = main.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WARMUP, WARMUP + TIMED):
        pan(k)
        img = main.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / TIMED * 1e3
    counts = dict(cuda.launch_counts)
    n_frames = WARMUP + TIMED
    print(f"main path (default FeatureFlags, denoised): {frame_ms:.2f} "
          f"ms/frame over {TIMED} frames (host clock around synchronize), "
          f"{W}x{H} terrain, {1e3 / frame_ms:.1f} fps; slice flags "
          f"{slice_ms:.2f} ms/frame in this run {card}")
    print(f"launch counts over {n_frames} frames: {counts}")
    want = dict(megakernel_trace=n_frames, post_tail=n_frames,
                denoise_wide=4 * n_frames, reproject=n_frames,
                packet_intersect=0)
    for k, n in want.items():
        assert counts[k] == n, f"{k} launched {counts[k]} times, not {n}"
    assert int(main.overflow) == 0, f"stack overflow {int(main.overflow)}"
    assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
    gb = main.last_gbuffer
    for f in ("color", "albedo", "normal", "motion", "depth"):
        assert not torch.isnan(getattr(gb, f)).any(), f"NaN in G-buffer {f}"
    hist = main.state.history
    assert hist.valid
    for f in ("color", "color2", "depth", "count"):
        assert not torch.isnan(getattr(hist, f).float()).any(), \
            f"NaN in history {f}"
    top = img[: H // 10].float().mean((0, 1))
    bottom = img[H // 2:].float().mean()
    print(f"image: top rows mean RGB {top.tolist()}, lower half mean "
          f"{bottom.item():.1f}")
    assert top.mean() > 100 and top[2] > top[0], "sky rows not bright blue"
    assert bottom > 10, "lower half is black"

    # denoise sanity: luminance variance inside 8x8 tiles of the lower half,
    # denoised colour (the history's pass-2 colour) vs the raw 1-spp colour
    def tile_var(c):
        lum = (c[H // 2:H // 2 + (H // 2) // 8 * 8, : W // 8 * 8].float()
               * torch.tensor([0.2126, 0.7152, 0.0722], device=dev)).sum(-1)
        t = lum.reshape(lum.shape[0] // 8, 8, W // 8, 8)
        return t.var(dim=(1, 3)).mean().item()

    v_raw = tile_var(gb.color * gb.albedo)
    v_den = tile_var(hist.color2)
    print(f"denoise: mean 8x8-tile luminance variance of the lower half, raw "
          f"{v_raw:.4e}, denoised {v_den:.4e}")
    assert v_den < v_raw, "the denoised frame is not smoother than the raw"

    if "--profile" in sys.argv[1:]:
        _profile(main, pan, card)

    route = "cuda"
    kernels = [
        dict(name="K1 traverse (BVH4 per-thread stack; on the main path its "
             "traversal runs inside K2, so its own launcher reads 0)",
             route=route, source="rtrt_tpu_torch/csrc/traverse.cu",
             replaces="rtrt_tpu/bvh/packet.py:1104",
             launches=counts["packet_intersect"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound[0],
             bound_by=k1_bound[1], library_ms=None),
        dict(name="K2 megakernel (5-segment path trace, K1's traversal "
             "inside)", route=route,
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=counts["megakernel_trace"], max_abs_err=float(k2_err),
             ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        dict(name="K3 post tail (tonemap/sharpen/dither/u8)", route=route,
             source="rtrt_tpu_torch/csrc/post_tail.cu",
             replaces="rtrt_tpu/post/tail.py:177",
             launches=counts["post_tail"], max_abs_err=float(du.max()),
             ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=None),
        dict(name="K4 denoise a-trous pass (7x7 half kernel, 5x5 at strides "
             "3/6/12; ms per pass)", route=route,
             source="rtrt_tpu_torch/csrc/denoise_wide.cu",
             replaces="rtrt_tpu/denoise/spatial.py:265",
             launches=counts["denoise_wide"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound[0],
             bound_by=k4_bound[1], library_ms=None),
        dict(name="K5 history reprojection (Catmull-Rom + nearest, bf16 "
             "history)", route=route,
             source="rtrt_tpu_torch/csrc/reproject.cu",
             replaces="rtrt_tpu/denoise/reproject.py:244",
             launches=counts["reproject"], max_abs_err=k5_err,
             ms=k5_ms, plain_ms=k5_plain, bound_ms=k5_bound[0],
             bound_by=k5_bound[1], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _profile(eng, pan, card, frames=5):
    """torch.profiler over `frames` main-path frames: device busy time and
    kernel launches per frame, the top device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for k in range(frames):
            pan(100 + k)
            eng.render_frame_device(dt=1 / 60)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    # device-side events (kernels, memcpy, memset) only: the CPU-side op
    # rows carry the same device time again
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy = sum(dev_t(e) for e in kern) / frames / 1e3
    launches = sum(e.count for e in avg if "LaunchKernel" in e.key) / frames
    syncs = sum(e.count for e in avg if "Synchronize" in e.key) / frames
    items = sum(e.count for e in avg
                if e.key == "aten::_local_scalar_dense") / frames
    print(f"profile over {frames} main-path frames: device busy "
          f"{busy:.3f} ms/frame, {launches:.1f} kernel launches/frame, "
          f"{syncs:.1f} synchronize calls/frame, {items:.1f} device-to-host "
          f"scalar reads/frame {card}")
    top = sorted(kern, key=dev_t, reverse=True)[:15]
    for e in top:
        calls = e.count // frames
        print(f"  {dev_t(e) / frames / 1e3:8.3f} ms/frame  {calls:5d} "
              f"calls/frame  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
