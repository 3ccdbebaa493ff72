"""Path-trace megakernel: the whole bounce program of a pixel in one launch —
kernel K2 and its plain twin (port of rtrt_tpu/render/megakernel.py).

Per pixel, SEGMENTS scene intersects; each traces one ray (closest hit, or
any-hit for a pending shadow ray) and runs `shade_segment`: shadow-ray
resolve, sphere-light hits, deferred escapes, material select + procedural
soil, emission, primary G-buffer capture, BSDF sample + sun/sphere NEE with
power-heuristic MIS, the stochastic single-ray shadow-or-scatter choice,
the glass inside flip and the 1e-3 ray offset along ng.

  * `megakernel_trace` launches, for CUDA tensors, K2
    (csrc/megakernel.cu), which traces every segment with K1's device
    function (csrc/traverse.cuh); for CPU tensors it runs
    `megakernel_trace_plain`;
  * `megakernel_trace_plain` is the torch twin of the JAX
    `simulate_megakernel`, on the port's traversal (bvh/packet.py);
  * `finish_gbuffer` is the deferred-environment / MIS / demodulation /
    motion-vector tail shared by both.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..bvh.packet import (_check_tables, _resolve, overflow_counter,
                          traverse_plain)
from ..core.camera import motion_vector
from ..utils import cuda
from .bsdf import MAT_EMISSIVE
from .integrator import RADIANCE_CLAMP, GBuffer
from .kshade import (LIGHT_ROW, V3, SunParamsC, _w, eval_bsdf_c,
                     material_select_c, orient_normals_c,
                     pack_materials_rows, power_heuristic_c, rand2_bn_c,
                     rand2_c, ray_sphere_c, sample_bsdf_c,
                     sample_sphere_light_c, sample_sun_c, soil_shading_c,
                     sphere_lights_pdf_c, vdot, vlum, vwhere)
from .light import sun_pdf_dir
from .sampling import power_heuristic
from .sky import (SUN_COS_THETA_MAX, SUN_DISK_OMEGA, SUN_DISK_PDF,
                  SUN_SIN2_MAX, env_radiance_fit)

SEGMENTS = 5  # scene intersects per pixel


@dataclasses.dataclass
class PathState:
    """Per-lane path state (component tensors of one shape)."""

    org: V3
    dir: V3
    beta: V3
    radiance: V3
    done: torch.Tensor
    is_shadow: torch.Tensor
    pending: V3
    shadow_tmax: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    inside: torch.Tensor
    cone: torch.Tensor
    esc_dir: V3
    esc_beta: V3
    esc_pdf: torch.Tensor
    esc_delta: torch.Tensor
    albedo: V3
    normal: V3
    depth: torch.Tensor
    mat_id: torch.Tensor
    got_primary: torch.Tensor


@dataclasses.dataclass
class MegaOut:
    """Megakernel outputs with the ray array's leading shape."""

    radiance: torch.Tensor  # (...,3) pre-environment path radiance
    albedo: torch.Tensor    # (...,3)
    normal: torch.Tensor    # (...,3)
    depth: torch.Tensor     # (...)  inf = sky
    mat_id: torch.Tensor    # (...)  i32 (-1 = sky)
    esc_dir: torch.Tensor   # (...,3)
    esc_beta: torch.Tensor  # (...,3) throughput at escape (0 if none)
    esc_pdf: torch.Tensor   # (...)  BSDF pdf at escape; -1 marks delta


@dataclasses.dataclass
class ShadeCtx:
    sun: SunParamsC
    mat_rows: torch.Tensor
    light_rows: torch.Tensor
    n_lights: int
    use_proctex: bool
    rand2: object   # dim -> (u1, u2)


def init_state(org: V3, dir: V3, cone) -> PathState:
    zf = lambda: torch.zeros_like(cone)
    z3 = lambda: V3(zf(), zf(), zf())
    one3 = lambda: V3(*(torch.ones_like(cone) for _ in range(3)))
    f = lambda: torch.zeros_like(cone, dtype=torch.bool)
    t = lambda: torch.ones_like(cone, dtype=torch.bool)
    return PathState(
        org=org, dir=dir, beta=one3(), radiance=z3(), done=f(), is_shadow=f(),
        pending=z3(), shadow_tmax=torch.full_like(cone, math.inf),
        prev_pdf=zf(), prev_delta=t(), inside=f(), cone=cone, esc_dir=dir,
        esc_beta=z3(), esc_pdf=zf(), esc_delta=t(), albedo=one3(),
        normal=z3(), depth=torch.full_like(cone, math.inf),
        mat_id=torch.full_like(cone, -1, dtype=torch.int64),
        got_primary=f())


def shade_segment(st: PathState, hit, ctx: ShadeCtx, seg: int,
                  is_last: bool) -> PathState:
    """One bounce of shading over component tensors (mirror of the JAX
    megakernel.shade_segment).  hit: (t, tri, mat, ns V3, ng V3)."""
    ht, tri, hmat, hns, hng = hit
    zero3 = V3(0.0, 0.0, 0.0)
    active = ~st.done
    found = (tri >= 0) & active

    # shadow-ray resolution
    sh = st.is_shadow & active
    unocc = sh & ~(tri >= 0)
    radiance = vwhere(unocc, st.radiance + st.pending, st.radiance)
    done = st.done | sh

    # analytic sphere-light hits (scatter rays)
    if ctx.n_lights > 0:
        lt = torch.full_like(ht, math.inf)
        lem = zero3
        for li in range(ctx.n_lights):
            row = ctx.light_rows[li]
            hl, tl = ray_sphere_c(st.org, st.dir, V3(row[0], row[1], row[2]),
                                  row[3])
            closer = hl & (tl < lt)
            lt = torch.where(closer, tl, lt)
            lem = vwhere(closer, V3(row[4], row[5], row[6]), lem)
        lhit = active & ~sh & (lt < ht)
        lpdf = sphere_lights_pdf_c(ctx.light_rows, ctx.n_lights, st.org,
                                   st.dir)
        w_l = _w(st.prev_delta, 1.0, power_heuristic_c(st.prev_pdf,
                                                       0.5 * lpdf))
        radiance = vwhere(lhit, radiance + st.beta * lem * w_l, radiance)
        done = done | lhit

    # escaped scatter rays: defer the environment
    esc = active & ~sh & ~(tri >= 0)
    esc_dir = vwhere(esc, st.dir, st.esc_dir)
    esc_beta = vwhere(esc, st.beta, st.esc_beta)
    esc_pdf = torch.where(esc, st.prev_pdf, st.esc_pdf)
    esc_delta = torch.where(esc, st.prev_delta, st.esc_delta)
    done = done | esc

    live = found & ~sh & ~done
    st = dataclasses.replace(st, radiance=radiance, done=done,
                             esc_dir=esc_dir, esc_beta=esc_beta,
                             esc_pdf=esc_pdf, esc_delta=esc_delta)
    if is_last:
        return dataclasses.replace(st, done=done | live)

    # surface interaction
    wo = -st.dir
    ts = torch.clamp(ht, 0.0, 1e8)
    pos = st.org + st.dir * ts
    cone_w = st.cone * ts
    ns, ng = orient_normals_c(hns, hng, wo)
    mtype, albedo, rough, ior, f0, emission, textured = material_select_c(
        ctx.mat_rows, hmat)
    if ctx.use_proctex and bool((textured & live).any()):
        tex_alb, tex_rough, ns_tex = soil_shading_c(pos, ns, cone_w)
        albedo = vwhere(textured, albedo * tex_alb, albedo)
        rough = torch.where(textured, tex_rough, rough)
        ns = vwhere(textured, ns_tex, ns)

    emissive = live & (mtype == MAT_EMISSIVE)
    radiance = vwhere(emissive, st.radiance + st.beta * emission,
                      st.radiance)
    done = done | emissive
    live = live & ~emissive

    # primary-hit G-buffer capture
    first = live & ~st.got_primary
    alb_c = V3(torch.clamp(albedo.x, min=1e-3),
               torch.clamp(albedo.y, min=1e-3),
               torch.clamp(albedo.z, min=1e-3))
    normal = vwhere(first, ns, st.normal)
    depth = torch.where(first, ht, st.depth)
    mat_id = torch.where(first, hmat.to(torch.int64), st.mat_id)
    alb_g = vwhere(first, alb_c, st.albedo)
    got_primary = st.got_primary | live

    u1b, u2b = ctx.rand2(2 + 2 * seg)
    ul1, ul2 = ctx.rand2(64 + 2 * seg)
    u_sel, _ = ctx.rand2(128 + 2 * seg)

    bs_wi, bs_weight, bs_pdf, bs_delta = sample_bsdf_c(
        mtype, albedo, rough, ior, f0, ns, wo, st.inside, u1b, u2b)
    rough_lane = live & ~bs_delta

    ls_wi, ls_rad, ls_pdf = sample_sun_c(ctx.sun, ul1, ul2)
    ls_dist = torch.full_like(ht, math.inf)
    if ctx.n_lights > 0:
        nl = ctx.n_lights
        p1, p2 = ctx.rand2(192 + 2 * seg)
        li = torch.clamp((p1 * nl).to(torch.int64), 0, nl - 1)
        sp_wi, sp_rad, sp_pdf, sp_dist = sample_sphere_light_c(
            ctx.light_rows, nl, li, pos, ul1, ul2)
        use_sphere = p2 < 0.5
        ls_wi = vwhere(use_sphere, sp_wi, ls_wi)
        ls_rad = vwhere(use_sphere, sp_rad, ls_rad)
        ls_pdf = torch.where(use_sphere, 0.5 * sp_pdf / nl, 0.5 * ls_pdf)
        ls_dist = torch.where(use_sphere, sp_dist, ls_dist)

    f_l, pdf_b_at_l = eval_bsdf_c(mtype, albedo, rough, f0, ns, wo, ls_wi)
    cos_l = torch.clamp(vdot(ns, ls_wi), min=0.0)
    w_l2 = power_heuristic_c(ls_pdf, pdf_b_at_l)
    scale_l = (cos_l / torch.clamp(ls_pdf, min=1e-8)) * w_l2
    c_light = st.beta * f_l * ls_rad * scale_l
    c_light = vwhere(ls_pdf > 1e-8, c_light, zero3)

    # stochastic single-ray selection
    est_l = vlum(c_light)
    est_s = vlum(st.beta * bs_weight)
    q = _w(est_l + est_s > 0.0,
           est_l / torch.clamp(est_l + est_s, min=1e-12), 0.0)
    q = torch.clamp(q, 0.0, 0.9)
    take_shadow = rough_lane & (u_sel < q) & (est_l > 0.0)

    pending = vwhere(take_shadow,
                     c_light * (1.0 / torch.clamp(q, min=1e-3)), zero3)
    shadow_tmax = _w(take_shadow, ls_dist, math.inf)

    scatter = live & ~take_shadow
    inv_p = _w(rough_lane, 1.0 / torch.clamp(1.0 - q, min=1e-3), 1.0)
    beta = vwhere(scatter, st.beta * bs_weight * inv_p, st.beta)
    prev_pdf = torch.where(scatter, bs_pdf, st.prev_pdf)
    prev_delta = torch.where(scatter, bs_delta, st.prev_delta)

    crossed = scatter & (vdot(bs_wi, ng) < 0.0)
    inside = torch.where(crossed, ~st.inside, st.inside)

    new_dir = vwhere(take_shadow, ls_wi, bs_wi)
    off = vwhere(vdot(new_dir, ng) >= 0.0, ng * 1e-3, ng * (-1e-3))
    org = vwhere(live, pos + off, st.org)
    dir = vwhere(live, new_dir, st.dir)
    cone = torch.where(live, cone_w, st.cone)

    done = done | (live & ~take_shadow & (vlum(beta) < 1e-5))
    return PathState(org=org, dir=dir, beta=beta, radiance=radiance,
                     done=done, is_shadow=take_shadow, pending=pending,
                     shadow_tmax=shadow_tmax, prev_pdf=prev_pdf,
                     prev_delta=prev_delta, inside=inside, cone=cone,
                     esc_dir=st.esc_dir, esc_beta=st.esc_beta,
                     esc_pdf=st.esc_pdf, esc_delta=st.esc_delta,
                     albedo=alb_g, normal=normal, depth=depth,
                     mat_id=mat_id, got_primary=got_primary)


def pack_light_rows(lights, device) -> torch.Tensor:
    """SphereLights -> (L, LIGHT_ROW) f32 rows [cx cy cz r ex ey ez pad]
    (None -> one zero row)."""
    if lights is None:
        return torch.zeros((1, LIGHT_ROW), device=device)
    nl = lights.center.shape[0]
    return torch.cat([lights.center.float(), lights.radius.float()[:, None],
                      lights.emission.float(),
                      torch.zeros((nl, 1), device=lights.center.device)],
                     dim=1).to(device).contiguous()


def pack_sun_params(sky) -> torch.Tensor:
    """SkyMaps -> (16,) f32 sun vector [dir, t, b, trans, intensity,
    cos_theta_max, 0, 0].  Kernels take the disk constants from the
    host-folded float64 values instead of slot 13."""
    dev = sky.sun_dir.device
    return torch.cat([
        sky.sun_dir.float(), sky.sun_basis_t.float(),
        sky.sun_basis_b.float(), sky.sun_trans.float(),
        sky.params.sun_intensity.float().reshape(1),
        torch.full((1,), SUN_COS_THETA_MAX, device=dev),
        torch.zeros(2, device=dev)]).contiguous()


def _flat(x, k=None):
    return x.reshape(-1) if k is None else x.reshape(-1, k)


def megakernel_trace_plain(tables, mat_rows, light_rows, sun_vec, frame_idx,
                           org, dir, cone, pixel_ids, *, n_lights,
                           use_proctex=True, bn=None, overflow=None,
                           visits=None) -> MegaOut:
    """Torch twin of the JAX simulate_megakernel on the port's traversal
    (visits: optional [node visits, leaf visits] counts over all segments,
    as in bvh.packet.traverse_plain)."""
    lead = org.shape[:-1]
    if overflow is None:
        overflow = overflow_counter(org.device)
    o, d, cone_f = _flat(org, 3), _flat(dir, 3), _flat(cone)
    frame = int(frame_idx) & 0xFFFFFFFF
    if bn is not None:
        bnf = _flat(bn, 2)
        sampler = lambda dim: rand2_bn_c(bnf[:, 0], bnf[:, 1], frame, dim)
    else:
        pix = _flat(pixel_ids).to(torch.int64)
        sampler = lambda dim: rand2_c(pix, frame, dim)
    ctx = ShadeCtx(sun=SunParamsC(sun_vec), mat_rows=mat_rows,
                   light_rows=light_rows, n_lights=n_lights,
                   use_proctex=use_proctex, rand2=sampler)
    st = init_state(V3(o[:, 0], o[:, 1], o[:, 2]),
                    V3(d[:, 0], d[:, 1], d[:, 2]), cone_f)
    for seg in range(SEGMENTS):
        t_cap = torch.where(st.done, 0.0,
                            _w(st.is_shadow, st.shadow_tmax, math.inf))
        fh = st.is_shadow & ~st.done
        ro = torch.stack(list(st.org), dim=1)
        rd = torch.stack(list(st.dir), dim=1)
        t, tri, u, v = traverse_plain(tables, ro, rd, t_cap, fh, overflow,
                                      visits)
        h = _resolve(tables, t, tri, u, v)
        hit = (h.t, h.tri, h.mat, V3(*h.ns.unbind(1)), V3(*h.ng.unbind(1)))
        st = shade_segment(st, hit, ctx, seg, is_last=(seg == SEGMENTS - 1))

    s3 = lambda v: torch.stack(list(v), dim=-1).reshape(lead + (3,))
    s1 = lambda x: x.reshape(lead)
    return MegaOut(
        radiance=s3(st.radiance), albedo=s3(st.albedo), normal=s3(st.normal),
        depth=s1(st.depth), mat_id=s1(st.mat_id.to(torch.int32)),
        esc_dir=s3(st.esc_dir), esc_beta=s3(st.esc_beta),
        esc_pdf=s1(torch.where(st.esc_delta, -1.0, st.esc_pdf)))


def megakernel_trace(tables, mat_rows, light_rows, sun_vec, frame_idx, org,
                     dir, cone, pixel_ids, *, n_lights, use_proctex=True,
                     bn=None, overflow=None) -> MegaOut:
    """Trace full paths for image-shaped (..., 3) primary rays.  CPU tensors
    run the plain version; CUDA tensors launch K2 (csrc/megakernel.cu).

    mat_rows (M, 16) from pack_materials_rows; light_rows (L, 8) from
    pack_light_rows with n_lights real rows; sun_vec (16,) from
    pack_sun_params; pixel_ids (...) int32; bn (..., 2) blue-noise
    offsets or None; overflow (1,) int32 counter of dropped stack pushes."""
    if org.device.type == "cpu":
        return megakernel_trace_plain(
            tables, mat_rows, light_rows, sun_vec, frame_idx, org, dir, cone,
            pixel_ids, n_lights=n_lights, use_proctex=use_proctex, bn=bn,
            overflow=overflow)
    dev = org.device
    lead = tuple(org.shape[:-1])
    n = math.prod(lead)
    if overflow is None:
        overflow = overflow_counter(dev)
    specs = dict(org=(org, torch.float32, lead + (3,)),
                 dir=(dir, torch.float32, lead + (3,)),
                 cone=(cone, torch.float32, lead),
                 pixel_ids=(pixel_ids, torch.int32, lead),
                 mat_rows=(mat_rows, torch.float32, (mat_rows.shape[0], 16)),
                 light_rows=(light_rows, torch.float32,
                             (max(n_lights, 1), LIGHT_ROW)),
                 sun_vec=(sun_vec, torch.float32, (16,)),
                 overflow=(overflow, torch.int32, (1,)))
    if bn is not None:
        specs["bn"] = (bn, torch.float32, lead + (2,))
    cuda.check_tensors(dev, **specs)
    _check_tables(tables, dev)
    out = torch.empty((18, n), dtype=torch.float32, device=dev)
    cuda.launch(
        cuda.library().rtrt_megakernel, "megakernel_trace", dev,
        tables.nodes, tables.tris, tables.nrm, tables.ng, tables.mat,
        mat_rows, ctypes.c_int(mat_rows.shape[0]), light_rows,
        ctypes.c_int(n_lights), sun_vec,
        ctypes.c_float(SUN_COS_THETA_MAX), ctypes.c_float(SUN_SIN2_MAX),
        ctypes.c_float(SUN_DISK_OMEGA), ctypes.c_float(SUN_DISK_PDF),
        ctypes.c_uint(int(frame_idx) & 0xFFFFFFFF), org, dir, cone,
        pixel_ids, bn if bn is not None else ctypes.c_void_p(0),
        ctypes.c_int(int(bn is not None)), ctypes.c_int(int(use_proctex)),
        ctypes.c_int(n), out, overflow)
    p = out.reshape((18,) + lead)
    s3 = lambda k: p[k:k + 3].movedim(0, -1)
    return MegaOut(radiance=s3(0), albedo=s3(3), normal=s3(6), depth=p[9],
                   mat_id=p[10].to(torch.int32), esc_dir=s3(11),
                   esc_beta=s3(14), esc_pdf=p[17])


def finish_gbuffer(sky, rays, out: MegaOut, prev_basis, aspect) -> GBuffer:
    """Deferred environment resolve + MIS weight + albedo demodulation +
    motion vectors."""
    env = env_radiance_fit(sky, out.esc_dir)
    lpdf = sun_pdf_dir(sky, out.esc_dir)
    w_env = _w(out.esc_pdf < 0.0, 1.0,
               power_heuristic(1.0, out.esc_pdf, 1.0, lpdf))
    radiance = out.radiance + out.esc_beta * env * w_env[..., None]
    safe_albedo = torch.clamp(out.albedo, min=1e-3)
    color = torch.clamp(radiance, 0.0, RADIANCE_CLAMP) / safe_albedo
    mv = motion_vector(prev_basis, rays.uv,
                       rays.org + rays.dir
                       * torch.clamp(out.depth, max=1e8)[..., None], aspect)
    return GBuffer(color=color, albedo=out.albedo, normal=out.normal,
                   depth=out.depth, motion=mv, mat_id=out.mat_id)


def path_trace_mega(scene, rays, pixel_ids, frame_idx, prev_basis, aspect,
                    use_proctex: bool = True, bn=None,
                    overflow=None) -> GBuffer:
    """Path-trace image-shaped rays through the megakernel and finish the
    G-buffer.  scene: render.integrator.SceneData."""
    dev = rays.org.device
    mat_rows = pack_materials_rows(scene.materials).to(dev)
    light_rows = pack_light_rows(scene.lights, dev)
    n_lights = 0 if scene.lights is None else scene.lights.center.shape[0]
    out = megakernel_trace(
        scene.tables, mat_rows, light_rows, pack_sun_params(scene.sky),
        frame_idx, rays.org.contiguous(), rays.dir.contiguous(),
        rays.cone_width.contiguous(), pixel_ids.to(torch.int32).contiguous(),
        n_lights=n_lights, use_proctex=use_proctex,
        bn=None if bn is None else bn.contiguous(), overflow=overflow)
    return finish_gbuffer(scene.sky, rays, out, prev_basis, aspect)
