# Frozen copy of rtrt_tpu_torch/render/megakernel.py
# (framebench's plain reference), cut to what framebench's frames reach.
"""The path tracer's bounce program (port of rtrt_tpu/render/megakernel.py):
K2's plain twin, over the port's traversal (bvh/packet.py).

Per pixel, SEGMENTS scene intersects; each traces one ray (closest hit, or
any-hit for a pending shadow ray) and runs `shade_segment`: shadow-ray
resolve, deferred escapes, material select + the textured materials'
procedural soil, emission, primary G-buffer capture, BSDF sample + sun
NEE with power-heuristic MIS, the stochastic single-ray shadow-or-scatter
choice, the glass inside flip and the 1e-3 ray offset along ng.  The
scene has no sphere lights.  `finish_gbuffer` is the deferred-environment
/ MIS / demodulation / motion-vector tail.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..bvh.packet import _resolve, overflow_counter, traverse_plain
from ..core.camera import motion_vector
from .bsdf import MAT_EMISSIVE
from .kshade import (V3, SunParamsC, _w, bn_rotate, eval_bsdf_c,
                     material_select_c, orient_normals_c,
                     pack_materials_rows, power_heuristic_c, sample_bsdf_c,
                     sample_sun_c, sampler_dims, sampler_table,
                     soil_shading_c, vdot, vlum, vwhere)
from .sampling import power_heuristic
from .sky import SUN_COS_THETA_MAX, env_radiance_fit, sun_pdf_dir

# scene intersects a path (the port's default RTRT_SEGMENTS)
SEGMENTS = 5
RADIANCE_CLAMP = 10.0  # firefly clamp on demodulated radiance


@dataclasses.dataclass
class SceneData:
    """What the path tracer reads about the scene: its tables (bvh.packet.
    TraceTables), materials (render.bsdf.Materials) and sky (render.sky.
    SkyMaps)."""

    tables: object
    materials: object
    sky: object


@dataclasses.dataclass
class GBuffer:
    """Per-pixel path-trace outputs, image shaped (H, W, ...)."""

    color: torch.Tensor   # albedo-demodulated radiance (..., 3)
    albedo: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3)
    depth: torch.Tensor   # (...) inf = sky
    motion: torch.Tensor  # (..., 2) uv motion vector
    mat_id: torch.Tensor  # (...) int32, -1 = sky


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
    rand2: object   # dim -> (u1, u2)
    hits: list | None = None  # [shaded, textured, sampled] counts or None


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
    if ctx.hits is not None:
        ctx.hits[0] += int(live.sum())
        ctx.hits[1] += int((textured & live).sum())
    if bool((textured & live).any()):
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
    if ctx.hits is not None:
        ctx.hits[2] += int(live.sum())

    u1b, u2b = ctx.rand2(2 + 2 * seg)
    ul1, ul2 = ctx.rand2(64 + 2 * seg)
    u_sel, _ = ctx.rand2(128 + 2 * seg)

    bs_wi, bs_weight, bs_pdf, bs_delta = sample_bsdf_c(
        mtype, albedo, rough, ior, f0, ns, wo, st.inside, u1b, u2b)
    rough_lane = live & ~bs_delta

    ls_wi, ls_rad, ls_pdf = sample_sun_c(ctx.sun, ul1, ul2)
    ls_dist = torch.full_like(ht, math.inf)
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


def megakernel_trace_plain(tables, mat_rows, sun_vec, frame_idx, org, dir,
                           cone, pixel_ids, *, bn, visits=None,
                           hits=None) -> MegaOut:
    """Torch twin of the JAX simulate_megakernel on the port's traversal,
    for rays with blue-noise offsets bn (..., 2).  The work this run's data
    needs, for a kernel's bound: visits, optional [node visits, leaf
    visits] over all segments (as in bvh.packet.traverse_plain); hits,
    optional [shaded, textured, sampled] counts: hits that reach the
    surface interaction (normals, material), those that evaluate the
    procedural soil, those that sample the BSDF and the lights (not
    emissive)."""
    lead = org.shape[:-1]
    overflow = overflow_counter(org.device)
    o, d, cone_f = _flat(org, 3), _flat(dir, 3), _flat(cone)
    frame = int(frame_idx) & 0xFFFFFFFF
    bnf = _flat(bn, 2)
    rows = dict(zip(sampler_dims(SEGMENTS),
                    sampler_table(frame, SEGMENTS).tolist()))
    sampler = lambda dim: bn_rotate(rows[dim], bnf[:, 0], bnf[:, 1])
    ctx = ShadeCtx(sun=SunParamsC(sun_vec), mat_rows=mat_rows,
                   rand2=sampler, hits=hits)
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


# the most rays a block of rows traces at once, so that the plain version's
# per-ray state fits the card
BLOCK_RAYS = 1 << 21


def megakernel_trace(tables, mat_rows, sun_vec, frame_idx, org, dir, cone,
                     pixel_ids, *, bn) -> MegaOut:
    """Trace full paths for image-shaped (h, w, 3) primary rays with the
    plain version, over blocks of rows of at most BLOCK_RAYS rays.
    mat_rows (M, 16) from pack_materials_rows; sun_vec (16,) from
    pack_sun_params; pixel_ids (h, w) int32; bn (h, w, 2) blue-noise
    offsets."""
    rows = max(1, BLOCK_RAYS // (org[0].numel() // 3))
    parts = []
    for r0 in range(0, org.shape[0], rows):
        cut = lambda x: x[r0:r0 + rows]
        parts.append(megakernel_trace_plain(
            tables, mat_rows, sun_vec, frame_idx, cut(org), cut(dir),
            cut(cone), cut(pixel_ids), bn=cut(bn)))
    return MegaOut(**{f.name: torch.cat([getattr(q, f.name) for q in parts])
                      for f in dataclasses.fields(MegaOut)})


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
                    bn) -> GBuffer:
    """Path-trace image-shaped rays over a SceneData (its materials and sun
    packed into K2's rows) and finish the G-buffer."""
    dev = rays.org.device
    out = megakernel_trace(
        scene.tables, pack_materials_rows(scene.materials).to(dev),
        pack_sun_params(scene.sky), frame_idx, rays.org.contiguous(),
        rays.dir.contiguous(), rays.cone_width.contiguous(),
        pixel_ids.to(torch.int32).contiguous(), bn=bn.contiguous())
    return finish_gbuffer(scene.sky, rays, out, prev_basis, aspect)
