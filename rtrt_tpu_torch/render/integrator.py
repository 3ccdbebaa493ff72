"""The wavefront path tracer (port of rtrt_tpu/render/integrator.py): 1 spp,
a fixed program of SEGMENTS scene intersects per pixel, the state of every
path held as (N, ...) tensors between them.

Each segment traces every lane once and shades the hits with torch ops:
  * finished lanes trace with t_max = 0 (no hit) and pending shadow rays
    with their light's distance (inf toward the sun); a shadow ray that
    escapes adds its pending contribution and ends the path;
  * sphere lights nearer than the hit end a scatter ray with MIS weight;
    escaped scatter rays record direction, throughput and pdf, and ONE
    environment evaluation runs after the loop;
  * a hit resolves its material: textured materials take the procedural
    soil (render/proctex.py) or, with use_proctex=False, the mip /
    triplanar gather of the soil texture set (render/texture.py);
  * the first surface hit writes the G-buffer (normal, depth, material,
    albedo); each rough hit samples the BSDF and the light (sun NEE,
    50/50 with the sphere lights where the scene has them) and goes on
    along ONE of them, chosen by their estimates (power-heuristic MIS),
    the shadow ray's contribution waiting for the next segment's trace.

Two traversal routes, chosen by the caller:
  * use_packets=True: K1 (bvh/packet.py::packet_intersect) on the scene's
    TraceTables, whatever tree they hold (BVH4, LBVH, flat SAH), one launch
    a segment for CUDA tensors, its plain version for CPU tensors; the
    hit's shading normal, geometric normal and material come with it;
  * use_packets=False: the loop traverser (bvh/traverse.py::
    intersect_scene) on the scene's SceneBvh, plain torch on any device,
    with the surface attributes gathered from the sorted tables.
The megakernel (render/megakernel.py, K2) runs the same program for a
pixel in one launch; the JAX package's CPU frame runs this one."""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..bvh.packet import packet_intersect
from ..bvh.traverse import MAX_TRAVERSAL_STEPS, intersect_scene
from ..core.camera import motion_vector
from ..core.color import luminance
from ..core.geometry import ray_sphere
from ..core.vecmath import cross, dot, normalize
from .bsdf import MAT_EMISSIVE, eval_bsdf, material_lookup, sample_bsdf
from .light import sample_sphere_light, sample_sun, sun_pdf_dir
from .proctex import soil_shading
from .sampling import power_heuristic, rand2, rand2_bn, uniform_cone_pdf
from .sky import env_radiance_fit
from .texture import apply_normal_map, triplanar_sample

# scene intersects per pixel; RTRT_SEGMENTS overrides, as in the JAX
# modules.  The port reads it here only: the megakernel route
# (render/megakernel.py, engine/frame.py) imports this value and takes 1 to
# 5 of it (megakernel.check_segments)
SEGMENTS = int(os.environ.get("RTRT_SEGMENTS", "5"))
RADIANCE_CLAMP = 10.0  # firefly clamp on demodulated radiance


@dataclasses.dataclass
class SceneData:
    """Everything the path tracer reads about the scene, in sorted-slot
    triangle order.  The megakernel and the packet route read `tables`;
    the loop route reads `bvh`, `tri_nrm_t` and `tri_mat`; the wavefront's
    gather texturing (use_proctex=False) reads `textures`."""

    tables: object            # bvh.packet.TraceTables
    materials: object         # render.bsdf.Materials
    sky: object               # render.sky.SkyMaps
    lights: object = None     # render.light.SphereLights or None
    bvh: object = None        # bvh.types.SceneBvh of the loop route: the
    #   tables' tree (the flat SAH tree that a BVH4 collapses, or the same
    #   binary tree), whose leaf entries cover tables.leaf_width slots
    tri_nrm_t: torch.Tensor = None  # (9, P) sorted vertex normals
    tri_mat: torch.Tensor = None    # (P,) int32 sorted materials
    textures: object = None   # render.texture.SoilTextures


@dataclasses.dataclass
class GBuffer:
    """Per-pixel path-trace outputs: image shaped (H, W, ...) from a frame,
    flat (N, ...) from `path_trace`."""

    color: torch.Tensor   # albedo-demodulated radiance (..., 3)
    albedo: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3)
    depth: torch.Tensor   # (...) inf = sky
    motion: torch.Tensor  # (..., 2) uv motion vector
    mat_id: torch.Tensor  # (...) int32, -1 = sky


def _sphere_lights_pdf(lights, org, d):
    """Solid-angle pdf that sphere-light NEE draws direction d from org (a
    uniform pick among the lights times the cone pdf)."""
    nl = lights.center.shape[0]
    pdf = torch.zeros(d.shape[:-1], device=d.device)
    for li in range(nl):
        to_c = lights.center[li] - org
        d2 = torch.clamp((to_c * to_c).sum(-1), min=1e-8)
        cos_max = torch.sqrt(1.0 - torch.clamp(
            lights.radius[li] ** 2 / d2, 0.0, 0.9999))
        cosg = (d * to_c / torch.sqrt(d2)[..., None]).sum(-1)
        pdf = pdf + torch.where(cosg > cos_max, uniform_cone_pdf(cos_max)
                                / nl, torch.zeros_like(pdf))
    return pdf


def _orient_normals(ns_raw, ng_raw, wo):
    """Normalise the shading and geometric normals and turn both to wo's
    side (the shading normal falls back to the geometric one where it
    faces away from wo)."""
    ng = normalize(ng_raw)
    ns = normalize(ns_raw)
    flip = torch.sign(dot(ng, wo))[..., None]
    flip = torch.where(flip == 0.0, 1.0, flip)
    ng = ng * flip
    ns = ns * torch.sign(dot(ns, ng))[..., None]
    ns = torch.where(dot(ns, wo)[..., None] > 0.0, ns, ng)
    return ns, ng


def _fetch_surface_fallback(scene: SceneData, tri, u, v):
    """The loop route's surface fetch: (shading normal, geometric normal,
    material) of the hit slots, gathered from the sorted tables."""
    t = torch.clamp(tri, min=0).to(torch.int64)
    n = scene.tri_nrm_t[:, t]
    w = (1.0 - u - v)[..., None]
    ns_raw = w * n[0:3].T + u[..., None] * n[3:6].T + v[..., None] * n[6:9].T
    vt = scene.bvh.tris_t[:, t]
    v0, v1, v2 = vt[0:3].T, vt[3:6].T, vt[6:9].T
    return ns_raw, cross(v1 - v0, v2 - v0), scene.tri_mat[t]


def _material_at(scene: SceneData, mat, pos, ns, cone_width,
                 use_proctex: bool):
    """Material parameters of the hits; textured materials take the
    procedural soil, or the soil texture set's mip / triplanar gather."""
    mtype, albedo, rough, ior, f0, emission, textured = material_lookup(
        scene.materials, mat)
    if use_proctex:
        tex_alb, tex_rough, ns_tex = soil_shading(pos, ns, cone_width)
    else:
        tex_a = triplanar_sample(scene.textures.albedo_ao, pos, ns,
                                 cone_width)
        tex_nr = triplanar_sample(scene.textures.normal_rough, pos, ns,
                                  cone_width)
        tex_alb = tex_a[..., 0:3] * tex_a[..., 3:4]
        tex_rough = tex_nr[..., 3]
        ns_tex = apply_normal_map(ns, tex_nr[..., 0:3])
    t3 = textured[..., None]
    albedo = torch.where(t3, albedo * tex_alb, albedo)
    rough = torch.where(textured, tex_rough, rough)
    return mtype, albedo, rough, ior, f0, emission, \
        torch.where(t3, ns_tex, ns)


def path_trace(scene: SceneData, rays, pixel_ids, frame_idx: int,
               prev_basis, aspect, max_steps: int = MAX_TRAVERSAL_STEPS,
               use_packets: bool = True, use_proctex: bool = True, bn=None,
               env_fn=None, leaf_width: int = 1, overflow=None) -> GBuffer:
    """Trace the bounce program of the flat rays (N, 3); returns the flat
    G-buffer.  pixel_ids (N,) int, frame_idx: the frame counter (the
    sampler's index); bn: optional (N, 2) blue-noise offsets
    (sampling.blue_offsets_flat), which switch the sampler to the shared
    blue-noise-dithered sequence; env_fn: optional (org, dir) -> (N, 3)
    environment of the escaped rays (render/environment.py) in place of
    the sky fit.  max_steps and leaf_width (the triangle slots of a leaf
    entry of scene.bvh) serve the loop route; overflow: optional (1,) int32
    counter of dropped traversal-stack pushes, either route."""
    n = rays.org.shape[0]
    dev = rays.org.device
    f3 = lambda: torch.zeros((n, 3), device=dev)
    b0 = lambda: torch.zeros((n,), dtype=torch.bool, device=dev)
    inf = lambda: torch.full((n,), math.inf, device=dev)
    s = dict(
        org=rays.org, dir=rays.dir,
        beta=torch.ones((n, 3), device=dev),      # path throughput
        radiance=f3(), done=b0(), is_shadow=b0(),
        pending=f3(),                             # shadow contribution
        shadow_tmax=inf(), prev_pdf=torch.zeros(n, device=dev),
        prev_delta=~b0(), inside=b0(), cone=rays.cone_width,
        # the deferred environment escape
        esc_dir=rays.dir, esc_beta=f3(), esc_pdf=torch.zeros(n, device=dev),
        esc_delta=~b0(), has_esc=b0(),
        # the G-buffer
        albedo=torch.ones((n, 3), device=dev), normal=f3(), depth=inf(),
        mat_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
        got_primary=b0())
    if bn is not None:
        ld2 = lambda d: rand2_bn(bn, frame_idx, d)
    else:
        ld2 = lambda d: rand2(pixel_ids, frame_idx, d)

    for seg in range(SEGMENTS):
        s = _segment(scene, s, ld2, seg, max_steps,
                     is_last=(seg == SEGMENTS - 1), use_packets=use_packets,
                     use_proctex=use_proctex, leaf_width=leaf_width,
                     overflow=overflow)

    # the deferred environment: ONE evaluation for every escaped lane
    env = (env_fn(rays.org, s["esc_dir"]) if env_fn is not None
           else env_radiance_fit(scene.sky, s["esc_dir"]))
    lpdf = sun_pdf_dir(scene.sky, s["esc_dir"])  # NEE covers the sun only
    w_env = torch.where(s["esc_delta"], 1.0, power_heuristic(
        1.0, s["esc_pdf"], 1.0, lpdf))
    radiance = s["radiance"] + torch.where(
        s["has_esc"][..., None], s["esc_beta"] * env * w_env[..., None], 0.0)

    # demodulated colour and motion vectors
    color = torch.clamp(radiance, 0.0, RADIANCE_CLAMP) \
        / torch.clamp(s["albedo"], min=1e-3)
    mv = motion_vector(prev_basis, rays.uv, rays.org + rays.dir
                       * torch.clamp(s["depth"], max=1e8)[..., None], aspect)
    return GBuffer(color=color, albedo=s["albedo"], normal=s["normal"],
                   depth=s["depth"], motion=mv, mat_id=s["mat_id"])


def trace_segment(scene: SceneData, org, dir, t_max, use_packets: bool,
                  max_steps: int, leaf_width: int, overflow=None):
    """One segment's scene intersect: (t, tri, u, v, ns_raw, ng_raw, mat)
    of the closest hits under t_max, by K1 or the loop traverser."""
    if use_packets:
        ph = packet_intersect(scene.tables, org, dir, t_max,
                              overflow=overflow)
        return ph.t, ph.tri, ph.u, ph.v, ph.ns, ph.ng, ph.mat
    hit = intersect_scene(scene.bvh, org, dir, t_max, max_steps=max_steps,
                          leaf_width=leaf_width, overflow=overflow)
    ns_raw, ng_raw, mat = _fetch_surface_fallback(scene, hit.tri, hit.u,
                                                  hit.v)
    return hit.t, hit.tri, hit.u, hit.v, ns_raw, ng_raw, mat


def _segment(scene: SceneData, s, ld2, seg: int, max_steps: int,
             is_last: bool, use_packets: bool, use_proctex: bool,
             leaf_width: int, overflow=None):
    w3 = lambda m, a, b: torch.where(m[..., None], a, b)
    active = ~s["done"]
    t_max = torch.where(s["done"], 0.0, torch.where(
        s["is_shadow"], s["shadow_tmax"], math.inf))
    t_hit, tri, _, _, ns_raw, ng_raw, mat = trace_segment(
        scene, s["org"].contiguous(), s["dir"].contiguous(), t_max,
        use_packets, max_steps, leaf_width, overflow)
    hit_any = tri >= 0
    found = hit_any & active

    # shadow rays: unoccluded adds the pending contribution; either way the
    # path ends
    sh = s["is_shadow"] & active
    s["radiance"] = s["radiance"] + w3(sh & ~hit_any, s["pending"], 0.0)
    s["done"] = s["done"] | sh

    # analytic sphere lights, nearer than the hit, end a scatter ray
    lights = scene.lights
    if lights is not None:
        nl = lights.center.shape[0]
        lt = torch.full_like(t_hit, math.inf)
        lem = torch.zeros_like(s["beta"])
        for li in range(nl):
            hl, tl = ray_sphere(s["org"], s["dir"], lights.center[li],
                                lights.radius[li])
            closer = hl & (tl < lt)
            lt = torch.where(closer, tl, lt)
            lem = w3(closer, lights.emission[li].expand_as(lem), lem)
        lhit = active & ~sh & (lt < t_hit)
        w_l = torch.where(s["prev_delta"], 1.0, power_heuristic(
            1.0, s["prev_pdf"], 1.0,
            0.5 * _sphere_lights_pdf(lights, s["org"], s["dir"])))
        s["radiance"] = s["radiance"] + w3(
            lhit, s["beta"] * lem * w_l[..., None], 0.0)
        s["done"] = s["done"] | lhit

    # escaped scatter rays: the environment waits for the end
    esc = active & ~sh & ~hit_any
    s["esc_dir"] = w3(esc, s["dir"], s["esc_dir"])
    s["esc_beta"] = w3(esc, s["beta"], s["esc_beta"])
    s["esc_pdf"] = torch.where(esc, s["prev_pdf"], s["esc_pdf"])
    s["esc_delta"] = torch.where(esc, s["prev_delta"], s["esc_delta"])
    s["has_esc"] = s["has_esc"] | esc
    s["done"] = s["done"] | esc

    live = found & ~sh & ~s["done"]
    if is_last:
        s["done"] = s["done"] | live
        return s

    # ---- surface interaction ----
    wo = -s["dir"]
    pos = s["org"] + s["dir"] * t_hit[..., None]
    cone_w = s["cone"] * t_hit
    ns, ng = _orient_normals(ns_raw, ng_raw, wo)
    mtype, albedo, rough, ior, f0, emission, ns = _material_at(
        scene, mat, pos, ns, cone_w, use_proctex)

    # emissive surfaces add their emission and end the path (NEE never
    # samples mesh emitters, so the weight is 1)
    emissive = live & (mtype == MAT_EMISSIVE)
    s["radiance"] = s["radiance"] + w3(emissive, s["beta"] * emission, 0.0)
    s["done"] = s["done"] | emissive
    live = live & ~emissive

    # the primary hit's G-buffer
    first = live & ~s["got_primary"]
    s["normal"] = w3(first, ns, s["normal"])
    s["depth"] = torch.where(first, t_hit, s["depth"])
    s["mat_id"] = torch.where(first, mat.to(torch.int32), s["mat_id"])
    s["albedo"] = w3(first, torch.clamp(albedo, min=1e-3), s["albedo"])
    s["got_primary"] = s["got_primary"] | live

    u_bsdf = ld2(2 + 2 * seg)
    u_light = ld2(64 + 2 * seg)
    u_sel = ld2(128 + 2 * seg)[..., 0]
    bs = sample_bsdf(mtype, albedo, rough, ior, f0, ns, wo, s["inside"],
                     u_bsdf)
    rough_lane = live & ~bs.is_delta

    # light sample + MIS (rough surfaces): the sun's cone, 50/50 with the
    # sphere lights where there are any
    ls = sample_sun(scene.sky, u_light)
    if lights is not None:
        nl = lights.center.shape[0]
        pick = ld2(192 + 2 * seg)
        li = torch.clamp((pick[..., 0] * nl).to(torch.int64), 0, nl - 1)
        lsp = sample_sphere_light(lights, li, pos, u_light)
        use_sphere = pick[..., 1] < 0.5
        ls = dataclasses.replace(
            ls, wi=w3(use_sphere, lsp.wi, ls.wi),
            radiance=w3(use_sphere, lsp.radiance, ls.radiance),
            pdf=torch.where(use_sphere, 0.5 * lsp.pdf / nl, 0.5 * ls.pdf),
            dist=torch.where(use_sphere, lsp.dist, ls.dist))
    f_l, pdf_b_at_l = eval_bsdf(mtype, albedo, rough, f0, ns, wo, ls.wi)
    cos_l = torch.clamp(dot(ns, ls.wi), min=0.0)
    w_l = power_heuristic(1.0, ls.pdf, 1.0, pdf_b_at_l)
    c_light = s["beta"] * f_l * (cos_l / torch.clamp(
        ls.pdf, min=1e-8))[..., None] * ls.radiance * w_l[..., None]
    c_light = w3(ls.pdf > 1e-8, c_light, 0.0)

    # the stochastic single-ray choice between the shadow ray and the
    # scatter ray, by their estimates
    est_l = luminance(c_light)
    est_s = luminance(s["beta"] * bs.weight)
    q = torch.where(est_l + est_s > 0.0,
                    est_l / torch.clamp(est_l + est_s, min=1e-12), 0.0)
    q = torch.clamp(q, 0.0, 0.9)
    take_shadow = rough_lane & (u_sel < q) & (est_l > 0.0)

    # the shadow branch: its contribution scaled by 1 / q
    s["is_shadow"] = take_shadow
    s["pending"] = w3(take_shadow, c_light / torch.clamp(
        q, min=1e-3)[..., None], 0.0)
    s["shadow_tmax"] = torch.where(take_shadow, ls.dist, math.inf)

    # the scatter branch (delta lanes always scatter)
    scatter = live & ~take_shadow
    inv_p = torch.where(rough_lane, 1.0 / torch.clamp(1.0 - q, min=1e-3),
                        1.0)
    s["beta"] = w3(scatter, s["beta"] * bs.weight * inv_p[..., None],
                   s["beta"])
    s["prev_pdf"] = torch.where(scatter, bs.pdf, s["prev_pdf"])
    s["prev_delta"] = torch.where(scatter, bs.is_delta, s["prev_delta"])

    # glass transmission flips inside-ness where the ray crosses
    crossed = scatter & (dot(bs.wi, ng) < 0.0)
    s["inside"] = torch.where(crossed, ~s["inside"], s["inside"])

    new_dir = w3(take_shadow, ls.wi, bs.wi)
    off = torch.where((dot(new_dir, ng) >= 0.0)[..., None], ng * 1e-3,
                      -ng * 1e-3)
    s["org"] = w3(live, pos + off, s["org"])
    s["dir"] = w3(live, new_dir, s["dir"])
    s["cone"] = torch.where(live, cone_w, s["cone"])

    # a dead throughput ends the lane
    s["done"] = s["done"] | (live & ~take_shadow
                             & (luminance(s["beta"]) < 1e-5))
    return s
