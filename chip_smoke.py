#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (rtrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device: the card's name and power limit, whether the port's native
     content library (built from rtrt_tpu_torch/content/native) loaded or
     its numpy twins ran;
  2. build: nvcc builds the kernels of csrc/ from this checkout, one
     process per source, and prints ptxas' registers / spills per kernel;
  3. each kernel vs its plain PyTorch version on the card, on the 1080p
     terrain scene's tables and the full 1920x1080 frame's rays: K1
     traversal (the primary rays + any-hit rays from their hits toward a
     low sun), K2 megakernel (all 18 output planes, the finished G-buffer
     colour, the deepest traversal stack against the tables' stack depth
     and the plain version's; the plain version counts the visits and the
     shaded, textured and sampled hits that K2's bound counts), K3 post
     tail (the frame K2 rendered), K4 a-trous pass (that frame's
     G-buffer; the 7x7 pass at both parities and the 5x5 passes at
     strides 3, 6, 12), K5 history reprojection (that frame's planes as
     bf16 history; a camera's motion and a synthetic field); each kernel and its plain version are timed at that
     shape (K3 and K5 also by CUDA graph replays, `time_graph_ms`, which
     leave the host's launch path out; their bounds are held against
     those), and each kernel's bound (bytes or operations,
     `utils/timing.py::bound_ms`) is computed from this run's inputs;
     then K1 and K2 on the chain scene (engine/scene.py::build_chain_scene,
     12 BVH4 levels: the 256-entry stack) against their plain versions,
     0 dropped pushes and a deepest stack beyond 32 entries;
  4. the first slice's path: Engine(terrain, 1920x1080,
     FeatureFlags(denoise=False, bloom=False, lens_flare=False)) renders 2
     warm-up and 5 timed frames; K2 and K3 must each read 7 launches;
  5. the main path: Engine(terrain, 1920x1080, FeatureFlags()) — denoised,
     bloomed, lens-flared — renders 3 warm-up and 10 timed frames of a
     slow yaw pan; launch counters are reset just before and must read K2
     13, K3 13, K4 52, K5 13 after (K1's traversal runs inside K2, so its
     own launcher reads 0); the deepest traversal stack of the 13 frames
     and 0 dropped pushes; output, G-buffer, history, image and denoise
     checks;
  7. the traversal-step probes (rtrt_tpu_torch/tools): K6 ubench_step,
     K7 probe_leaf, K8 probe_cores and K9 its 8-tile grid, each against
     its plain version on the card in every mode, on the tools' own
     inputs and (K7-K9) on rays that hit every record: K6 at rows 8, 24,
     64 (clusters of 1, 2, 4 blocks) and steps 1 and PROBE_CUT, and at 64
     rows 1025 steps (the record index wraps at 1024), K7 at rows 8, 16,
     32 and steps 1 and PROBE_CUT, and at 32 rows 129 steps (the stack
     wraps at 128; tests/test_torch_kernels_gpu.py runs every row count
     across the wraps), K8 at 8 and 32 rows and K9 at the tools' default
     rows, PROBE_CUT steps;
     K1 under step caps 2, 4, 8, 16 against
     the plain traversal under the same cap on every 16th 1080p primary
     (0 dropped pushes);
     then, with the launch counters reset, the tools' entry points at
     their full default steps and reps (ubench_step, probe_leaf,
     probe_cores, probe_traverse; every mode timed, ns/step beside its
     floor and the card), and every probe kernel and K1's launcher must
     read launches; each bound with the share of the SMs it fills;
  8. the hardware probes (rtrt_tpu_torch/tools): K10 probe_cond, K11 /
     K12 probe_smem, K13 probe_pressure, K14 probe_broadcast, K15
     probe_xpose, K16 probe_bf16, every mode against its plain version on
     the card at the tools' rows and a cut step count, on every input
     recipe of tests/test_torch_hw_probes.py (bit-equal; K10's three modes
     and K15's two agree, K12's extract equals K10 flat; K10 and K12 at
     every row count 8-64 (c = 1-4), K13 split over c = 4 and 1 SMs at
     its 64 and 8 rows, K14 at every row count 8-64 on a cluster of c =
     1, 2, 4 blocks (and no spill stores in ptxas' lines), K15 at every row count 8-32 (c = 1-4) and K16 at
     every row count 8-64 (c = 1-4)); K11 at the card's shared-memory
     edge on its grid of rows / 8 blocks at 8 and 64 rows (accepted at 48
     KB and at the opt-in maximum, refused one float beyond and at every
     size of the JAX tool); then, with the launch counters reset, the six
     tools' entry points at their default steps and reps and K11 at 48 KB
     (every new kernel must read launches; K11 timed by CUDA events and
     by graph replay), and the plain versions timed once at the
     defaults;
  9. the north star's call: Engine(GlobalSettings(scene="terrain")) — the
     default settings (1920x1080, dynamic resolution on) and the default
     FeatureFlags() — with the launch counters reset just before: a warm
     frame at 1080, dt 1/20 s until the controller drops to the 720
     bucket, 10 timed frames there (dt 1/60 s keeps the bucket), dt 1/200
     s until it climbs back to 1080, 10 timed frames there with the "w"
     key held (camera input moves the camera every frame), then 8 frames
     with dt=None (the bucket sequence and the dt the controller saw
     from Timer.update are printed); every image (1080, 1920, 3) uint8,
     the history at each bucket's size, 0 dropped pushes; K2, K5, K4,
     K3 and K3's pre-mapped instantiation must read launches.  The timed
     frames run under torch.cuda.set_sync_debug_mode("error"): a host
     sync inside them fails the run.  Then K3's pre-mapped instantiation
     against its plain version on a 720p frame of that run (the denoised
     colour, tone-mapped and upscaled to 1080p): max |du8| <= 1, equal
     on >= 99.99%; timed by events and by graph replay beside its bytes
     bound;
 10. interlace: Engine(terrain, 1920x1080, dynamic resolution off,
     interlace=True), default FeatureFlags(), 3 warm-up and 10 timed
     frames of the slow pan (sync debug "error" on the timed ones); launch
     counters reset just before must read K2 13 (each over the 540 traced
     rows), K3 13, K4 52, K5 13; ms/frame beside phase 5's full-rate
     frame; then for a frame index of each parity, the field's traced
     G-buffer rows equal the full-rate frame's rows bit for bit on every
     plane (both rendered from the same state);
 11. headless: `python -m rtrt_tpu_torch.app.headless --scene terrain
     --frames 3 --out <tmp>.png` in a subprocess exits 0 and writes a
     1920x1080 PNG;
 12. the animated terrain: Engine(terrain, 1920x1080, dynamic resolution
     off, animation="wave"), default FeatureFlags(), 3 warm-up and 10
     timed frames of the slow pan under sync debug "error", launch
     counters reset just before: K2 13, K3 13, K4 52, K5 13; 0 dropped
     pushes (the deepest stack printed); then on the last frame's tables:
     every child box holds its subtree (the leaf rows' displaced
     triangles, the child node's boxes), nodes / tris / nrm / ng equal
     the plain refit of the same clock on the CPU (nodes, tris, nrm
     within 2e-5; ng within 1e-3 on >= 99.9% of slots: sliver triangles
     turn their normals), K1 and K2 against their plain versions at phase
     3's bounds, levels, stack and the tensors' storage unchanged; ms/
     frame, and device busy and launches per frame (torch.profiler) of
     the animated frame, of phase 5's static frame and of the refit stage
     alone;
 13. ocean + stars: Engine(terrain, 1920x1080, FeatureFlags(ocean=True,
     stars=True)) at night (sky.time_of_day 0.0), 3 warm-up and 5 timed
     frames (sync debug "error" on the timed ones): each image (1080,
     1920, 3) uint8, the G-buffer finite, the
     traced colour differs from the same frame without the ocean on > 1%
     of pixels; ms/frame, device busy and launches per frame;
 14. the two-level LBVH (Engine(..., bvh="lbvh")): the terrain's build on
     the card against the CPU build of the same arrays (integer tables
     equal; the float tables' largest difference in ulps printed, and 0);
     K1's binary instantiation against its plain version on the 1080p
     primaries and the any-hit rays toward a low sun (phase 3's bounds),
     then under probe_traverse's step caps (its launches); K2's binary
     instantiation against its plain version (`_check_k2`), its deepest
     stack within the static bound and 0 dropped pushes, its time beside
     the BVH4 instantiation's on the same view; Engine(terrain, 1920x1080,
     bvh="lbvh") static and with animation="wave", 3 warm-up and 10 timed
     frames of the slow pan under sync debug "error", launch counters
     reset just before: K2's binary instantiation 13, K3 13, K4 52, K5 13;
     device busy and launches per frame of both and of the rebuild stage
     alone (torch.profiler).
 15. the opt-in branches of K1 and K2: K2's Fourier-texture
     instantiation against its plain version on the 1080p view of phase 3
     (`_check_k2`; the fit of Engine(terrain, 1920x1080,
     FeatureFlags(fourier_textures=True))), timed beside the procedural
     K2 on the same view; that Engine, 3 warm-up and 5 timed frames under
     sync debug "error" (each image (1080, 1920, 3) uint8; launch counters
     reset just before: K2's Fourier instantiation 8), its traced albedo
     against the same frame's with the procedural soil (> 1% of pixels
     differ), device busy and launches per frame; the flat binary SAH
     tree (Engine(..., bvh="sah2")): K1's and K2's binary leaf-row
     instantiations against their plain versions on the 1080p primaries
     and the any-hit rays toward a low sun, 0 dropped pushes, the deepest
     stack within the tables' levels, K1 under probe_traverse's step caps
     (its launches), K2's time beside the BVH4 instantiation's on the same
     view; that Engine timed as above (K2's leaf-row instantiation 8);
     Engine(GlobalSettings(scene="terrain", sky_model="preetham")): two
     frames, each image finite uint8.
 16. the denoiser's other branches: Engine(terrain, 1920x1080, dynamic
     resolution off, FeatureFlags(temporal_filter=False)), 3 warm-up and 5
     timed frames of phase 5's pan under sync debug "error", launch
     counters reset just before: K2 8, K4 32, K3 8, K5 0 (its second
     temporal pass fetches history through the ±1 px shift stencil); each
     image (1080, 1920, 3) uint8, the history finite, the image differs
     from phase 5's frame of the same camera on > 1% of pixels; K5's
     bilinear instantiation against reproject_plain(...,
     history_filter="bilinear") on phase 3e's history and motions at phase
     3e's bounds, timed by events and by graph replay beside its bound and
     F.grid_sample; then 3 main-path frames with RTRT_HISTORY_FILTER's
     module default set to "bilinear" (its launch counter 3, the
     Catmull-Rom one 0); the RTRT_DEBUG guards outside sync-debug mode:
     nan_guard(enabled=True) on a card tensor with NaN and Inf zeroes them
     and reports 3, and a default-flags frame with the guards on reports
     0 bad values on each of its five labels;
 17. quality: tools/quality.py's measure at 1920x1080 on the terrain, 64
     spp and 48 frames: the ceiling and the SSIM trajectory beside the
     card; the final SSIM must be >= 0.90;
 18. the viewer: ViewerServer(Engine(terrain, 1920x1080, dynamic
     resolution off), host 127.0.0.1, port 0): GET / (the page), /params
     (19 entries, each value in its range), POST /input ("w" down moves
     the camera, then up; post.bloom_strength 0.2 read back in
     engine.params), GET /stats (fps, w, h), one multipart part of /stream
     decoded to a 1920x1080 RGB PNG; stop() must not raise; K2, K5, K4 and
     K3 must read launches.
 19. the wavefront integrator (render/integrator.py::path_trace):
     Engine(terrain, 1920x1080, trace="packets"), default FeatureFlags(),
     3 warm-up and 5 timed frames of the slow pan under sync debug
     "error", launch counters reset just before: K1 40 (5 a frame: one per
     bounce segment, shadow rays included), K2 0, K3 8, K4 32, K5 8;
     ms/frame, device busy and launches per frame beside the main path's
     megakernel frame on the same view; then one frame with K1's inputs
     recorded: its primary G-buffer (mat id, depth rtol 1e-5, normal
     within 1e-3) equal to the megakernel frame's of the same state and
     camera on >= 99.9% of pixels, the share of raw colour within 1e-3,
     K1 timed on each segment's rays, and K1 against its plain version on
     all of the frame's rays in one batch (the primaries, the bounce and
     shadow rays, finished lanes with t_max 0) and on the same rays with a
     finite t_max on half the live lanes, at phase 3's bounds, with each
     bounce segment's tri ids equal on >= 99.9% alone; Engine(terrain, 480x270,
     trace="loop") one frame (sync debug off: the loop syncs every step)
     against the packet route's frame of the same state (primary G-buffer
     equal on >= 99.9%; no traversal kernel launched); the packet route
     on the animated terrain, bvh="sah4" (refit) and "lbvh" (rebuild): 3
     frames each under sync debug "error", K1's instantiation 15, K2 0.
 20. the row-sharded frame (rtrt_tpu_torch/parallel/frame_spmd.py) on the
     one card: K5's band instantiation (row0, rows) over each of 4 bands
     of phase 3e's history, in both filters, bit-equal to the same rows of
     the full launch, against its plain version, timed by events and graph
     replay beside its bytes bound; the main path's 1080p terrain, 3
     frames of phase 5's pan, over 4 ranks sharing cuda:0 over gloo
     (spawned after phase 2's build): rank 0's gathered images within 1
     u8 of the single-process frames on every pixel and differing on < 5%
     (the count printed, with the stage of the first difference), each
     rank's history (270, 1920) planes, its launches per frame K2 1, K5's
     band instantiation 1, K4 4, K3 1, 0 dropped pushes; the same frames
     under nccl at world size 1 in this process, bit-equal; the loop route
     at 480x270 over 2 ranks, one frame held like the first; each rank's
     ms/frame by host clock, device busy (torch.profiler, one frame) and
     bytes fetched a frame, beside the single-process frame's ms.
 21. the frame's cut points and the JAX package's tools: (a) K2's
     traversal-step instantiation (kSteps) on phase 3's view and rays: its
     18 planes bit-equal to the default instantiation's, its (6, N) step
     planes equal to the plain version's on >= 99.9% of pixels (segments
     summing to the total), both timed by CUDA events in turns beside its
     bound (K2's operations plus 24 B a pixel of step planes), the ptxas
     registers and spill stores of both (the default BVH4 instantiation
     held at 64 registers and 212 B, as before the flag); (b)
     tools/profile_frame.py's main over the five cuts (bvh, trace, steps,
     denoise, full) of the 1080p terrain, default FeatureFlags(): the full
     cut's image bit-equal to render_frame's image of the same state and
     camera, the trace cut equal to that frame's G-buffer, the denoise
     cut's history equal to its new history and its colour to the
     denoiser on the trace cut's planes; launches per cut (bvh: no K2;
     trace and steps: K2 alone; denoise: K5 1, K4 4; full: K3 1);
     cumulative and delta ms and device busy per cut; then --rebuild (the
     static LBVH rebuilt in every frame) and --trace-steps; (c)
     tools/fps_demo.py, a few frames a bucket from 1080 rows against the
     30-fps target; (d) tools/sky_preview.py's PNGs, sky_compare at 1000
     samples, mesh_baker on an OBJ of the block mesher's output with one
     Loop subdivision, bluenoise_gen at 32x32; the K2 step launches are
     those of --trace-steps' one frame, counted from 0 just before it;
     (e) K2 at segments=3 (RTRT_SEGMENTS=3's route) on phase 3's view and
     rays against its plain version at 3, at phase 3's bounds, timed in
     turns with the default 5, beside its bound from the plain version's
     visits and hits at 3; then 3 frames of phase 5's main path with
     render/integrator.py's count, which both routes read, set to 3 (K2
     launches counted from 0 just before), and the last of them again at
     5 from the same frame state: equal first-hit planes, other radiance.
  --profile adds 6: torch.profiler over 5 frames each of the main path,
     the north star's Engine at the 720 bucket and the interlaced Engine
     (device busy time, launches and synchronising calls per frame, top
     device ops).
Prints the card's name and power limit, the per-kernel JSON line (K1-K16,
K3's pre-mapped instantiation, K5's bilinear instantiation, K1's and K2's
binary instantiations, their leaf-row instantiations, K2's
Fourier-texture instantiation, K1's wavefront route, K5's band
instantiation, K2's traversal-step instantiation, K2 at segments=3 and
K16 in float32 beside its bf16 entry),
then as its last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX nor of the JAX package.  Exits 1 when CUDA is not
available.
"""

import dataclasses
import json
import os
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
WARMUP, TIMED = 3, 10
SLICE_WARMUP, SLICE_TIMED = 2, 5

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
# the binary two-level LBVH (traverse2): a node visit is 2 slab tests of 20
# plus the near / far choice and the prune test (4); a leaf visit is one
# Moller-Trumbore test of 59
NODE2_OPS, LEAF2_OPS = 2 * 20 + 4, 59
# K3's pre-mapped instantiation: the sharpen's sums, minima, maxima and
# clamp ~29 a channel, dither and quantize ~6 (csrc/post_tail.cu)
TAIL_MAPPED_OPS_PX = 110
K4_TAP_OPS, K4_PX_OPS, K5_PX_OPS = 21, 10, 280
# K5's bilinear instantiation ~90 per pixel: positions 8, 4 weights of 4,
# 4 tap products, 4 taps x 6 channels of FMA (2 each), nearest and ok 14
K5_BL_PX_OPS = 90
# K2's shading, per hit of the plain version's counts (`hits=`), from
# csrc/kshade.cuh and megakernel.cu::shade_segment, each float or integer
# operation one (an FMA two, sqrt / div / sin / cos / floor one):
#   SURF_OPS per shaded hit: hit attributes 17 (barycentric normal), hit
#     point and cone 9, wo 3, orient_normals 56 (two normalisations of
#     13, three dots of 5, signs and flips), material row 15, G-buffer
#     capture 9;
#   SOIL_OPS per textured hit: 13 fbm octaves (4 + 3 + 3 x 2) of 208 (a
#     value_noise3 of 190: 8 hash3 of 17 and their 3 corner adds, floors
#     and fractions 9, three quintic fades of 7, 7 lerps of 3; plus 18 of
#     octave fade, scaling and sum) and ~90 of colour, roughness, bump
#     and normalisation;
#   BSDF_OPS per sampled hit (Lambert, the terrain's material: sample 81,
#     sun sample 62, evaluation 11, MIS + shadow-or-scatter choice + next
#     ray 110) plus 3 blue-noise rotations of 12 (two adds, floors and
#     subtractions a coordinate; the rest of the sequence is K2's
#     per-launch table).  Sphere-light terms are not counted (the terrain
#     has no sphere light).
SURF_OPS, SOIL_OPS, BSDF_OPS = 109, 13 * 208 + 90, 264 + 3 * 12
#   ftex_ops(atoms) per textured hit of K2's Fourier branch
#     (kshade.cuh::ftex_shading): per texture and atom an expf and its
#     product (2) and per plane the angle (2 products, a sum), a sincosf
#     (2), the two attenuated terms (2) and 8 FMAs (16): 23; per texture
#     12 initial sums and the 4 channels' triplanar blend (24); ~80 of
#     weights, footprint, clamps, frame and normalisation
def ftex_ops(atoms):
    return 2 * (atoms * (2 + 3 * 23) + 36) + 80


# (the probes K6-K9 count theirs in their tool modules: LANE_OPS, LEAF_OPS,
# INT_OPS; every bound is rtrt_tpu_torch/utils/timing.py::bound_ms, whose
# rates are the H100 SXM data sheet's at 700 W)
CAPS = (2, 4, 8, 16)  # K1 step caps of phase 7 (probe_traverse's)
PROBE_CUT = 40  # steps of phase 7's kernel-vs-plain checks
K6_ROWS = (8, 24, 64)  # K6's clusters of 1, 2 and 4 blocks
K7_ROWS = (8, 16, 32)


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


def _shadow_rays(org, dirs, hit, sun_dir):
    """Any-hit rays from the hits of the primaries (org, dirs) toward a low
    sun (6 degrees above the horizon, the sun's azimuth), so that the dunes
    occlude a share of them: (origins, directions) of the hit rays."""
    import torch
    h = hit.tri >= 0
    sh_org = (org + dirs * torch.where(h, hit.t, 0.0)[:, None] + hit.ng
              * 1e-3 * torch.sign((hit.ng * -dirs).sum(-1, True)))[h]
    sd = sun_dir
    low = torch.stack([sd[0], torch.linalg.vector_norm(sd[0::2]) * 0.105,
                       sd[2]])
    sh_dir = (low / torch.linalg.vector_norm(low)).expand_as(
        sh_org).contiguous()
    return sh_org.contiguous(), sh_dir


def _check_k1(name, tables, o, d, a, b):
    """Assert K1's hits `a` against the plain version's `b` on rays (o, d);
    return the max abs error of t where the slots agree.

    t tolerance, where the slots agree: rtol 1e-5 plus 4e-6 absolute (the
    float32 spacing of the terrain's ~64-unit coordinates) on >= 99.99% of
    the rays, and on every ray the larger of that and twice the a-priori
    bound on float32 rounding in t.  Kernel and plain version each round
    within that bound, in different ways (nvcc contracts products into
    FMA); it exceeds 1e-5 t where Moller-Trumbore is ill-conditioned:
    grazing rays (at 1080p a few horizon rays with |cos| ~ 0.005-0.02
    differ by ~2.5e-5 t) and short shadow rays from an origin far from the
    triangle's v0."""
    import torch
    same = a.tri == b.tri
    frac = same.float().mean().item()
    fin = same & torch.isfinite(b.t)
    dt = (a.t - b.t).abs()[fin].double()
    flat = 1e-5 * b.t.abs()[fin].double() + 4e-6
    cond = 2 * _t_rounding_bound(tables, b.tri[fin], o[fin], d[fin])
    worst = (dt / torch.maximum(flat, cond)).max().item() \
        if fin.any() else 0.0
    n_flat = int((dt > flat).sum())
    err = dt.max().item() if fin.any() else 0.0
    print(f"K1 {name}: {a.tri.numel()} rays, {(b.tri >= 0).sum().item()}"
          f" hits, tri id equal on {frac:.6f}, t max abs err {err:.3e}; "
          f"{n_flat} rays beyond 1e-5 t + 4e-6; worst error / rounding "
          f"bound {worst:.3f}")
    assert frac >= 0.999, f"K1 {name}: tri ids equal on only {frac}"
    assert n_flat <= 1e-4 * int(fin.sum()), \
        f"K1 {name}: t beyond rtol 1e-5 on {n_flat} rays"
    assert worst <= 1.0, f"K1 {name}: t error beyond bound ({worst})"
    return err


def _check_k2(label, sky, rays, a, b, prev_basis):
    """Assert K2's planes `a` against the plain version's `b` on image-shaped
    rays; return the two finished G-buffers and the max abs error of the
    normal and albedo where the materials agree.

    Per pixel on >= 99%: depth rtol 1e-4, mat id equal, normal, albedo,
    esc_dir and esc_pdf atol 5e-3, esc_beta atol 5e-3 + rtol 1e-2 (nvcc's
    FMA contraction moves a few bounce directions by an ulp, and a path
    that crosses a decision boundary diverges; beyond that, esc_beta
    carries 1 / (1 - q) of the shadow-or-scatter choice, whose q holds the
    sun-disk limb term: one rounding of the sun sample's cosine moves it by
    ~0.25%); the escape planes exactly where the primary ray misses; mean
    radiance and finished colour per channel within 1%."""
    import torch
    from rtrt_tpu_torch.render import megakernel as M

    h, w = a.depth.shape
    miss = (a.mat_id == -1) & (b.mat_id == -1)
    close = lambda x, y, rtol=0.0: (
        ((x - y).abs() - rtol * y.abs()).reshape(h, w, -1).amax(-1) <= 5e-3)
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
    gba = M.finish_gbuffer(sky, rays, a, prev_basis, w / h)
    gbb = M.finish_gbuffer(sky, rays, b, prev_basis, w / h)
    rel = lambda x, y: ((x.mean((0, 1)) - y.mean((0, 1))).abs()
                        / y.mean((0, 1)).abs().clamp(min=1e-6)).max().item()
    rad_rel, col_rel = rel(a.radiance, b.radiance), rel(gba.color, gbb.color)
    m_ok = oks["mat_id"]
    err = max((getattr(a, f) - getattr(b, f)).abs()[m_ok].max().item()
              for f in ("normal", "albedo"))
    print(f"K2 {label}: share of pixels within bounds "
          f"{ {f: round(v, 6) for f, v in fracs.items()} } (escape planes "
          f"over the {(~miss).sum().item()} primary hits); escape planes "
          f"exact on the {miss.sum().item()} primary misses: {miss_exact}; "
          f"mean radiance rel err {rad_rel:.3e}, mean finished colour rel "
          f"err {col_rel:.3e}")
    for f, v in fracs.items():
        assert v >= 0.99, f"K2 {label}: {f} agrees on only {v}"
    assert miss_exact, f"K2 {label}: escape planes differ on primary misses"
    assert rad_rel <= 0.01, f"K2 {label}: mean radiance differs by {rad_rel}"
    assert col_rel <= 0.01, \
        f"K2 {label}: mean finished colour differs by {col_rel}"
    return gba, gbb, err


def main() -> int:
    t_start = time.perf_counter()
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
    from rtrt_tpu_torch.utils.timing import bound_ms, card as card_line, \
        time_graph_ms, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
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
    sc, consts = eng.scene_data, eng.consts
    tables = sc.tables
    print(f"init: scene {s['scene']:.2f} s, SAH+BVH4 {s['sah4']:.2f} s, "
          f"sky {s['sky']:.2f} s; {eng.scene.num_tris} tris, "
          f"{tables.nodes.shape[0]} BVH4 nodes, {tables.levels} levels: "
          f"traversal stack {tables.stack} entries {card}")
    stacks = cuda.traverse_stacks()
    assert stacks == P.STACK_DEPTHS, f"stack instantiations {stacks}"
    assert tables.stack == 32, f"terrain stack {tables.stack}"
    rays = generate_rays_padded(camera_basis(eng.camera), W, H,
                                consts.pixel_ids, rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))

    # ---- 3a. K1 traversal: the frame's primaries + a shadow-ray batch ----
    print(f"-- phase 3a at {time.perf_counter() - t_start:.1f} s")
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    ovf = P.overflow_counter(dev)
    g = P.packet_intersect(tables, org, dirs, overflow=ovf)
    k1_visits = [0, 0]
    r = P.packet_intersect_plain(tables, org, dirs, visits=k1_visits)
    sh_org, sh_dir = _shadow_rays(org, dirs, r, sc.sky.sun_dir)
    gs = P.packet_intersect(tables, sh_org, sh_dir, any_hit=True,
                            overflow=ovf)
    rs = P.packet_intersect_plain(tables, sh_org, sh_dir, any_hit=True)
    torch.cuda.synchronize()
    k1_err = max(_check_k1(name, tables, o, d, a, b)
                 for name, o, d, a, b in (("primary", org, dirs, g, r),
                                          ("shadow", sh_org, sh_dir, gs, rs)))
    assert int(ovf) == 0, f"K1 stack overflow count {int(ovf)}"
    k1_ms = time_ms(lambda: P.packet_intersect(tables, org, dirs), 10)
    k1_plain = time_ms(lambda: P.packet_intersect_plain(tables, org, dirs), 1)
    n_rays = org.shape[0]
    k1_bound = bound_ms(n_rays * (28 + 44) + _table_bytes(tables),
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
    k2_depth, plain_depth = (P.overflow_counter(dev) for _ in range(2))
    a = M.megakernel_trace(*args, n_lights=n_lights, bn=consts.bn,
                           overflow=ovf, stack_depth=k2_depth)
    k2_ms = time_ms(lambda: M.megakernel_trace(*args, n_lights=n_lights,
                                              bn=consts.bn), 5)
    k2_visits, k2_hits = [0, 0], [0, 0, 0]
    b = M.megakernel_trace_plain(*args, n_lights=n_lights, bn=consts.bn,
                                 visits=k2_visits, hits=k2_hits,
                                 stack_depth=plain_depth)
    k2_plain = time_ms(lambda: M.megakernel_trace_plain(
        *args, n_lights=n_lights, bn=consts.bn), 1)
    stack = tables.stack
    print(f"K2 deepest traversal stack {int(k2_depth)} entries (plain "
          f"version {int(plain_depth)}; the tables' stack holds {stack}); "
          f"dropped pushes {int(ovf)}")
    assert int(k2_depth) < stack, f"K2 stack {int(k2_depth)} of {stack}"
    # bytes: rays, cone, pixel id, blue-noise pair in; 18 planes out.
    # Operations: the traversal of all 5 segments and the shading of the
    # hits (SURF_OPS, SOIL_OPS, BSDF_OPS above)
    px = W * H
    k2_ops = dict(traversal=k2_visits[0] * NODE_OPS
                  + k2_visits[1] * LEAF_OPS, surface=k2_hits[0] * SURF_OPS,
                  soil=k2_hits[1] * SOIL_OPS, bsdf=k2_hits[2] * BSDF_OPS)
    k2_bound = bound_ms(px * (40 + 72) + _table_bytes(tables),
                        sum(k2_ops.values()))
    print(f"K2 time, {W}x{H}: kernel {k2_ms:.3f} ms, plain {k2_plain:.1f} "
          f"ms; per pixel over the segments {k2_visits[0] / px:.2f} node "
          f"and {k2_visits[1] / px:.2f} leaf visits, {k2_hits[0] / px:.3f}"
          f" shaded, {k2_hits[1] / px:.3f} textured and "
          f"{k2_hits[2] / px:.3f} sampled hits; operations "
          f"{ {k: f'{v / 1e9:.3f} G' for k, v in k2_ops.items()} }; bound "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]}) {card}")
    gba, gbb, k2_err = _check_k2(f"{W}x{H}", sc.sky, rays, a, b,
                                 camera_basis(eng.camera))
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
    k3_ms = time_ms(lambda: post_tail(final, par, mask, do_sharpen=True,
                                     do_dither=True), 50)
    k3_graph = time_graph_ms(lambda: post_tail(
        final, par, mask, do_sharpen=True, do_dither=True), 20, 50)
    k3_plain = time_ms(lambda: post_tail_plain(
        final, par, mask, do_sharpen=True, do_dither=True), 5)
    k3_bound = bound_ms(W * H * (12 + 3), W * H * TAIL_OPS_PX)
    print(f"K3 time, {W}x{H}: kernel {k3_ms:.4f} ms by events, "
          f"{k3_graph:.4f} ms by graph replay, plain {k3_plain:.3f} ms; "
          f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]}), "
          f"{k3_bound[0] / k3_graph:.0%} of it {card}")

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
        loose = bool((err <= 1e-4 + 1e-3 * ref.abs()).all())
        k4_err = max(k4_err, err.max().item())
        t_k = time_ms(lambda: edge_aware_pass(*gb_in, **kw), 20)
        t_p = time_ms(lambda: edge_aware_pass_plain(*gb_in, **kw), 3)
        if label != "7x7 parity 1":  # the four passes of a frame
            k4_ms.append(t_k)
            k4_plain.append(t_p)
        print(f"K4 {label}, {W}x{H}: within rtol 1e-4 + atol 1e-5 on "
              f"{within.item():.6f} of pixels, max abs err "
              f"{err.max().item():.3e}; kernel {t_k:.4f} ms, plain "
              f"{t_p:.3f} ms {card}")
        assert within.item() >= 0.999, f"K4 {label} agrees on {within}"
        assert loose, f"K4 {label}: a pixel beyond rtol 1e-3 + atol 1e-4"
    k4_ms, k4_plain = sum(k4_ms) / 4, sum(k4_plain) / 4
    # per pass: 25 taps (the 7x7 half kernel keeps 25 of 49); colour,
    # normal, depth, material in (32 B) and colour out (12 B) per pixel
    k4_bound = bound_ms(W * H * 44, W * H * (25 * K4_TAP_OPS + K4_PX_OPS))
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
    wide = lambda x: x.to(torch.float32)
    motions = [("camera yaw 0.02 rad + 0.1 units", mv_cam.contiguous()),
               ("synthetic field", mv_syn.contiguous())]
    k5_err = max(_k5_check(f"K5 {label}, {W}x{H}", reproject(*hist, mv),
                           reproject_plain(wide(hist[0]), wide(hist[1]),
                                           wide(hist[2]), hist[3],
                                           wide(hist[4]), mv))
                 for label, mv in motions)
    k5_ms = time_ms(lambda: reproject(*hist, mv_cam), 20)
    k5_graph = time_graph_ms(lambda: reproject(*hist, mv_cam), 20, 20)
    k5_plain = time_ms(lambda: reproject_plain(
        wide(hist[0]), wide(hist[1]), wide(hist[2]), hist[3], wide(hist[4]),
        mv_cam), 3)
    # 8 bf16 planes + mat i32 + motion 2 x f32 in; 9 f32 planes + ok out
    k5_bound = bound_ms(W * H * (28 + 37), W * H * K5_PX_OPS)
    print(f"K5 time, {W}x{H}, camera motion: kernel {k5_ms:.4f} ms by "
          f"events, {k5_graph:.4f} ms by graph replay, plain {k5_plain:.3f} "
          f"ms; bound {k5_bound[0]:.4f} ms ({k5_bound[1]}), "
          f"{k5_bound[0] / k5_graph:.0%} of it {card}")
    k5_in = (hist, motions)

    # ---- 3f. K1 and K2 on a tree that needs the deep stack ----
    print(f"-- phase 3f at {time.perf_counter() - t_start:.1f} s")
    _deep_tree(dev, card)

    # ---- 4. the first slice's path (denoiser, bloom, lens flare off) ----
    print(f"-- phase 4 at {time.perf_counter() - t_start:.1f} s")
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
    print(f"-- phase 5 at {time.perf_counter() - t_start:.1f} s")
    main = Engine(settings, flags=FeatureFlags(), device="cuda")
    cam0 = main.camera

    def pan(k):  # on the device: no host sync
        main.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    cuda.reset_launch_counts()
    main.overflow.zero_()
    main.stack_depth.zero_()
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
    print(f"main path: deepest traversal stack {int(main.stack_depth)} "
          f"entries of {stack}, dropped pushes {int(main.overflow)}")
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
    main_img = img

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

    # ---- 7. the traversal-step probes and K1's step cap ----
    print(f"-- phase 7 at {time.perf_counter() - t_start:.1f} s")
    probes, probe_counts, k1_cap_err = _probes(card, tables, org, dirs)

    # ---- 8. the hardware probes ----
    print(f"-- phase 8 at {time.perf_counter() - t_start:.1f} s")
    hw_probes = _hw_probes(card)

    # ---- 9. the north star's call: the default settings ----
    print(f"-- phase 9 at {time.perf_counter() - t_start:.1f} s")
    ns = _north_star(card)

    # ---- 10. interlace ----
    print(f"-- phase 10 at {time.perf_counter() - t_start:.1f} s")
    il, il_pan = _interlace(card, settings, main.scene, cam0, frame_ms)

    # ---- 11. the headless entry point ----
    print(f"-- phase 11 at {time.perf_counter() - t_start:.1f} s")
    _headless(card)

    def main_step(k):
        pan(100 + k)
        main.render_frame_device(dt=1 / 60)

    # ---- 12. the animated terrain: per-frame BVH4 refit ----
    print(f"-- phase 12 at {time.perf_counter() - t_start:.1f} s")
    _animated(card, settings, main.scene, cam0, frame_ms, main_step)

    # ---- 13. ocean + stars at night ----
    print(f"-- phase 13 at {time.perf_counter() - t_start:.1f} s")
    _ocean_stars(card, settings, main.scene)

    # ---- 14. the two-level LBVH, rebuilt on the card ----
    print(f"-- phase 14 at {time.perf_counter() - t_start:.1f} s")
    lbvh = _lbvh(card, settings, main.scene, cam0, tables, k1_visits)

    # ---- 15. Fourier textures, the flat binary SAH tree, Preetham ----
    print(f"-- phase 15 at {time.perf_counter() - t_start:.1f} s")
    optin = _optin(card, settings, main.scene, cam0, tables, k1_visits,
                   lbvh[1]["ms"])

    # ---- 16. the denoiser's other branches, K5 bilinear, RTRT_DEBUG ----
    print(f"-- phase 16 at {time.perf_counter() - t_start:.1f} s")
    k5_bl = _denoiser_branches(card, settings, main.scene, cam0, main_img,
                               *k5_in, main_step)

    # ---- 17. image quality against a converged render ----
    print(f"-- phase 17 at {time.perf_counter() - t_start:.1f} s")
    _quality(card)

    # ---- 18. the HTTP viewer ----
    print(f"-- phase 18 at {time.perf_counter() - t_start:.1f} s")
    _viewer(card, settings, main.scene)

    # ---- 19. the wavefront integrator: trace="packets" and "loop" ----
    print(f"-- phase 19 at {time.perf_counter() - t_start:.1f} s")
    wave = _wavefront(card, settings, main.scene, cam0, frame_ms, main)

    # ---- 20. the row-sharded frame on the one card ----
    print(f"-- phase 20 at {time.perf_counter() - t_start:.1f} s")
    k5_band = _sharded(card, settings, k5_in)

    # ---- 21. the cut points, K2's step planes, the tools ----
    print(f"-- phase 21 at {time.perf_counter() - t_start:.1f} s")
    k2_steps = _cuts_and_tools(
        card, args, dict(n_lights=n_lights, bn=consts.bn),
        W * H * (40 + 72) + _table_bytes(tables), sum(k2_ops.values()))
    k2_seg3 = _three_segments(
        card, args, dict(n_lights=n_lights, bn=consts.bn), sc.sky, rays,
        camera_basis(cam0), W * H * (40 + 72) + _table_bytes(tables),
        main_step, main)

    if "--profile" in sys.argv[1:]:

        def il_step(k):
            il_pan(100 + k)
            il.render_frame_device(dt=1 / 60)

        low = ns["engine"]
        for _ in range(6):  # the controller moves one bucket a frame
            if low.render_h == 720:
                break
            low.render_frame_device(dt=1 / 200 if low.render_h < 720
                                    else 1 / 20)
        assert low.render_h == 720, low.render_h
        _profile(card, [
            ("main-path", main_step),
            ("720-bucket (upscaled to 1080p)",
             lambda k: low.render_frame_device(dt=1 / 60)),
            ("interlaced", il_step)])
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s {card}")

    route = "cuda"
    kernels = [
        dict(name="K1 traverse (BVH4 per-thread stack; in the frame its "
             "traversal runs inside K2 and its launcher reads 0 there: "
             "launches are probe_traverse's, phase 7)",
             route=route, source="rtrt_tpu_torch/csrc/traverse.cu",
             replaces="rtrt_tpu/bvh/packet.py:1104",
             launches=probe_counts["packet_intersect"],
             max_abs_err=max(k1_err, k1_cap_err), ms=k1_ms,
             plain_ms=k1_plain, bound_ms=k1_bound[0], bound_by=k1_bound[1],
             library_ms=None),
        dict(name="K2 megakernel (5-segment path trace as persistent lanes, "
             "per-launch sampler table, K1's traversal inside)", route=route,
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=counts["megakernel_trace"], max_abs_err=float(k2_err),
             ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        dict(name="K3 post tail (tonemap/sharpen/dither/u8)", route=route,
             source="rtrt_tpu_torch/csrc/post_tail.cu",
             replaces="rtrt_tpu/post/tail.py:177",
             launches=counts["post_tail"], max_abs_err=float(du.max()),
             ms=k3_ms, graph_ms=k3_graph, plain_ms=k3_plain,
             bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None),
        dict(name="K3 post tail on pre-mapped input (K3's MAPPED "
             "instantiation: sharpen/dither/u8 of the Catmull-Rom upscale's "
             "output, below the screen size; the TPU frame runs XLA ops "
             "there, rtrt_tpu/post/pipeline.py:78-95)", route=route,
             source="rtrt_tpu_torch/csrc/post_tail.cu",
             replaces="rtrt_tpu/post/tail.py:177",
             launches=ns["launches"], max_abs_err=ns["err"], ms=ns["ms"],
             graph_ms=ns["graph_ms"], plain_ms=ns["plain_ms"],
             bound_ms=ns["bound"][0], bound_by=ns["bound"][1],
             library_ms=None),
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
             ms=k5_ms, graph_ms=k5_graph, plain_ms=k5_plain,
             bound_ms=k5_bound[0], bound_by=k5_bound[1], library_ms=None),
        k5_bl, k5_band, k2_steps, k2_seg3,
    ] + lbvh + optin + [wave] + probes + hw_probes
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _ptxas(name):
    """(registers, spill stores in bytes) of the kernel whose mangled name
    holds `name`, from the build's ptxas log."""
    import re

    from rtrt_tpu_torch.utils import cuda
    lines = cuda.build_info["log"].splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry" in line and name in line)
    spill = next(line for line in lines[at:] if "spill stores" in line)
    regs = next(line for line in lines[at:] if "registers" in line)
    return (int(re.search(r"Used (\d+) registers", regs).group(1)),
            int(re.search(r"(\d+) bytes spill stores", spill).group(1)))


def _cuts_and_tools(card, args, kw, k2_bytes, k2_ops):
    """Phase 21 (module docstring): K2's step instantiation on phase 3's
    view (args, kw: its megakernel_trace arguments; k2_bytes, k2_ops: the
    default K2's bound inputs), the profile_frame cuts, fps_demo and the
    tools.  Returns the kernel line's entry for K2's step instantiation."""
    import tempfile

    import numpy as np
    import torch
    from rtrt_tpu_torch.content.mesher import voxels_to_mesh
    from rtrt_tpu_torch.content.meshio import load_mesh, save_obj
    from rtrt_tpu_torch.denoise.pipeline import denoise
    from rtrt_tpu_torch.engine.frame import render_frame
    from rtrt_tpu_torch.render import integrator as I
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.tools import (bluenoise_gen, fps_demo, mesh_baker,
                                      profile_frame, sky_compare,
                                      sky_preview)
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.timing import bound_ms, time_ms

    t_phase = time.perf_counter()
    dev = args[5].device
    n = W * H
    seg = I.SEGMENTS

    # (a) K2's step instantiation against the default one and the plain
    out_d = torch.empty((18, n), device=dev)
    out_s = torch.empty((18, n), device=dev)
    steps = torch.full((seg + 1, n), -1, dtype=torch.int32, device=dev)
    plain = torch.zeros((seg + 1, n), dtype=torch.int32, device=dev)
    M.megakernel_trace(*args, **kw, out=out_d)
    M.megakernel_trace(*args, **kw, out=out_s, steps=steps)
    visits = [0, 0]
    M.megakernel_trace_plain(*args, **kw, steps=plain, visits=visits)
    torch.cuda.synchronize()
    gbuf_equal = torch.equal(out_d, out_s)
    same = (steps == plain).all(0).float().mean().item()
    err = int((steps - plain).abs().max())
    print(f"K2 steps {W}x{H}: G-buffer planes bit-equal to the default "
          f"instantiation's: {gbuf_equal}; step planes equal to the plain "
          f"version's on {same:.6f} of pixels (max |d| {err}); visits "
          f"{int(steps[0].sum())} (plain {int(plain[0].sum())}, its "
          f"counter {visits[0] + visits[1]}); per pixel mean "
          f"{[round(x, 3) for x in steps.double().mean(1).tolist()]} "
          f"[total, seg0..seg4]")
    assert gbuf_equal, "K2 steps: G-buffer differs from the default's"
    assert (steps >= 0).all() and torch.equal(steps[1:].sum(0), steps[0])
    assert same >= 0.999, f"K2 steps agree with plain on {same}"
    assert int(plain[0].sum()) == visits[0] + visits[1]
    run_d = lambda: M.megakernel_trace(*args, **kw, out=out_d)
    run_s = lambda: M.megakernel_trace(*args, **kw, out=out_s, steps=steps)
    t_d, t_s = [], []
    for run, acc in ((run_d, t_d), (run_s, t_s), (run_s, t_s),
                     (run_d, t_d)):
        acc.append(time_ms(run, 10))
    s_ms, d_ms = sum(t_s) / 2, sum(t_d) / 2
    s_plain = time_ms(lambda: M.megakernel_trace_plain(
        *args, **kw, steps=plain), 1)
    s_bound = bound_ms(k2_bytes + n * 4 * (seg + 1), k2_ops)
    regs = {label: _ptxas(f"megakernelILi32ELi0ELb0ELb{flag}E")
            for label, flag in (("default", 0), ("steps", 1))}
    print(f"K2 steps time, {W}x{H}: kernel {s_ms:.4f} ms ({t_s}), the "
          f"default instantiation {d_ms:.4f} ms ({t_d}) in turns by CUDA "
          f"events; plain {s_plain:.1f} ms; bound {s_bound[0]:.4f} ms "
          f"({s_bound[1]}); BVH4 (stack 32) registers / spill stores: "
          f"{regs} {card}")
    assert regs["default"] == (64, 212), regs

    # (b) the cut points through profile_frame's entry point
    five = "bvh,trace,steps,denoise,full"
    r = profile_frame.main(["--stages", five, "--frames", "3"])
    eng = r["engine"]
    img, st, gb = render_frame(eng.static, eng.scene_data, r["state"],
                               eng.camera, eng.prev_camera, eng.params,
                               1 / 60, eng.consts, eng.overflow,
                               eng.stack_depth, eng.rest)
    outs = r["outputs"]
    assert torch.equal(outs["full"][0], img), "full cut != render_frame"
    planes = outs["trace"][0]
    for got, ref in zip(planes, (gb.color, gb.albedo, gb.normal, gb.depth,
                                 gb.mat_id, gb.motion), strict=True):
        assert torch.equal(got, ref), "trace cut != the frame's G-buffer"
    final, hist = outs["denoise"][0]
    for f in hist._fields:
        a, b = getattr(hist, f), getattr(st.history, f)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f
    ref_final, _ = denoise(*planes, r["state"].history, eng.params.denoise,
                           eng.flags, frame_parity=0)
    assert torch.equal(final, ref_final), "denoise cut != the denoiser"
    (sp,), _ = outs["steps"]
    assert tuple(sp.shape) == (seg + 1, H, W)
    assert torch.equal(sp[1:].sum(0), sp[0])
    want = dict(trace={"megakernel_trace": 1},
                steps={"megakernel_trace_steps": 1},
                denoise={"megakernel_trace": 1, "reproject": 1,
                         "denoise_wide": 4},
                full={"megakernel_trace": 1, "reproject": 1,
                      "denoise_wide": 4, "post_tail": 1})
    assert not any(k.startswith("megakernel") for k in r["launches"]["bvh"])
    for stop, counts in want.items():
        assert r["launches"][stop] == counts, (stop, r["launches"][stop])
    print(f"profile_frame cuts of one frame: full image bit-equal to "
          f"render_frame's, trace cut = its G-buffer, denoise cut = its "
          f"history and the denoiser on the trace planes; launches "
          f"{r['launches']} {card}")
    del eng, r, outs, planes, img, st, gb
    rb = profile_frame.main(["--rebuild", "--frames", "3"])
    assert not any(k.startswith("megakernel")
                   for k in rb["launches"]["bvh"]), rb["launches"]["bvh"]
    assert rb["launches"]["trace"] == {"megakernel_trace_binary": 1}
    del rb
    cuda.reset_launch_counts()  # the kernel line's launches: this run's
    ts = profile_frame.main(["--trace-steps"])
    steps_launches = cuda.launch_counts["megakernel_trace_steps"]
    assert steps_launches == 1, steps_launches  # its one steps-cut frame
    assert ts["rows"][0][1] == sum(row[1] for row in ts["rows"][1:])
    del ts

    # (c) the dynamic-resolution demo
    recs = fps_demo.run(height=H, frames=4)
    print(f"fps_demo: buckets {[x['bucket_h'] for x in recs[:-1]]}, "
          f"sustained {recs[-1]['res']} {recs[-1]['ms_per_frame']} ms/frame "
          f"{card}")

    # (d) the tools on the card
    with tempfile.TemporaryDirectory() as tmp:
        assert sky_preview.main([tmp, "--sweep", "3"]) == 0
        pngs = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
        assert pngs == ["sky_map.png", "sky_pdf.png", "sun_map.png",
                        "sweep.png"], pngs
        assert sky_compare.main(["--samples", "1000"]) == 0
        solid = np.random.default_rng(21).uniform(size=(6, 4, 6)) < 0.5
        v, f = voxels_to_mesh(solid)
        save_obj(os.path.join(tmp, "blocks.obj"), v, f)
        baked = os.path.join(tmp, "blocks.npz")
        assert mesh_baker.main([os.path.join(tmp, "blocks.obj"), baked,
                                "--subdivide", "1"]) == 0
        bv, bf = load_mesh(baked)
        assert len(bf) == 4 * len(f) and bf.max() < len(bv)
        bn = os.path.join(tmp, "bn.npy")
        t0 = time.perf_counter()
        assert bluenoise_gen.main(["--out", bn, "--size", "32"]) == 0
        m = np.load(bn)
        assert m.shape == (32, 32, len(bluenoise_gen.SEEDS))
        for c in range(m.shape[-1]):  # a rank mask: every rank once
            ranks = np.sort(np.round(m[..., c].reshape(-1) * 1024 - 0.5)
                            .astype(int))
            assert (ranks == np.arange(1024)).all()
        print(f"tools: sky_preview {pngs}, mesh_baker {len(f)} -> "
              f"{len(bf)} tris, bluenoise_gen 32x32 in "
              f"{time.perf_counter() - t0:.2f} s {card}")
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s {card}")
    return dict(
        name="K2 megakernel, traversal-step instantiation (kSteps: each "
        "path's node + leaf visits a segment, the frame's steps cut; "
        "launches: the steps-cut frame of profile_frame --trace-steps, "
        "phase 21)",
        route="cuda", source="rtrt_tpu_torch/csrc/megakernel.cu",
        replaces="rtrt_tpu/render/megakernel.py:707",
        launches=steps_launches, max_abs_err=float(err), ms=s_ms,
        plain_ms=s_plain, bound_ms=s_bound[0], bound_by=s_bound[1],
        library_ms=None)


def _three_segments(card, args, kw, sky, rays, prev_basis, k2_bytes, step,
                    eng):
    """Phase 21 (e): K2 at segments=3, the route RTRT_SEGMENTS=3 takes.
    On phase 3's view and rays (args, kw: its megakernel_trace arguments;
    sky, rays, prev_basis for _check_k2) K2 at 3 against its plain version
    at 3, at phase 3's bounds, and unlike the 5-segment launch; K2 at 3
    and at the default 5 timed in turns by CUDA events; the bound from
    the plain version's visits and hits at 3.  Then the main path (`step`,
    which renders a frame of `eng`, phase 5's Engine) renders 3 frames with
    render/integrator.py's count, the one both routes read, set to 3 as
    the variable sets it at import: K2 launches once a frame, counted from
    0 just before.  The last of them is rendered again at the default
    count from the same frame state: its first-hit planes (albedo,
    normal, depth, material) must be equal, its radiance not.  Returns
    the kernels-line entry."""
    import torch
    from rtrt_tpu_torch.render import integrator as I
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.timing import bound_ms, time_ms

    t_phase = time.perf_counter()
    a = M.megakernel_trace(*args, **kw, segments=3)
    visits, hits = [0, 0], [0, 0, 0]
    b = M.megakernel_trace_plain(*args, **kw, segments=3, visits=visits,
                                 hits=hits)
    five = M.megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    _, _, err = _check_k2("at segments=3", sky, rays, a, b, prev_basis)
    assert not (torch.equal(a.radiance, five.radiance)
                and torch.equal(a.esc_beta, five.esc_beta)), \
        "K2 at 3 segments traced what it traces at 5"
    t3, t5 = [], []
    for segs, acc in ((5, t5), (3, t3), (3, t3), (5, t5)):
        acc.append(time_ms(lambda: M.megakernel_trace(*args, **kw,
                                                      segments=segs), 10))
    plain_ms = time_ms(lambda: M.megakernel_trace_plain(*args, **kw,
                                                        segments=3), 1)
    ops = (visits[0] * NODE_OPS + visits[1] * LEAF_OPS + hits[0] * SURF_OPS
           + hits[1] * SOIL_OPS + hits[2] * BSDF_OPS)
    bnd = bound_ms(k2_bytes, ops)
    saved = I.SEGMENTS
    I.SEGMENTS = 3
    try:
        cuda.reset_launch_counts()
        for k in range(3):
            before = eng.state
            step(300 + k)
        torch.cuda.synchronize()
        launches = cuda.launch_counts["megakernel_trace"]
        g3 = eng.last_gbuffer
    finally:
        I.SEGMENTS = saved
    assert launches == 3, f"K2 at 3 segments launched {launches} times"
    eng.state = before
    step(302)
    g5 = eng.last_gbuffer
    torch.cuda.synchronize()
    for f in ("albedo", "normal", "depth", "mat_id"):
        assert torch.equal(getattr(g3, f), getattr(g5, f)), \
            f"the main path at 3 segments: {f} unlike the frame at 5"
    assert torch.isfinite(g3.color).all()
    assert not torch.equal(g3.color, g5.color), \
        "the main path at 3 segments traced what it traces at 5"
    m3, m5 = g3.color.mean().item(), g5.color.mean().item()
    print(f"K2 at segments=3: kernel {sum(t3) / 2:.4f} ms ({t3}), at 5 "
          f"{sum(t5) / 2:.4f} ms ({t5}) in turns by CUDA events; plain "
          f"{plain_ms:.1f} ms; per pixel {visits[0] / a.depth.numel():.2f} "
          f"node and {visits[1] / a.depth.numel():.2f} leaf visits; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}); the main path at 3 segments: "
          f"{launches} K2 launches over 3 frames, the last frame's mean "
          f"G-buffer radiance {m3:.7g} against {m5:.7g} for the same frame "
          f"at 5 segments (first-hit planes equal); phase 21 (e) took "
          f"{time.perf_counter() - t_phase:.1f} s {card}")
    return dict(
        name="K2 megakernel at segments=3 (RTRT_SEGMENTS=3's route: the "
        "launch's segment count; launches: 3 frames of the main path with "
        "the count at 3, phase 21 (e))",
        route="cuda", source="rtrt_tpu_torch/csrc/megakernel.cu",
        replaces="rtrt_tpu/render/megakernel.py:707", launches=launches,
        max_abs_err=float(err), ms=sum(t3) / 2, plain_ms=plain_ms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def _sharded(card, settings, k5_in):
    """Phase 20: the row-sharded frame (rtrt_tpu_torch/parallel/
    frame_spmd.py) on the one card.  (a) K5's band instantiation: on phase
    3e's 1080p history and camera motion, the launch over each of 4 bands,
    in both filters, equal to the same rows of the full launch bit for bit;
    timed by events and graph replay beside its bound for the band's
    bytes.  (b) The 1080p terrain with default flags, 3 frames of phase 5's
    pan, 4 ranks sharing cuda:0 over gloo (spawned after phase 2's build,
    so that they load the library): rank 0's gathered images within 1 u8
    of the single-process frames of the same cameras on every pixel and
    differing on < 5% (the pixels that differ printed, with the stage of
    the first difference), each rank's history (270, 1920), its launches
    per frame K2 1, K5's band instantiation 1, K4 4, K3 1, 0 dropped
    pushes.  (c) The same frames under nccl at world size 1 in this
    process: bit-equal to the single-process frames.  (d) The loop route
    at 480x270, 2 ranks sharing the card, one frame against the
    single-process loop frame as in (b).  Prints each rank's ms/frame by
    host clock, its device busy ms (torch.profiler, one frame) and the
    bytes it fetched a frame, beside the single-process frame's ms.
    Returns the kernels-line entry of K5's band instantiation."""
    import tempfile

    import torch
    import torch.distributed as dist
    from rtrt_tpu_torch.denoise.reproject import reproject, reproject_plain
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.parallel import frame_spmd as S
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags
    from rtrt_tpu_torch.utils.timing import bound_ms, time_graph_ms, time_ms

    # ---- (a) K5's band instantiation against the full launch ----
    hist, motions = k5_in
    mv = motions[0][1]
    n_bands, fields = 4, ("color", "color2", "depth", "count", "mat_id",
                          "ok")
    for filt in ("catmull_rom", "bilinear"):
        full = reproject(*hist, mv, history_filter=filt)
        for b in range(n_bands):
            r0, r1 = b * H // n_bands, (b + 1) * H // n_bands
            got = reproject(*hist, mv[r0:r1].contiguous(),
                            history_filter=filt, row0=r0)
            torch.cuda.synchronize()
            bad = [f for f in fields
                   if not torch.equal(getattr(got, f),
                                      getattr(full, f)[r0:r1])]
            assert not bad, f"K5 band {b} ({filt}) differs in {bad}"
    print(f"K5 band instantiation: each of {n_bands} bands of {H // n_bands} "
          f"rows equal to the full launch's rows bit for bit, Catmull-Rom "
          f"and bilinear, camera motion {card}")
    r0, r1 = H // n_bands, 2 * H // n_bands
    mv_b = mv[r0:r1].contiguous()
    k5b = lambda: reproject(*hist, mv_b, row0=r0)
    wide = [x.to(torch.float32) for x in hist]
    k5b_plain = lambda: reproject_plain(*wide[:3], hist[3], wide[4], mv_b,
                                        row0=r0)
    k5b_err = _k5_check(f"K5 band, rows [{r0}, {r1}) of {H}", k5b(),
                        k5b_plain())
    k5b_plain_ms = time_ms(k5b_plain, 3)
    k5b_ms = time_ms(k5b, 20)
    k5b_graph = time_graph_ms(k5b, 20, 20)
    k5_full = time_graph_ms(lambda: reproject(*hist, mv), 20, 20)
    # the band's pixels: their 8 bf16 taps' planes, material and motion in
    # (28 B), 9 f32 planes and ok out (37 B), as phase 3e's bound
    k5b_bound = bound_ms((r1 - r0) * W * (28 + 37),
                         (r1 - r0) * W * K5_PX_OPS)
    print(f"K5 band ({r1 - r0} of {H} rows): {k5b_ms:.4f} ms by events, "
          f"{k5b_graph:.4f} ms by graph replay (the full launch "
          f"{k5_full:.4f} in this call), plain {k5b_plain_ms:.3f} ms; bound "
          f"{k5b_bound[0]:.4f} ms ({k5b_bound[1]}) {card}")

    # ---- the single-process frames of the same cameras ----
    def single(sets, trace, frames):
        """The frames of S.run_rank's pan in one process."""
        sets = dataclasses.replace(sets, texture_size=S.TEXTURE_SIZE)
        eng = Engine(sets, flags=FeatureFlags(), trace=trace, device="cuda")
        cam0, out, ms = eng.camera, [], []
        for k in range(frames):
            eng.camera = dataclasses.replace(
                cam0, yaw=cam0.yaw + S.PAN_STEP * k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = eng.render_frame_device(dt=1 / 60)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hs = eng.state.history
            out.append(dict(image=img.cpu(),
                            trace=eng.last_gbuffer.color.cpu(),
                            denoise_7x7=hs.color.cpu(),
                            denoise=hs.color2.cpu()))
        assert int(eng.overflow) == 0
        return out, ms

    def held(label, ref, recs):
        """Rank 0's gathered images against the single-process ones: within
        1 u8 everywhere, < 5% of pixels differing; the stage where a
        difference first shows."""
        for k, r in enumerate(ref):
            d = (recs[0]["images"][k].int() - r["image"].int()).abs()
            n = int((d.max(-1).values > 0).sum())
            first = None
            for st in ("trace", "denoise_7x7", "denoise"):
                if n and first is None and st in r:
                    whole = torch.cat([rec["stages"][k][st] for rec in recs])
                    if not torch.equal(whole, r[st]):
                        first = st
            print(f"{label}, frame {k}: {n} pixels differ from the "
                  f"single-process frame (max {int(d.max())} u8)"
                  + (f"; first in stage {first or 'post'}" if n else ""))
            assert d.max() <= 1 and n < 0.05 * d[..., 0].numel(), \
                (label, k, int(d.max()), n)

    cfg = dict(device="cuda", scene="terrain", width=W, height=H, frames=3,
               trace="megakernel")
    ref, ref_ms = single(settings, "megakernel", cfg["frames"])
    cuda.library()  # built in phase 2: the ranks load it

    def run(world, c):
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            S.spawn(S.run_rank, world, (c, out), "cuda", share_device=True)
            print(f"{world} ranks sharing cuda:0 over gloo: "
                  f"{time.perf_counter() - t0:.1f} s with start-up")
            return [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]

    def report(label, recs, single_ms):
        for rec in recs:
            ms = rec["ms"][1:] or rec["ms"]
            busy = ("not measured" if rec["busy_ms"] is None
                    else f"{rec['busy_ms']:.3f} ms and {rec['launches']} "
                         f"launches (one frame, torch.profiler; top ops "
                         f"{rec['top_ops']})")
            print(f"{label} rank {rec['rank']} ({rec['backend']}, rows "
                  f"{rec['rows']}): {sum(ms) / len(ms):.2f} ms/frame by "
                  f"host clock (frames {rec['ms']}), device busy {busy}, "
                  f"fetched {rec['fetched']} bytes a frame; launches a "
                  f"frame {rec['counts']} {card}")
        print(f"{label}: the single-process frame {single_ms} ms by host "
              f"clock in this call {card}")

    # ---- (b) 4 ranks sharing the card over gloo, megakernel route ----
    recs = run(4, cfg)
    report("sharded 1080p, 4 ranks", recs, ref_ms)
    held("sharded 1080p, 4 ranks", ref, recs)
    print(f"sharded 1080p, 4 ranks: history planes "
          f"{[rec['history_shapes'] for rec in recs][0]} on each rank")
    for rec in recs:
        assert all(v[:2] == (H // 4, W)
                   for v in rec["history_shapes"].values()), \
            rec["history_shapes"]
        assert rec["band_shape"] == (H // 4, W, 3), rec["band_shape"]
        assert rec["overflow"] == 0, rec["overflow"]
        for k, c in enumerate(rec["counts"]):
            want = dict(megakernel_trace=1, reproject_band=1, denoise_wide=4,
                        post_tail=1)
            assert c == want, (rec["rank"], k, c)
    k5b_launches = sum(c.get("reproject_band", 0) for rec in recs
                       for c in rec["counts"])

    # ---- (c) nccl at world size 1 on cuda:0, in this process ----
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, timeout=S.TIMEOUT)
        try:
            one = [S.run_rank(0, cfg)]
        finally:
            dist.destroy_process_group()
    report("nccl, world size 1", one, ref_ms)
    for k, r in enumerate(ref):
        assert torch.equal(one[0]["images"][k], r["image"]), \
            f"nccl world size 1, frame {k}: not bit-equal"
    assert one[0]["counts"][0] == dict(megakernel_trace=1, reproject=1,
                                       denoise_wide=4, post_tail=1), \
        one[0]["counts"]
    print(f"nccl, world size 1: {cfg['frames']} frames bit-equal to the "
          f"single-process frames {card}")

    # ---- (d) the loop route, 2 ranks sharing the card, 480x270 ----
    small = dataclasses.replace(settings, render_width=480,
                                render_height=270)
    lcfg = dict(cfg, width=480, height=270, trace="loop", frames=1)
    lref, lref_ms = single(small, "loop", 1)
    lrecs = run(2, lcfg)
    report("loop route 480x270, 2 ranks", lrecs, lref_ms)
    held("loop route 480x270, 2 ranks", lref, lrecs)
    for rec in lrecs:
        assert rec["overflow"] == 0
        assert rec["counts"][0].get("megakernel_trace", 0) == 0
        assert rec["counts"][0]["reproject_band"] == 1, rec["counts"]
    return dict(
        name="K5 history reprojection, band instantiation (row0, rows: a "
             "rank's rows of the row-sharded frame from the whole history; "
             "Catmull-Rom; launches over phase 20's 4 ranks)",
        route="cuda", source="rtrt_tpu_torch/csrc/reproject.cu",
        replaces="rtrt_tpu/denoise/reproject.py:244",
        launches=k5b_launches, max_abs_err=k5b_err, ms=k5b_ms,
        graph_ms=k5b_graph, plain_ms=k5b_plain_ms, bound_ms=k5b_bound[0],
        bound_by=k5b_bound[1], library_ms=None)


def _k5_check(label, got, ref):
    """K5 against its plain version at phase 3e's bounds: colour within
    rtol 1e-5 + atol 1e-6 on >= 99.99% of pixels, the nearest planes and ok
    equal.  Returns the largest colour difference."""
    import torch
    torch.cuda.synchronize()
    err_max, fr = 0.0, {}
    for f in ("color", "color2"):
        a_, b_ = getattr(got, f), getattr(ref, f)
        err = (a_ - b_).abs()
        err_max = max(err_max, err.max().item())
        fr[f] = ((err <= 1e-6 + 1e-5 * b_.abs()).all(-1)
                 ).float().mean().item()
    exact = {f: torch.equal(getattr(got, f), getattr(ref, f))
             for f in ("depth", "count", "mat_id", "ok")}
    print(f"{label}: colour within rtol 1e-5 + atol 1e-6 on {fr}; exact "
          f"{exact}; ok on {got.ok.float().mean().item():.4f} of pixels")
    assert min(fr.values()) >= 0.9999, f"{label} colour {fr}"
    assert all(exact.values()), f"{label} nearest planes {exact}"
    return err_max


def _denoiser_branches(card, settings, scene, cam0, main_img, hist, motions,
                       main_step):
    """Phase 16: the denoiser's other branches.  The Engine with
    FeatureFlags(temporal_filter=False) (its second temporal pass fetches
    history through the ±1 px shift stencil); K5's bilinear instantiation
    against its plain version on phase 3e's history and motions, timed
    beside its bound and F.grid_sample, then driven through the main
    Engine's frames with RTRT_HISTORY_FILTER's module default set to
    "bilinear"; the RTRT_DEBUG NaN guards.  Returns the kernels-line entry
    of K5's bilinear instantiation."""
    import contextlib
    import io
    import re

    import torch
    import torch.nn.functional as Fn
    from rtrt_tpu_torch.denoise import reproject as R
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils import debug
    from rtrt_tpu_torch.utils.config import FeatureFlags
    from rtrt_tpu_torch.utils.timing import bound_ms, time_graph_ms, time_ms

    # ---- the Engine with temporal_filter off ----
    eng = Engine(settings, flags=FeatureFlags(temporal_filter=False),
                 scene=scene, device="cuda")
    n_warm, n_timed = 3, 5
    nf = n_warm + n_timed
    cuda.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, k in enumerate(range(WARMUP + TIMED - nf, WARMUP + TIMED)):
            if i == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            # phase 5's pans: the last frame sees phase 5's last camera
            eng.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)
            img = eng.render_frame_device(dt=1 / 60)
            assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    counts = dict(cuda.launch_counts)
    print(f"temporal_filter=False: {ms:.2f} ms/frame over {n_timed} frames "
          f"(host clock around synchronize, sync debug 'error' on all "
          f"{nf}), {W}x{H} terrain {card}")
    print(f"temporal_filter=False launch counts over {nf} frames: "
          f"{ {k: v for k, v in counts.items() if v} }")
    want = dict(megakernel_trace=nf, denoise_wide=4 * nf, post_tail=nf,
                reproject=0, reproject_bilinear=0)
    for k, n in want.items():
        assert counts[k] == n, f"temporal_filter=False: {k} launched " \
            f"{counts[k]} times, not {n}"
    h_ = eng.state.history
    assert h_.valid
    for f in ("color", "color2", "count"):
        assert torch.isfinite(getattr(h_, f).float()).all(), \
            f"history {f} not finite"
    assert not torch.isnan(h_.depth.float()).any(), "NaN in history depth"
    differs = ((img.int() - main_img.int()).abs().amax(-1) > 0).float()
    print(f"temporal_filter=False: the image differs from phase 5's frame "
          f"(the same camera, default flags) on {differs.mean().item():.4f} "
          f"of pixels, mean |du8| "
          f"{(img.float() - main_img.float()).abs().mean().item():.3f}")
    assert differs.mean().item() > 0.01, "temporal_filter=False changed " \
        "nothing"
    busy, n_launch, _, kern_ev = _busy(lambda k: (
        setattr(eng, "camera", dataclasses.replace(
            cam0, yaw=cam0.yaw + 0.002 * (100 + k))),
        eng.render_frame_device(dt=1 / 60)), 3)
    print(f"temporal_filter=False: device busy {busy:.3f} ms/frame, "
          f"{n_launch:.1f} kernel launches/frame (torch.profiler over 3 "
          f"frames); top {_top(kern_ev, 3)} {card}")
    del eng

    # ---- K5's bilinear instantiation against its plain version ----
    wide = lambda x: x.to(torch.float32)
    plain = lambda mv: R.reproject_plain(
        wide(hist[0]), wide(hist[1]), wide(hist[2]), hist[3], wide(hist[4]),
        mv, history_filter="bilinear")
    kern = lambda mv: R.reproject(*hist, mv, history_filter="bilinear")
    err = max(_k5_check(f"K5 bilinear {label}, {W}x{H}", kern(mv), plain(mv))
              for label, mv in motions)
    mv_cam = motions[0][1]
    t_ev = time_ms(lambda: kern(mv_cam), 20)
    t_graph = time_graph_ms(lambda: kern(mv_cam), 20, 20)
    t_cr = time_graph_ms(lambda: R.reproject(*hist, mv_cam,
                                             history_filter="catmull_rom"),
                         20, 20)
    t_plain = time_ms(lambda: plain(mv_cam), 3)
    # the Catmull-Rom instantiation's bytes; 4 taps in place of 16
    bound = bound_ms(W * H * (28 + 37), W * H * K5_BL_PX_OPS)
    # the library yardstick: F.grid_sample's bilinear colour resampling of
    # both colour planes (one (1, 6, H, W) tensor) at the same points
    # (align_corners=True, border padding).  It takes its grid in the
    # input's dtype, and a bf16 grid cannot address 1920 columns, so it
    # reads the widened float32 history; laying out its inputs is not
    # timed, and it makes no nearest planes and no ok
    planes = torch.cat([wide(hist[0]), wide(hist[1])], -1).permute(
        2, 0, 1)[None].contiguous()
    ys, xs = torch.meshgrid(torch.arange(H, device=mv_cam.device,
                                         dtype=torch.float32),
                            torch.arange(W, device=mv_cam.device,
                                         dtype=torch.float32), indexing="ij")
    grid = torch.stack([(xs + mv_cam[..., 0] * W) / (W - 1) * 2 - 1,
                        (ys + mv_cam[..., 1] * H) / (H - 1) * 2 - 1],
                       -1)[None].contiguous()
    gs = lambda: Fn.grid_sample(planes, grid, mode="bilinear",
                                padding_mode="border", align_corners=True)
    t_lib = time_graph_ms(gs, 20, 20)
    ref_c = kern(mv_cam)
    lib = gs()[0].permute(1, 2, 0)
    both = torch.cat([ref_c.color, ref_c.color2], -1)
    # the grid's normalised coordinates (x / (W - 1) * 2 - 1, and back
    # inside grid_sample) move a position by a few ulps of 2048, ~5e-4 px,
    # and the weights with it: the two agree up to that rounding
    d = (lib - both).abs()
    tight = (d <= 1e-5 + 1e-4 * both.abs()).all(-1).float().mean().item()
    close = (d <= 1e-4 + 2e-3 * both.abs()).all(-1).float().mean().item()
    print(f"K5 bilinear: F.grid_sample against the kernel's colour: within "
          f"rtol 1e-4 + atol 1e-5 on {tight:.6f} of pixels, rtol 2e-3 + "
          f"atol 1e-4 on {close:.6f}")
    assert close >= 0.999, "F.grid_sample computes another function"
    print(f"K5 bilinear time, {W}x{H}, camera motion: kernel {t_ev:.4f} ms "
          f"by events, {t_graph:.4f} ms by graph replay (Catmull-Rom "
          f"{t_cr:.4f} in this call), plain {t_plain:.3f} ms, F.grid_sample "
          f"{t_lib:.4f} ms by graph replay; bound {bound[0]:.4f} ms "
          f"({bound[1]}), {bound[0] / t_graph:.0%} of it {card}")

    # ---- the bilinear instantiation on the main path ----
    cuda.reset_launch_counts()
    saved = R.HISTORY_FILTER
    R.HISTORY_FILTER = "bilinear"  # what RTRT_HISTORY_FILTER=bilinear sets
    try:
        for k in range(3):
            main_step(k)
        torch.cuda.synchronize()
    finally:
        R.HISTORY_FILTER = saved
    counts = dict(cuda.launch_counts)
    print(f"main path with RTRT_HISTORY_FILTER=bilinear, 3 frames: "
          f"{ {k: v for k, v in counts.items() if v} }")
    assert counts["reproject_bilinear"] == 3 and counts["reproject"] == 0
    launches = counts["reproject_bilinear"]

    # ---- the RTRT_DEBUG guards (outside sync-debug mode) ----
    x = torch.ones((H, W, 3), device="cuda")
    x[0, 0, 0], x[5, 7, 1], x[-1, -1, 2] = float("nan"), float("inf"), \
        -float("inf")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        y = debug.nan_guard(x, "smoke", enabled=True)
    assert buf.getvalue() == "[nan_guard:smoke] bad values: 3\n", \
        buf.getvalue()
    assert torch.isfinite(y).all() and float(y.sum()) == x.numel() - 3
    buf = io.StringIO()
    saved = debug.DEBUG
    debug.DEBUG = True  # what RTRT_DEBUG=1 sets
    try:
        with contextlib.redirect_stdout(buf):
            main_step(3)
            torch.cuda.synchronize()
    finally:
        debug.DEBUG = saved
    found = dict(re.findall(r"\[nan_guard:([\w.]+)\] bad values: (\d+)",
                            buf.getvalue()))
    print(f"RTRT_DEBUG guards on a default-flags frame: {found}")
    assert found == {lab: "0" for lab in (
        "trace.radiance", "trace.albedo", "trace.normal", "trace.motion",
        "denoise.remodulated")}, found
    return dict(name="K5 history reprojection, bilinear instantiation "
                "(RTRT_HISTORY_FILTER=bilinear: 4 taps + nearest, bf16 "
                "history; launches: 3 main-path frames with the filter set)",
                route="cuda", source="rtrt_tpu_torch/csrc/reproject.cu",
                replaces="rtrt_tpu/denoise/reproject.py:244",
                launches=launches, max_abs_err=err, ms=t_ev,
                graph_ms=t_graph, plain_ms=t_plain, bound_ms=bound[0],
                bound_by=bound[1], library_ms=t_lib)


def _quality(card):
    """Phase 17: tools/quality.py's measure at 1920x1080 on the terrain, 64
    spp and 48 frames: the ceiling, the trajectory, the final SSIM >= 0.90
    (PARITY.md's product bar)."""
    from rtrt_tpu_torch.tools.quality import measure

    r = measure(W, H, 64, 48, "terrain", device="cuda",
                log=lambda line: print(f"quality: {line} {card}"))
    print(f"quality: {W}x{H} terrain, denoised stream SSIM {r['final']:.4f} "
          f"after 48 frames against the 64-spp converged render, ceiling "
          f"{r['ceiling']:.4f} {card}; the JAX package's recorded 0.952 "
          f"(VERDICT.md:10) is a TPU run against a 96-spp reference, not "
          f"this card's")
    assert r["final"] >= 0.90, f"SSIM {r['final']} below the 0.90 bar"


def _viewer(card, settings, scene):
    """Phase 18: the HTTP viewer on the 1080p terrain: its routes, input,
    one frame of the stream, a clean stop; K2, K5, K4 and K3 launched."""
    import json
    import urllib.request

    import numpy as np
    from rtrt_tpu_torch.app.viewer import ViewerServer
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import PARAM_REGISTRY
    from rtrt_tpu_torch.utils.image import decode_png

    eng = Engine(settings, scene=scene, device="cuda")
    cuda.reset_launch_counts()
    v = ViewerServer(eng, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{v.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read()

    def post(obj):
        req = urllib.request.Request(base + "/input", method="POST",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 204, r.status

    def wait(cond, what):
        t0 = time.perf_counter()
        while not cond():
            assert v.error is None, v.error
            assert time.perf_counter() - t0 < 60, f"viewer: {what}"
            time.sleep(0.02)

    try:
        assert b'<img id="view" src="/stream">' in get("/")
        ps = json.loads(get("/params"))
        assert [p["path"] for p in ps] == [r[0] for r in PARAM_REGISTRY]
        assert len(ps) == 19
        for p in ps:
            assert p["min"] <= p["value"] <= p["max"], p
        with urllib.request.urlopen(base + "/stream", timeout=60) as r:
            assert r.readline() == b"--f\r\n"
            r.readline()
            n = int(r.readline().split(b":")[1])
            r.readline()
            frame = decode_png(r.read(n))
        assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
        pos0 = eng._camera_host()[:3].copy()
        post({"key": "w", "down": True})
        wait(lambda: not np.array_equal(eng._camera_host()[:3], pos0),
             "the camera did not move with 'w' held")
        post({"key": "w", "down": False})
        post({"param": "post.bloom_strength", "value": 0.2})
        assert eng.params.post.bloom_strength == 0.2
        wait(lambda: eng.timer.fps > 0, "no fps after a second")
        stats = json.loads(get("/stats"))
        assert set(stats) == {"fps", "w", "h"}, stats
    finally:
        v.stop()
    counts = dict(cuda.launch_counts)
    print(f"viewer: routes served, camera moved "
          f"{np.linalg.norm(eng._camera_host()[:3] - pos0):.3f} units with "
          f"'w' held, stream frame {frame.shape}, stats {stats}, stopped; "
          f"launches { {k: c for k, c in counts.items() if c} } {card}")
    for k in ("megakernel_trace", "reproject", "denoise_wide", "post_tail"):
        assert counts[k] > 0, f"viewer: {k} never launched"


def _wavefront(card, settings, scene, cam0, mega_ms, mega):
    """Phase 19: the wavefront integrator through the Engine.  (a)
    Engine(terrain, 1920x1080, trace="packets") renders 3 warm-up and 5
    timed frames of the slow pan under sync debug "error", the launch
    counters reset just before: K1 5 a frame, K2 0, K5 1, K4 4, K3 1; its
    device busy and launches per frame beside those of `mega`, the main
    path's megakernel Engine, on the same view; (b) one frame with each
    K1 launch's rays recorded: the primary G-buffer and the raw colour
    against the megakernel frame of the same state and camera, K1 timed
    per segment, and K1 against its plain version on all the frame's rays
    in one batch (primaries, bounce and shadow rays, finished lanes with
    t_max 0), then on the same rays with a finite t_max on half the live
    lanes, the tri ids of each bounce segment also alone; (c)
    Engine(terrain, 480x270, trace="loop") (sync debug off: the loop
    syncs a step) against the packet route's frame of the same state; (d)
    the packet route on the animated terrain, the refitted BVH4 and the
    rebuilt LBVH: 3 frames each under sync debug "error", 5 K1 launches a
    frame of the tree's instantiation.  Returns the kernels-line entry of
    K1's wavefront route."""
    import numpy as np
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.render import integrator as I
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags
    from rtrt_tpu_torch.utils.timing import bound_ms, time_ms

    t_phase = time.perf_counter()
    segs = I.SEGMENTS
    eng = Engine(settings, flags=FeatureFlags(), scene=scene,
                 trace="packets", device="cuda")
    assert not eng.static.use_megakernel and eng.static.use_packets
    tables = eng.scene_data.tables

    def pan(k, e=eng):
        e.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    # (a) the timed frames: launches and no host sync
    n_warm, n_timed = 3, 5
    cuda.reset_launch_counts()
    eng.overflow.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(n_warm + n_timed):
            if k == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            pan(k)
            img = eng.render_frame_device(dt=1 / 60)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wave_ms = (time.perf_counter() - t0) / n_timed * 1e3
    counts = dict(cuda.launch_counts)
    nf = n_warm + n_timed
    print(f"wavefront frame (Engine(terrain, {W}x{H}, trace='packets'), "
          f"default FeatureFlags): {wave_ms:.2f} ms/frame over {n_timed} "
          f"frames (host clock around synchronize, sync debug 'error' on "
          f"all {nf}); megakernel main path {mega_ms:.2f} ms/frame in this "
          f"run; dropped pushes {int(eng.overflow)} {card}")
    print(f"wavefront launch counts over {nf} frames: "
          f"{ {k: v for k, v in counts.items() if v} }")
    want = dict(packet_intersect=segs * nf, megakernel_trace=0,
                post_tail=nf, denoise_wide=4 * nf, reproject=nf)
    for k, v in want.items():
        assert counts[k] == v, f"wavefront: {k} launched {counts[k]}, not {v}"
    assert not [k for k, v in counts.items() if v and k.startswith(
        "megakernel_trace")], "wavefront: a K2 instantiation launched"
    assert int(eng.overflow) == 0, "wavefront: dropped pushes"
    assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
    k1_launches = counts["packet_intersect"]
    busy = {}
    for label, e in (("wavefront", eng), ("megakernel", mega)):
        busy[label] = _busy(lambda k, e=e: (
            pan(100 + k, e), e.render_frame_device(dt=1 / 60)), 3)
        print(f"{label} frame, the same view: device busy "
              f"{busy[label][0]:.3f} ms/frame, {busy[label][1]:.1f} kernel "
              f"launches/frame (torch.profiler over 3 frames); top "
              f"{_top(busy[label][3], 3, 6)} {card}")

    # (b) one frame with K1's inputs recorded, against the megakernel
    # frame of the same state and camera
    rec = []
    launch = I.packet_intersect

    def recording(tbl, org, dirs, t_max=None, **kw):
        rec.append((org.clone(), dirs.clone(), t_max.clone()))
        return launch(tbl, org, dirs, t_max, **kw)

    pan(200)
    state, cam = eng.state, eng.camera
    args = (eng.scene_data, state, cam, cam, eng.params, 1 / 60, eng.consts)
    I.packet_intersect = recording
    try:
        _, _, gw = F.render_frame(eng.static, *args, overflow=eng.overflow)
    finally:
        I.packet_intersect = launch
    _, _, gm = F.render_frame(dataclasses.replace(
        eng.static, use_megakernel=True), *args)
    torch.cuda.synchronize()
    assert len(rec) == segs, f"{len(rec)} K1 launches in a frame"
    same = (gw.mat_id == gm.mat_id) & (
        torch.isclose(gw.depth, gm.depth, rtol=1e-5, atol=0)
        | (torch.isinf(gw.depth) & torch.isinf(gm.depth))) & (
        (gw.normal - gm.normal).abs().amax(-1) <= 1e-3)
    frac = same.float().mean().item()
    raw_w, raw_m = gw.color * gw.albedo, gm.color * gm.albedo
    raw_eq = ((raw_w - raw_m).abs().amax(-1) <= 1e-3).float().mean().item()
    print(f"wavefront primary G-buffer against the megakernel frame of the "
          f"same state and camera: mat id equal, depth within rtol 1e-5 and "
          f"normal within 1e-3 on {frac:.6f} of pixels; raw colour within "
          f"1e-3 on {raw_eq:.6f}")
    assert frac >= 0.999, f"wavefront primary G-buffer equal on {frac}"
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(gw, f)).all(), f"wavefront {f}"

    seg_ms = [time_ms(lambda r=r: P.packet_intersect(tables, *r), 10)
              for r in rec]
    live_n = [int((r[2] > 0).sum()) for r in rec]
    print(f"K1 per wavefront segment, {W}x{H} rays: "
          f"{[round(x, 4) for x in seg_ms]} ms (segment 0 the primaries); "
          f"live lanes per segment {live_n} (the others finished: t_max 0) "
          f"{card}")
    # K1 against its plain version on all of the frame's rays in one batch
    # (phase 3's share rule is a share of hits: on the 1080p terrain the
    # first bounce segment alone hits ~8,000 times, the others fewer),
    # each bounce segment's tri ids also alone
    n = rec[0][0].shape[0]
    cat_o, cat_d, cat_t = (torch.cat([r[i] for r in rec]) for i in range(3))
    rng = np.random.default_rng(19)
    cap = torch.from_numpy(rng.uniform(0.5, 40.0, cat_t.numel()).astype(
        np.float32)).to(cat_t.device)
    half = torch.from_numpy(rng.random(cat_t.numel()) < 0.5).to(
        cat_t.device)
    errs = []
    for label, t_max in (("", cat_t), (", a finite t_max on half the live "
                                       "lanes", torch.where(
                                           (cat_t > 0) & half, cap, cat_t))):
        got = P.packet_intersect(tables, cat_o, cat_d, t_max)
        ref = P.packet_intersect_plain(tables, cat_o, cat_d, t_max)
        torch.cuda.synchronize()
        errs.append(_check_k1(f"a wavefront frame's rays, {segs} segments"
                              f"{label}", tables, cat_o, cat_d, got, ref))
        for k in range(1, segs):
            sl = slice(k * n, (k + 1) * n)
            eq = (got.tri[sl] == ref.tri[sl]).float().mean().item()
            print(f"  K1 bounce segment {k}{label}: {live_n[k]} live lanes,"
                  f" {int((ref.tri[sl] >= 0).sum())} hits, tri id equal on "
                  f"{eq:.6f}")
            assert eq >= 0.999, f"K1 bounce segment {k}: tri equal on {eq}"
        assert (got.tri[t_max <= 0] == -1).all(), "a finished lane hit"
        capped = torch.isfinite(t_max) & (got.tri >= 0)
        assert (got.t[capped] < t_max[capped]).all(), "a hit beyond t_max"
    del cat_o, cat_d, cat_t, got, ref
    # time, plain time and bound on the first bounce segment's rays
    o, d, tm = rec[1]
    visits = [0, 0]
    P.packet_intersect_plain(tables, o, d, tm, visits=visits)
    k1_plain = time_ms(lambda: P.packet_intersect_plain(tables, o, d, tm),
                       1)
    k1_bound = bound_ms(n * (28 + 44) + _table_bytes(tables),
                        visits[0] * NODE_OPS + visits[1] * LEAF_OPS)
    print(f"K1 time, wavefront bounce segment 1: kernel {seg_ms[1]:.3f} ms, "
          f"plain {k1_plain:.1f} ms; {visits[0] / n:.2f} node and "
          f"{visits[1] / n:.2f} leaf visits per ray; bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) {card}")
    del rec

    # (c) the loop route at 480x270 against the packet route
    small = dataclasses.replace(settings, render_width=480,
                                render_height=270)
    loop = Engine(small, flags=FeatureFlags(), scene=scene, trace="loop",
                  device="cuda")
    loop.camera = cam0
    state, prev = loop.state, loop.prev_camera
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    loop.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(cuda.launch_counts)
    gl = loop.last_gbuffer
    _, _, gp = F.render_frame(
        dataclasses.replace(loop.static, use_packets=True), loop.scene_data,
        state, cam0, prev, loop.params, 1 / 60, loop.consts)
    torch.cuda.synchronize()
    same = (gl.mat_id == gp.mat_id) & (
        torch.isclose(gl.depth, gp.depth, rtol=1e-4, atol=0)
        | (torch.isinf(gl.depth) & torch.isinf(gp.depth))) & (
        (gl.normal - gp.normal).abs().amax(-1) <= 1e-3)
    frac_loop = same.float().mean().item()
    print(f"loop route (Engine(terrain, 480x270, trace='loop')): one frame "
          f"{loop_ms:.1f} ms (host clock, the first, sync debug off); "
          f"primary G-buffer equal to the packet route's on "
          f"{frac_loop:.6f} of pixels; launches "
          f"{ {k: v for k, v in counts.items() if v} } {card}")
    assert frac_loop >= 0.999, f"loop route G-buffer equal on {frac_loop}"
    assert counts["packet_intersect"] == 0 and counts["megakernel_trace"] \
        == 0, "the loop route launched a traversal kernel"
    assert int(loop.overflow) == 0, "loop route: dropped pushes"
    del loop

    # (d) the packet route on the animated terrain: refit and rebuild
    for bvh, counter in (("sah4", "packet_intersect"),
                         ("lbvh", "packet_intersect_binary")):
        anim = Engine(settings, flags=FeatureFlags(), scene=scene,
                      animation="wave", bvh=bvh, trace="packets",
                      device="cuda")
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for k in range(3):
                if k == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                pan(k, anim)
                img = anim.render_frame_device(dt=1 / 60)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = (time.perf_counter() - t0) / 2 * 1e3
        counts = dict(cuda.launch_counts)
        print(f"wavefront animated terrain (bvh={bvh!r}, animation='wave'): "
              f"{ms:.2f} ms/frame over 2 frames (sync debug 'error' on all "
              f"3); launches {({k: v for k, v in counts.items() if v})} "
              f"{card}")
        assert counts[counter] == 3 * segs, f"{bvh}: K1 {counts[counter]}"
        assert not [k for k, v in counts.items() if v and k.startswith(
            "megakernel")], f"{bvh}: a K2 instantiation launched"
        assert tuple(img.shape) == (H, W, 3) and int(anim.overflow) == 0
        assert torch.isfinite(anim.last_gbuffer.color).all()
        del anim
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s {card}")
    return dict(
        name="K1 traverse, the wavefront route (packet_intersect once a "
             "bounce segment of Engine(trace='packets'), shadow rays "
             "included; ms / plain / bound on segment 1's bounce rays, "
             "error on all the frame's rays, phase 19)", route="cuda",
        source="rtrt_tpu_torch/csrc/traverse.cu",
        replaces="rtrt_tpu/bvh/packet.py:1104", launches=k1_launches,
        max_abs_err=max(errs), ms=seg_ms[1], plain_ms=k1_plain,
        bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
        segment_ms=seg_ms, frame_ms=wave_ms, frame_busy_ms=busy[
            "wavefront"][0], launches_per_frame=busy["wavefront"][1],
        megakernel_frame_busy_ms=busy["megakernel"][0])


def _north_star(card):
    """Phase 9: Engine(GlobalSettings(scene="terrain")) through its buckets
    (the settings' H rows and 720); then K3's pre-mapped instantiation
    against its plain version on a frame of the run at 720.  Returns that
    kernel's numbers for the kernels line and the Engine."""
    import torch
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.ops.resize import upscale_catmull_rom
    from rtrt_tpu_torch.post.pipeline import dither_mask
    from rtrt_tpu_torch.post.tail import post_tail, post_tail_plain, \
        tail_params
    from rtrt_tpu_torch.post.tonemap import tonemap
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags, GlobalSettings
    from rtrt_tpu_torch.utils.timing import bound_ms, time_graph_ms, time_ms

    eng = Engine(GlobalSettings(scene="terrain"), device="cuda")
    dev = eng.device
    low, n_timed, n_free = 720, TIMED, 8
    assert eng.settings.dynamic_resolution.enabled
    assert eng.flags == FeatureFlags() and (eng.render_w, eng.render_h) == (
        W, H)
    s = eng.init_seconds
    print(f"north star: Engine(GlobalSettings(scene='terrain')) init: scene "
          f"{s['scene']:.2f} s, SAH+BVH4 {s['sah4']:.2f} s, sky "
          f"{s['sky']:.2f} s; dynamic resolution on, bucket {eng.render_h}")
    buckets = []

    def frame(dt):
        img = eng.render_frame_device(dt)
        buckets.append(eng.render_h)
        assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
        hist = eng.state.history
        assert tuple(hist.color.shape) == (eng.render_h, eng.render_w, 3)
        return img

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n):
                frame(1 / 60)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    cuda.reset_launch_counts()
    eng.overflow.zero_()
    frame(1 / 60)
    while eng.render_h != low:
        assert len(buckets) < 4, f"no drop to {low}: {buckets}"
        frame(1 / 20)
    lw = eng.render_w
    ms = {low: timed(n_timed)}
    f_low = eng.state.history.color2.float().clone()  # the denoised frame
    ev_low = eng.state.exposure[0].clone()
    while eng.render_h != H:
        assert len(buckets) < 20, f"no climb to {H}: {buckets}"
        frame(1 / 200)
    pos0 = eng.camera.pos.clone()
    eng.key_event("w", True)
    ms[H] = timed(n_timed)
    eng.key_event("w", False)
    moved = (eng.camera.pos - pos0).norm().item()
    assert abs(moved - n_timed * eng.MOVE_SPEED / 60) < 1e-3, moved
    fixed = list(buckets)
    free, dts = [], []
    for _ in range(n_free):
        frame(None)
        free.append(eng.render_h)
        dts.append(eng.timer.delta)
    torch.cuda.synchronize()
    counts = dict(cuda.launch_counts)
    print(f"north star: buckets with given dt {fixed}; with dt=None "
          f"{free}, the dt the controller saw (ms) "
          f"{[round(d * 1e3, 3) for d in dts]}")
    print(f"north star: {ms[low]:.2f} ms/frame at the {low} bucket "
          f"({lw}x{low} upscaled to {W}x{H}), {ms[H]:.2f} ms/frame at {H} "
          f"with camera input, {n_timed} frames each, host clock around "
          f"synchronize, no host sync inside a frame {card}")
    print(f"north star launch counts: {counts}")
    for k in ("megakernel_trace", "post_tail", "post_tail_mapped",
              "denoise_wide", "reproject"):
        assert counts[k] > 0, f"{k} launched no time on the north star's path"
    assert counts["megakernel_trace"] == len(buckets)
    assert int(eng.overflow) == 0, f"stack overflow {int(eng.overflow)}"

    # K3's pre-mapped instantiation on that frame, out at the screen size
    par = tail_params(ev_low, 1.0, 2.2, 0.5, 0.37, dev)
    ldr = torch.clamp(upscale_catmull_rom(tonemap(
        f_low * par[0], par[1], par[2]), H, W), 0.0, 1.0).contiguous()
    mask = dither_mask(dev)
    run = lambda f: f(ldr, par, mask, do_sharpen=True, do_dither=True,
                      mapped=True)
    u8, u8p = run(post_tail), run(post_tail_plain)
    torch.cuda.synchronize()
    du = (u8.int() - u8p.int()).abs()
    eq = (du.amax(-1) == 0).float().mean().item()
    print(f"K3 pre-mapped, {lw}x{low} -> {W}x{H}: max |du8| "
          f"{int(du.max())}, equal on {eq:.6f}")
    assert int(du.max()) <= 1 and eq >= 0.9999, "K3 pre-mapped disagrees"
    k_ms = time_ms(lambda: run(post_tail), 50)
    k_graph = time_graph_ms(lambda: run(post_tail), 20, 50)
    k_plain = time_ms(lambda: run(post_tail_plain), 5)
    bound = bound_ms(W * H * (12 + 3), W * H * TAIL_MAPPED_OPS_PX)
    print(f"K3 pre-mapped time, {W}x{H}: kernel {k_ms:.4f} ms by events, "
          f"{k_graph:.4f} ms by graph replay, plain {k_plain:.3f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}), {bound[0] / k_graph:.0%} of it "
          f"{card}")
    return dict(launches=counts["post_tail_mapped"], err=float(du.max()),
                ms=k_ms, graph_ms=k_graph, plain_ms=k_plain, bound=bound,
                engine=eng)


def _interlace(card, settings, scene, cam0, full_ms):
    """Phase 10: the interlaced 1080p frame (its launches, its time beside
    the full-rate frame's), and its traced rows against the full-rate
    frame's for a frame index of each parity.  Returns the Engine and its
    pan."""
    import torch
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags

    eng = Engine(dataclasses.replace(settings, interlace=True),
                 flags=FeatureFlags(), scene=scene, device="cuda")
    assert F.interlaced(eng.static)

    def pan(k):
        eng.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    cuda.reset_launch_counts()
    eng.overflow.zero_()
    for k in range(WARMUP):
        pan(k)
        eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(WARMUP, WARMUP + TIMED):
            pan(k)
            img = eng.render_frame_device(dt=1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    il_ms = (time.perf_counter() - t0) / TIMED * 1e3
    counts = dict(cuda.launch_counts)
    n = WARMUP + TIMED
    print(f"interlace: {il_ms:.2f} ms/frame over {TIMED} frames (host clock "
          f"around synchronize), {W}x{H} terrain, default flags, tracing "
          f"{H // 2} rows a frame; full rate {full_ms:.2f} ms/frame in this "
          f"run {card}")
    print(f"interlace launch counts over {n} frames: {counts}")
    want = dict(megakernel_trace=n, post_tail=n, denoise_wide=4 * n,
                reproject=n)
    for k, v in want.items():
        assert counts[k] == v, f"interlace: {k} launched {counts[k]}, not {v}"
    gb = eng.last_gbuffer
    assert tuple(gb.depth.shape) == (H // 2, W), tuple(gb.depth.shape)
    assert tuple(img.shape) == (H, W, 3) and int(eng.overflow) == 0
    assert tuple(eng.state.history.color.shape) == (H, W, 3)

    full = dataclasses.replace(eng.static, interlace=False)
    full_consts = F.make_frame_consts(full, eng.device)
    for k in (20, 21):
        state = dataclasses.replace(eng.state, frame_idx=k)
        out = {}
        for static, consts in ((full, full_consts), (eng.static, eng.consts)):
            _, _, out[static.interlace] = F.render_frame(
                static, eng.scene_data, state, eng.camera, eng.prev_camera,
                eng.params, 1 / 60, consts)
        torch.cuda.synchronize()
        p = k & 1
        diff = {}
        for name in ("color", "albedo", "normal", "depth", "motion",
                     "mat_id"):
            a, b = getattr(out[True], name), getattr(out[False], name)[p::2]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                if a.is_floating_point() else a == b
            diff[name] = int((~same).sum())
        print(f"interlace frame {k} (parity {p}): traced rows that differ "
              f"from the full-rate frame's, per plane: {diff}")
        assert not any(diff.values()), f"interlace parity {p}: {diff}"
    return eng, pan


def _busy(step, frames):
    """torch.profiler over `frames` calls of step(k) after one warm call:
    (device busy ms per frame, kernels run per frame, the device-side
    events).  Kernels are counted on the device: a frame that replays a
    CUDA graph launches them with no cudaLaunchKernel of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(-1)  # warm: a first call allocates its buffers
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(frames):
            step(k)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    # device-side events (kernels, memcpy, memset) only: the CPU-side op
    # rows carry the same device time again
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy = sum(_dev_t(e) for e in kern) / frames / 1e3
    launches = sum(e.count for e in kern if not e.key.startswith(
        ("Memcpy", "Memset"))) / frames
    return busy, launches, avg, kern


def _dev_t(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _top(kern, frames, n=4):
    """The n device ops of most time: [(name, ms per frame, events
    recorded)].  An op that runs once a frame and shows fewer than
    `frames` events lost some to the profiler, and its ms per frame reads
    low by as much."""
    top = sorted(kern, key=_dev_t, reverse=True)[:n]
    return [(e.key[:40], round(_dev_t(e) / frames / 1e3, 4), e.count)
            for e in top]


def _animated(card, settings, scene, cam0, static_ms, static_step):
    """Phase 12: Engine(..., animation="wave") on the 1080p terrain — the
    frame's launches and time beside phase 5's static frame, the refit
    stage's own device time and launches, then on the last frame's tables:
    containment of every subtree, equality with the plain refit of the
    same clock on the CPU, K1 and K2 against their plain versions, and the
    frozen topology."""
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.bvh.refit import leaf_bounds, refit_nodes4
    from rtrt_tpu_torch.bvh.types import _LEAF_BIT, entry_slot
    from rtrt_tpu_torch.core.camera import camera_basis
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.render.raygen import generate_rays_padded
    from rtrt_tpu_torch.render.sampling import rand2_bn
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags

    eng = Engine(settings, flags=FeatureFlags(), scene=scene,
                 animation="wave", device="cuda")
    dev = eng.device
    sc, rest = eng.scene_data, eng.rest
    tables = sc.tables
    frozen = (tables.levels, tables.stack)
    ptrs = {f: getattr(tables, f).data_ptr()
            for f in ("nodes", "tris", "nrm", "ng")}
    plan = rest.refit.plan
    print(f"animated terrain: Engine(terrain, {W}x{H}, animation='wave') "
          f"init SAH+BVH4+refit plan {eng.init_seconds['sah4']:.2f} s; "
          f"{tables.nodes.shape[0]} BVH4 nodes in {len(plan.levels)} refit "
          f"levels, {plan.n_leaves} leaves; rest pose "
          f"{2 * rest.tris_t.numel() * 4 / 1e6:.2f} MB on the card")

    def pan(k):
        eng.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    cuda.reset_launch_counts()
    eng.overflow.zero_()
    eng.stack_depth.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(WARMUP):
            pan(k)
            eng.render_frame_device(dt=1 / 60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(WARMUP, WARMUP + TIMED):
            pan(k)
            t_last = eng.state.time  # the clock of the frame's refit
            img = eng.render_frame_device(dt=1 / 60)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    anim_ms = (time.perf_counter() - t0) / TIMED * 1e3
    counts = dict(cuda.launch_counts)
    n = WARMUP + TIMED
    print(f"animated terrain: {anim_ms:.2f} ms/frame over {TIMED} frames "
          f"(host clock around synchronize, sync debug 'error' on all {n} "
          f"frames), static main path {static_ms:.2f} ms/frame in this run "
          f"{card}")
    print(f"animated terrain launch counts over {n} frames: {counts}")
    want = dict(megakernel_trace=n, post_tail=n, denoise_wide=4 * n,
                reproject=n, packet_intersect=0)
    for k, v in want.items():
        assert counts[k] == v, f"animated: {k} launched {counts[k]}, not {v}"
    print(f"animated terrain: deepest traversal stack "
          f"{int(eng.stack_depth)} entries of {tables.stack}, dropped "
          f"pushes {int(eng.overflow)}")
    assert int(eng.overflow) == 0, f"animated: overflow {int(eng.overflow)}"
    assert tuple(img.shape) == (settings.render_height,
                                settings.render_width, 3)
    assert img.dtype == torch.uint8
    assert (tables.levels, tables.stack) == frozen, "topology changed"
    assert all(getattr(tables, f).data_ptr() == p for f, p in ptrs.items())

    # the last frame's tables: every child box holds its subtree (leaf
    # children: the displaced triangles of the leaf row; internal children:
    # the union of the child node's boxes, so by induction the subtree)
    tt = F.displace_wave_rows(rest.tris_t, t_last)
    llo, lhi = leaf_bounds(tt, plan.n_leaves)
    nodes = tables.nodes
    ent = nodes[:, 24:28].long()
    box = nodes[:, :24].reshape(-1, 4, 6)
    leaf = (ent >= 0) & ((ent & _LEAF_BIT) != 0)
    inner = (ent >= 0) & ~leaf
    li = entry_slot(ent[leaf]) // P.LEAF_WIDTH
    ci = ent[inner] & 0x3FFFFF
    sub_lo = box[ci][:, :, 0:3].amin(1)
    sub_hi = box[ci][:, :, 3:6].amax(1)
    holds = bool((box[leaf][:, 0:3] <= llo[li]).all()
                 & (box[leaf][:, 3:6] >= lhi[li]).all()
                 & (box[inner][:, 0:3] <= sub_lo).all()
                 & (box[inner][:, 3:6] >= sub_hi).all())
    print(f"animated terrain: {int(leaf.sum())} leaf and {int(inner.sum())} "
          f"internal child boxes hold their subtrees: {holds}")
    assert holds, "a refitted box does not hold its subtree"

    # the plain refit of the same clock on the CPU (the JAX module's form):
    # the displacement's sin / cos round differently there, so nodes,
    # tris and nrm within 2e-5 (terrain coordinates < 64: 5 ulps), ng
    # within 1e-3 on >= 99.9% of slots (a sliver's normal turns with an
    # ulp of its vertices); the sentinels, entry and zero lanes exactly
    tc = F.displace_wave_rows(rest.tris_t.cpu(), t_last)
    nc = F.wave_normal_rows(rest.nrm_t.cpu(), rest.tris_t.cpu(), t_last)
    ref_nodes = refit_nodes4(plan, *leaf_bounds(tc, plan.n_leaves))
    ref = P.pack_tables(types.SimpleNamespace(tris_t=tc), nc,
                        tables.mat.cpu(), ref_nodes)
    errs = {}
    for f in ("nodes", "tris", "nrm", "ng"):
        a, b = getattr(tables, f).cpu(), getattr(ref, f)
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), f
        assert torch.equal(a[~fin], b[~fin]), f
        errs[f] = (a[fin] - b[fin]).abs().max().item()
    ng_err = (tables.ng.cpu() - ref.ng).abs().amax(-1)
    bad_ng = {e: (ng_err > e).float().mean().item() for e in (1e-5, 1e-3)}
    print(f"animated terrain: tables vs the plain refit of clock {t_last!r} "
          f"on the CPU, max abs err {errs}; share of slots whose ng differs "
          f"by more than 1e-5 / 1e-3: {bad_ng}")
    for f in ("nodes", "tris", "nrm"):
        assert errs[f] <= 2e-5, f"animated: {f} differs by {errs[f]}"
    assert bad_ng[1e-3] <= 1e-3, f"animated: ng {bad_ng}"

    # K1 and K2 on the refitted tables, at phase 3's bounds
    consts = eng.consts
    rays = generate_rays_padded(camera_basis(eng.camera), eng.render_w,
                                eng.render_h, consts.pixel_ids,
                                rand2_bn(consts.bn, 7, 0),
                                rand2_bn(consts.bn, 7, 256))
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    ovf = P.overflow_counter(dev)
    g = P.packet_intersect(tables, org, dirs, overflow=ovf)
    r = P.packet_intersect_plain(tables, org, dirs)
    torch.cuda.synchronize()
    _check_k1("refitted terrain, primary", tables, org, dirs, g, r)
    args = (tables, pack_materials_rows(sc.materials).to(dev),
            M.pack_light_rows(sc.lights, dev), M.pack_sun_params(sc.sky),
            7, rays.org, rays.dir, rays.cone_width, consts.pixel_ids)
    a = M.megakernel_trace(*args, n_lights=0, bn=consts.bn, overflow=ovf)
    b = M.megakernel_trace_plain(*args, n_lights=0, bn=consts.bn)
    torch.cuda.synchronize()
    _check_k2(f"refitted terrain {eng.render_w}x{eng.render_h}", sc.sky,
              rays, a, b,
              camera_basis(eng.camera))
    assert int(ovf) == 0, f"animated: K1/K2 overflow {int(ovf)}"

    # device busy and launches: the animated frame beside the static one,
    # and the refit stage alone
    def anim_step(k):
        pan(100 + k)
        eng.render_frame_device(dt=1 / 60)

    frames = 5
    res = {"static frame": _busy(static_step, frames),
           "animated frame": _busy(anim_step, frames),
           "refit stage": _busy(lambda k: F.animate_tables(
               tables, rest, t_last + 0.01 * k), frames)}
    for label, (busy, launches, _, kern) in res.items():
        print(f"animated terrain, {label}: device busy {busy:.3f} ms/frame, "
              f"{launches:.1f} kernel launches/frame (torch.profiler over "
              f"{frames} frames); top {_top(kern, frames)} {card}")


def _ulps(a, b):
    """The largest difference of two float32 tensors in units in the last
    place (0 where they are equal, infinities included)."""
    import torch
    order = lambda x: torch.where(x < 0, -(x & 0x7FFFFFFF), x)
    ia = order(a.contiguous().view(torch.int32).long())
    ib = order(b.contiguous().view(torch.int32).long())
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _once(fn):
    """(fn(), its milliseconds by CUDA events): one call, for the plain
    versions, whose host-driven loops take seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _lbvh(card, settings, scene, cam0, bvh4_tables, bvh4_visits):
    """Phase 14: the two-level LBVH built on the card (Engine(...,
    bvh="lbvh")): (a) the device build against the CPU build of the same
    arrays; (b) K1's binary instantiation against its plain version on the
    1080p primaries and the any-hit rays toward a low sun, and
    probe_traverse's step caps on it; (c) K2's binary instantiation against
    its plain version, its deepest stack against the static bound, and its
    time beside the BVH4 instantiation's on the same view; (d) the static
    and the animated LBVH Engine, 3 warm-up and 10 timed frames of the slow
    pan under sync debug "error", launch counters reset just before; (e)
    device busy and launches of both frames and of the rebuild stage
    alone.  Returns the kernels-line entries of K1's and K2's binary
    instantiations."""
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.core.camera import camera_basis
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.engine.scene import padded_arrays
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.render.raygen import generate_rays_padded
    from rtrt_tpu_torch.render.sampling import rand2_bn
    from rtrt_tpu_torch.tools import probe_traverse as PT
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags
    from rtrt_tpu_torch.utils.timing import bound_ms, time_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")

    # (a) the build on the card and on the CPU, from the same arrays
    pad = padded_arrays(scene)
    src = dict(indices=torch.from_numpy(pad["indices"]).long(),
               tri_mat=torch.from_numpy(pad["tri_mat"]),
               valid=torch.from_numpy(pad["valid"]),
               verts=torch.from_numpy(scene.vertices),
               nrm=torch.from_numpy(scene.normals))
    builds = {}
    for where in ("cuda", "cpu"):
        a = {k: v.to(where) for k, v in src.items()}
        builds[where] = F.build_scene_tables(
            scene.num_batches, a["indices"], a["tri_mat"], a["valid"],
            a["verts"], a["nrm"])
    torch.cuda.synchronize()
    (g, gn, gm), (c, cn, cm) = builds["cuda"], builds["cpu"]
    ints = {f: torch.equal(getattr(g, f).cpu(), getattr(c, f))
            for f in ("children_t", "sorted_tri_index")}
    ints["sorted_mat"] = torch.equal(gm.cpu(), cm)
    ulps = {f: _ulps(getattr(g, f).cpu(), getattr(c, f))
            for f in ("boxes_t", "tris_t", "root_lo", "root_hi")}
    ulps["nrm_t"] = _ulps(gn.cpu(), cn)
    print(f"LBVH build, {scene.num_batches} batches, "
          f"{g.boxes_t.shape[1]} nodes: device vs CPU build of the same "
          f"arrays, integer tables equal {ints}; float tables' largest "
          f"difference in ulps {ulps}")
    assert all(ints.values()), f"LBVH device build: integer tables {ints}"
    assert not any(ulps.values()), f"LBVH device build: floats {ulps}"

    # (b) K1's binary instantiation on the static LBVH Engine's tables
    eng = Engine(settings, flags=FeatureFlags(), scene=scene, bvh="lbvh",
                 device="cuda")
    sc, consts = eng.scene_data, eng.consts
    tables = sc.tables
    print(f"LBVH Engine init {eng.init_seconds['lbvh']:.2f} s (the build "
          f"on the card, the first call included); {tables.nodes.shape[0]} "
          f"64-byte records, {tables.tlas_internal} TLAS rows; static "
          f"stack bound {tables.levels} entries: stack {tables.stack}")
    assert (tables.arity, tables.stack) == (2, 256)
    assert cuda.traverse_stacks(2, 1) == (256,)
    rays = generate_rays_padded(camera_basis(cam0), W, H, consts.pixel_ids,
                                rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    n = org.shape[0]
    ovf = P.overflow_counter(dev)
    gk = P.packet_intersect(tables, org, dirs, overflow=ovf)
    visits = [0, 0]
    rk, k1_plain = _once(lambda: P.packet_intersect_plain(
        tables, org, dirs, visits=visits))
    sh_org, sh_dir = _shadow_rays(org, dirs, rk, sc.sky.sun_dir)
    gs = P.packet_intersect(tables, sh_org, sh_dir, any_hit=True,
                            overflow=ovf)
    rs = P.packet_intersect_plain(tables, sh_org, sh_dir, any_hit=True)
    torch.cuda.synchronize()
    k1_err = max(_check_k1(name, tables, o, d, a, b)
                 for name, o, d, a, b in (
                     ("LBVH primary", org, dirs, gk, rk),
                     ("LBVH shadow", sh_org, sh_dir, gs, rs)))
    assert int(ovf) == 0, f"K1 binary: dropped pushes {int(ovf)}"
    k1_ms = time_ms(lambda: P.packet_intersect(tables, org, dirs), 10)
    k1_bound = bound_ms(n * (28 + 44) + _table_bytes(tables),
                        visits[0] * NODE2_OPS + visits[1] * LEAF2_OPS)
    print(f"K1 binary time, {W}x{H} primary rays: kernel {k1_ms:.3f} ms, "
          f"plain {k1_plain:.1f} ms; {visits[0] / n:.2f} node and "
          f"{visits[1] / n:.2f} leaf visits per primary (BVH4: "
          f"{bvh4_visits[0] / n:.2f} and {bvh4_visits[1] / n:.2f}); bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}, 64-byte records) {card}")
    # the tool's step caps on the binary tables (K1's launcher entry point)
    cuda.reset_launch_counts()
    caps = PT.measure(tables, org, dirs, CAPS, 3)
    k1_launches = cuda.launch_counts["packet_intersect_binary"]
    print("K1 binary under step caps (probe_traverse.measure): "
          + ", ".join(f"cap {c}: {sec * 1e3:.3f} ms, {st} visits"
                      for c, sec, st in caps) + f"; {k1_launches} launches "
          f"{card}")
    assert k1_launches > 0 and cuda.launch_counts["packet_intersect"] == 0

    # (c) K2's binary instantiation, and the BVH4 one on the same view
    k2_args = lambda tb: (tb, pack_materials_rows(sc.materials).to(dev),
                          M.pack_light_rows(sc.lights, dev),
                          M.pack_sun_params(sc.sky), 0, rays.org, rays.dir,
                          rays.cone_width, consts.pixel_ids)
    args = k2_args(tables)
    ovf.zero_()
    depth, pdepth = P.overflow_counter(dev), P.overflow_counter(dev)
    a = M.megakernel_trace(*args, n_lights=0, bn=consts.bn, overflow=ovf,
                           stack_depth=depth)
    k2_visits, k2_hits = [0, 0], [0, 0, 0]
    b, k2_plain = _once(lambda: M.megakernel_trace_plain(
        *args, n_lights=0, bn=consts.bn, visits=k2_visits, hits=k2_hits,
        stack_depth=pdepth))
    _, _, k2_err = _check_k2(f"binary {W}x{H}", sc.sky, rays, a, b,
                             camera_basis(cam0))
    print(f"K2 binary deepest traversal stack {int(depth)} entries (plain "
          f"version {int(pdepth)}; static bound {tables.levels}, stack "
          f"{tables.stack}); dropped pushes {int(ovf)}")
    assert int(ovf) == 0, f"K2 binary: dropped pushes {int(ovf)}"
    assert 0 < int(depth) <= tables.levels, f"K2 binary deepest {int(depth)}"
    b4 = k2_args(bvh4_tables)
    run4 = lambda: M.megakernel_trace(*b4, n_lights=0, bn=consts.bn)
    run2 = lambda: M.megakernel_trace(*args, n_lights=0, bn=consts.bn)
    t4a, t2a, t2b, t4b = (time_ms(f, 5) for f in (run4, run2, run2, run4))
    k2_ms, k2_bvh4 = (t2a + t2b) / 2, (t4a + t4b) / 2
    px = W * H
    k2_ops = (k2_visits[0] * NODE2_OPS + k2_visits[1] * LEAF2_OPS
              + k2_hits[0] * SURF_OPS + k2_hits[1] * SOIL_OPS
              + k2_hits[2] * BSDF_OPS)
    k2_bound = bound_ms(px * (40 + 72) + _table_bytes(tables), k2_ops)
    print(f"K2 time, {W}x{H}, the same view (BVH4, binary, binary, BVH4): "
          f"binary {t2a:.3f} / {t2b:.3f} ms, BVH4 {t4a:.3f} / {t4b:.3f} ms; "
          f"binary plain {k2_plain:.1f} ms; per pixel over the segments "
          f"{k2_visits[0] / px:.2f} node and {k2_visits[1] / px:.2f} leaf "
          f"visits; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}, 64-byte "
          f"records) {card}")

    # (d) the static and the animated LBVH Engine
    anim = Engine(settings, flags=FeatureFlags(), scene=scene,
                  animation="wave", bvh="lbvh", device="cuda")
    assert isinstance(anim.rest, F.MeshPose)
    runs, launches = {}, 0
    for label, e in (("static", eng), ("animated", anim)):
        def pan(k, e=e):
            e.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

        cuda.reset_launch_counts()
        e.overflow.zero_()
        e.stack_depth.zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for k in range(WARMUP):
                pan(k)
                e.render_frame_device(dt=1 / 60)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(WARMUP, WARMUP + TIMED):
                pan(k)
                t_last = e.state.time
                img = e.render_frame_device(dt=1 / 60)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = (time.perf_counter() - t0) / TIMED * 1e3
        counts = dict(cuda.launch_counts)
        nf = WARMUP + TIMED
        print(f"LBVH {label} frame: {ms:.2f} ms/frame over {TIMED} frames "
              f"(host clock around synchronize, sync debug 'error' on all "
              f"{nf} frames); deepest stack {int(e.stack_depth)} entries, "
              f"dropped pushes {int(e.overflow)} {card}")
        print(f"LBVH {label} launch counts over {nf} frames: {counts}")
        want = dict(megakernel_trace_binary=nf, post_tail=nf,
                    denoise_wide=4 * nf, reproject=nf, megakernel_trace=0,
                    packet_intersect=0, packet_intersect_binary=0)
        for k, v in want.items():
            assert counts[k] == v, f"LBVH {label}: {k} launched {counts[k]}"
        assert int(e.overflow) == 0, f"LBVH {label}: overflow"
        assert int(e.stack_depth) <= e.scene_data.tables.levels
        assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
        gb = e.last_gbuffer
        assert all(torch.isfinite(getattr(gb, f)).all()
                   for f in ("color", "albedo", "normal")), label
        runs[label] = (e, pan, t_last)
        launches += counts["megakernel_trace_binary"]

    # (e) device busy and launches: both frames and the rebuild stage
    frames = 5
    res = {}
    for label, (e, pan, _) in runs.items():
        def step(k, e=e, pan=pan):
            pan(100 + k)
            e.render_frame_device(dt=1 / 60)

        res[f"{label} LBVH frame"] = _busy(step, frames)
    e, _, t_last = runs["animated"]
    res["rebuild stage"] = _busy(lambda k: F.rebuild_tables(
        e.scene_data.tables, e.rest, t_last + 0.01 * k), frames)
    for label, (busy, nl, _, kern) in res.items():
        print(f"LBVH, {label}: device busy {busy:.3f} ms/frame, {nl:.1f} "
              f"kernel launches/frame (torch.profiler over {frames} "
              f"frames); top {_top(kern, frames)} {card}")
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s {card}")

    return [
        dict(name="K1 traverse, binary two-level LBVH instantiation "
             "(traverse2; in the LBVH frame its traversal runs inside K2's "
             "binary instantiation: launches are probe_traverse.measure's "
             "under the step caps, phase 14)", route="cuda",
             source="rtrt_tpu_torch/csrc/traverse.cu",
             replaces="rtrt_tpu/bvh/packet.py:1104", launches=k1_launches,
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None),
        dict(name="K2 megakernel, binary two-level LBVH instantiation "
             "(launches: the static and the animated LBVH Engine's 13 "
             "frames each, phase 14)", route="cuda",
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=launches, max_abs_err=float(k2_err), ms=k2_ms,
             bvh4_ms_same_view=k2_bvh4, plain_ms=k2_plain,
             bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=None),
    ]


def _timed_engine(card, label, eng, cam0, counter, n_warm=3, n_timed=5):
    """n_warm + n_timed frames of the slow pan under sync debug "error",
    the launch counters reset just before: each image (H, W, 3) uint8, 0
    dropped pushes, `counter` read n_warm + n_timed launches; then device
    busy and launches per frame (torch.profiler over 3 frames).  Returns
    (ms/frame by host clock, the counter's launches)."""
    import torch
    from rtrt_tpu_torch.utils import cuda

    def pan(k):
        eng.camera = dataclasses.replace(cam0, yaw=cam0.yaw + 0.002 * k)

    cuda.reset_launch_counts()
    eng.overflow.zero_()
    eng.stack_depth.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(n_warm + n_timed):
            if k == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            pan(k)
            img = eng.render_frame_device(dt=1 / 60)
            assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    counts = dict(cuda.launch_counts)
    nf = n_warm + n_timed
    print(f"{label}: {ms:.2f} ms/frame over {n_timed} frames (host clock "
          f"around synchronize, sync debug 'error' on all {nf}); deepest "
          f"stack {int(eng.stack_depth)} entries of "
          f"{eng.scene_data.tables.stack}, dropped pushes "
          f"{int(eng.overflow)} {card}")
    print(f"{label} launch counts over {nf} frames: "
          f"{ {k: v for k, v in counts.items() if v} }")
    want = {counter: nf, "post_tail": nf, "denoise_wide": 4 * nf,
            "reproject": nf}
    for k, v in want.items():
        assert counts[k] == v, f"{label}: {k} launched {counts[k]}"
    others = [k for k, v in counts.items() if v and k.startswith(
        "megakernel_trace") and k != counter]
    assert not others, f"{label}: other K2 instantiations {others}"
    assert int(eng.overflow) == 0, f"{label}: overflow"
    assert int(eng.stack_depth) <= eng.scene_data.tables.levels * (
        3 if eng.scene_data.tables.arity == 4 else 1)
    busy, launches, _, kern = _busy(lambda k: (
        pan(100 + k), eng.render_frame_device(dt=1 / 60)), 3)
    print(f"{label}: device busy {busy:.3f} ms/frame, {launches:.1f} kernel "
          f"launches/frame (torch.profiler over 3 frames); top "
          f"{_top(kern, 3)} {card}")
    return ms, counts[counter]


def _optin(card, settings, scene, cam0, bvh4_tables, bvh4_visits,
           lbvh_k2_ms):
    """Phase 15: K2's Fourier-texture branch, K1 and K2 on the flat binary
    SAH tree, and the Preetham sky, through the Engine.  Returns the
    kernels-line entries of K2's Fourier instantiation and of K1's and
    K2's leaf-row instantiations."""
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.core.camera import camera_basis
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.render.raygen import generate_rays_padded
    from rtrt_tpu_torch.render.sampling import rand2_bn
    from rtrt_tpu_torch.tools import probe_traverse as PT
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.config import FeatureFlags, GlobalSettings
    from rtrt_tpu_torch.utils.timing import bound_ms, time_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    px = W * H

    # (a) the Fourier-texture Engine, fresh: its fit and K2's table of it
    # are made at init, so every frame from its first runs under sync
    # debug "error"
    feng = Engine(settings, flags=FeatureFlags(fourier_textures=True),
                  scene=scene, device="cuda")
    fit = feng.ftex
    atoms = len(fit.fit.albedo_ao.freq) // 2
    print(f"Fourier textures: soil set {settings.texture_size}^2 fitted in "
          f"{feng.init_seconds['textures']:.2f} s, {atoms} atoms a texture "
          f"(a cosine and a sine term each)")
    f_frame_ms, f_launches = _timed_engine(
        card, "Fourier-texture frame", feng, cam0, "megakernel_trace_ftex")

    # (b) K2's Fourier-texture instantiation on the BVH4 view of phase 3
    sc, consts = feng.scene_data, feng.consts
    rays = generate_rays_padded(camera_basis(cam0), W, H, consts.pixel_ids,
                                rand2_bn(consts.bn, 0, 0),
                                rand2_bn(consts.bn, 0, 256))
    k2_args = lambda tb: (tb, pack_materials_rows(sc.materials).to(dev),
                          M.pack_light_rows(sc.lights, dev),
                          M.pack_sun_params(sc.sky), 0, rays.org, rays.dir,
                          rays.cone_width, consts.pixel_ids)
    args = k2_args(sc.tables)
    ovf = P.overflow_counter(dev)
    a = M.megakernel_trace(*args, n_lights=0, bn=consts.bn, overflow=ovf,
                           ftex=fit)
    f_visits, f_hits = [0, 0], [0, 0, 0]
    b, f_plain = _once(lambda: M.megakernel_trace_plain(
        *args, n_lights=0, bn=consts.bn, visits=f_visits, hits=f_hits,
        ftex=fit.fit))
    _, _, f_err = _check_k2(f"Fourier textures {W}x{H}", sc.sky, rays, a, b,
                            camera_basis(cam0))
    assert int(ovf) == 0, f"K2 Fourier: dropped pushes {int(ovf)}"
    # the fitted albedo of the primary hits, kernel against plain (the
    # kernel's sine terms are sin(angle), the plain version's
    # cos(angle - pi/2) rounded once more)
    hit = (a.mat_id == b.mat_id) & (b.mat_id >= 0)
    dalb = (a.albedo - b.albedo).abs().amax(-1)[hit].double()
    q = torch.quantile(dalb[::max(1, dalb.numel() // 1_000_000)],
                       torch.tensor([0.5, 0.999], dtype=torch.float64,
                                    device=dalb.device)).tolist()
    print(f"K2 Fourier: primary-hit albedo |kernel - plain| median "
          f"{q[0]:.3e}, 99.9th percentile {q[1]:.3e}, max "
          f"{dalb.max().item():.3e}")
    run_f = lambda: M.megakernel_trace(*args, n_lights=0, bn=consts.bn,
                                       ftex=fit)
    run_s = lambda: M.megakernel_trace(*args, n_lights=0, bn=consts.bn)
    ts_a, tf_a, tf_b, ts_b = (time_ms(f, 5) for f in (run_s, run_f, run_f,
                                                       run_s))
    f_ms, f_soil = (tf_a + tf_b) / 2, (ts_a + ts_b) / 2
    f_ops = (f_visits[0] * NODE_OPS + f_visits[1] * LEAF_OPS
             + f_hits[0] * SURF_OPS + f_hits[1] * ftex_ops(atoms)
             + f_hits[2] * BSDF_OPS)
    # bytes: as K2, plus the coefficient table
    f_bound = bound_ms(px * (40 + 72) + _table_bytes(sc.tables)
                       + fit.table.numel() * 4, f_ops)
    print(f"K2 Fourier time, {W}x{H}, the same view (procedural, Fourier, "
          f"Fourier, procedural): Fourier {tf_a:.3f} / {tf_b:.3f} ms, "
          f"procedural soil {ts_a:.3f} / {ts_b:.3f} ms; plain "
          f"{f_plain:.1f} ms; {f_hits[1] / px:.3f} textured hits a pixel, "
          f"{ftex_ops(atoms)} operations each; bound {f_bound[0]:.4f} ms "
          f"({f_bound[1]}) {card}")

    # (c) the fit's effect on the Engine's frame
    out = {}
    for fl in (None, fit):
        static = dataclasses.replace(feng.static, ftex=fl)
        _, _, out[fl is None] = F.render_frame(
            static, feng.scene_data, feng.state, feng.camera,
            feng.prev_camera, feng.params, 1 / 60, feng.consts)
    diff = ((out[False].albedo - out[True].albedo).abs().amax(-1)
            > 1e-3).float().mean().item()
    print(f"Fourier-texture frame: traced albedo differs from the same "
          f"frame's with the procedural soil on {diff:.4f} of pixels")
    assert diff > 0.01, f"the fit changes only {diff} of the albedo"
    del feng

    # (d) K1 and K2 on the flat binary SAH tree
    seng = Engine(settings, flags=FeatureFlags(), scene=scene, bvh="sah2",
                  device="cuda")
    tables = seng.scene_data.tables
    print(f"flat SAH Engine init {seng.init_seconds['sah2']:.2f} s; "
          f"{tables.nodes.shape[0]} 64-byte records, leaf rows of "
          f"{tables.leaf_width} slots, {tables.levels} levels: stack "
          f"{tables.stack} entries")
    assert (tables.kind, tables.leaf_width) == ("sah2", 8)
    assert cuda.traverse_stacks(2, 8) == P.STACK_DEPTHS
    org = rays.org.reshape(-1, 3).contiguous()
    dirs = rays.dir.reshape(-1, 3).contiguous()
    n = org.shape[0]
    ovf.zero_()
    gk = P.packet_intersect(tables, org, dirs, overflow=ovf)
    visits = [0, 0]
    rk, k1_plain = _once(lambda: P.packet_intersect_plain(
        tables, org, dirs, visits=visits))
    sh_org, sh_dir = _shadow_rays(org, dirs, rk, sc.sky.sun_dir)
    gs = P.packet_intersect(tables, sh_org, sh_dir, any_hit=True,
                            overflow=ovf)
    rs = P.packet_intersect_plain(tables, sh_org, sh_dir, any_hit=True)
    torch.cuda.synchronize()
    k1_err = max(_check_k1(name, tables, o, d, x, y)
                 for name, o, d, x, y in (
                     ("flat SAH primary", org, dirs, gk, rk),
                     ("flat SAH shadow", sh_org, sh_dir, gs, rs)))
    assert int(ovf) == 0, f"K1 leaf rows: dropped pushes {int(ovf)}"
    k1_ms = time_ms(lambda: P.packet_intersect(tables, org, dirs), 10)
    k1_bound = bound_ms(n * (28 + 44) + _table_bytes(tables),
                        visits[0] * NODE2_OPS + visits[1] * LEAF_OPS)
    print(f"K1 leaf-row time, {W}x{H} primary rays: kernel {k1_ms:.3f} ms, "
          f"plain {k1_plain:.1f} ms; {visits[0] / n:.2f} node and "
          f"{visits[1] / n:.2f} leaf visits per primary (BVH4: "
          f"{bvh4_visits[0] / n:.2f} and {bvh4_visits[1] / n:.2f}); bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}, 64-byte records) {card}")
    cuda.reset_launch_counts()
    caps = PT.measure(tables, org, dirs, CAPS, 3)
    k1_launches = cuda.launch_counts["packet_intersect_sah2"]
    print("K1 leaf rows under step caps (probe_traverse.measure): "
          + ", ".join(f"cap {c}: {sec * 1e3:.3f} ms, {st} visits"
                      for c, sec, st in caps) + f"; {k1_launches} launches "
          f"{card}")
    assert k1_launches > 0 and cuda.launch_counts["packet_intersect"] == 0

    args = k2_args(tables)
    ovf.zero_()
    depth, pdepth = P.overflow_counter(dev), P.overflow_counter(dev)
    a = M.megakernel_trace(*args, n_lights=0, bn=consts.bn, overflow=ovf,
                           stack_depth=depth)
    k2_visits, k2_hits = [0, 0], [0, 0, 0]
    b, k2_plain = _once(lambda: M.megakernel_trace_plain(
        *args, n_lights=0, bn=consts.bn, visits=k2_visits, hits=k2_hits,
        stack_depth=pdepth))
    _, _, k2_err = _check_k2(f"flat SAH {W}x{H}", sc.sky, rays, a, b,
                             camera_basis(cam0))
    print(f"K2 leaf-row deepest traversal stack {int(depth)} entries (plain "
          f"version {int(pdepth)}; {tables.levels} levels, stack "
          f"{tables.stack}); dropped pushes {int(ovf)}")
    assert int(ovf) == 0, f"K2 leaf rows: dropped pushes {int(ovf)}"
    assert 0 < int(depth) <= tables.levels, f"K2 deepest {int(depth)}"
    b4 = k2_args(bvh4_tables)
    run4 = lambda: M.megakernel_trace(*b4, n_lights=0, bn=consts.bn)
    run2 = lambda: M.megakernel_trace(*args, n_lights=0, bn=consts.bn)
    t4a, t2a, t2b, t4b = (time_ms(f, 5) for f in (run4, run2, run2, run4))
    k2_ms, k2_bvh4 = (t2a + t2b) / 2, (t4a + t4b) / 2
    k2_ops = (k2_visits[0] * NODE2_OPS + k2_visits[1] * LEAF_OPS
              + k2_hits[0] * SURF_OPS + k2_hits[1] * SOIL_OPS
              + k2_hits[2] * BSDF_OPS)
    k2_bound = bound_ms(px * (40 + 72) + _table_bytes(tables), k2_ops)
    print(f"K2 time, {W}x{H}, the same view (BVH4, leaf rows, leaf rows, "
          f"BVH4): leaf rows {t2a:.3f} / {t2b:.3f} ms, BVH4 {t4a:.3f} / "
          f"{t4b:.3f} ms (two-level binary {lbvh_k2_ms:.3f} ms in phase "
          f"14); plain {k2_plain:.1f} ms; per pixel over the segments "
          f"{k2_visits[0] / px:.2f} node and {k2_visits[1] / px:.2f} leaf "
          f"visits; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) {card}")

    # (e) the flat SAH Engine
    _, k2_launches = _timed_engine(card, "flat SAH frame", seng, cam0,
                                   "megakernel_trace_sah2")
    del seng

    # (f) the Preetham sky through the default settings
    peng = Engine(GlobalSettings(scene="terrain", sky_model="preetham"),
                  scene=scene, device="cuda")
    for _ in range(2):
        img = peng.render_frame_device(dt=1 / 60)
        torch.cuda.synchronize()
        assert tuple(img.shape) == (H, W, 3) and img.dtype == torch.uint8
        assert torch.isfinite(peng.last_gbuffer.color).all()
    top = img[: H // 10].float().mean((0, 1)).tolist()
    print(f"Preetham sky: 2 frames at the {peng.render_h} bucket, top rows "
          f"mean RGB {[round(v, 1) for v in top]}")
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s {card}")

    return [
        dict(name="K1 traverse, flat binary SAH instantiation with 8-slot "
             "leaf rows (traverse2<.., LEAF_WIDTH>, bvh='sah2'; in its frame "
             "the traversal runs inside K2: launches are "
             "probe_traverse.measure's under the step caps, phase 15)",
             route="cuda", source="rtrt_tpu_torch/csrc/traverse.cu",
             replaces="rtrt_tpu/bvh/packet.py:1104", launches=k1_launches,
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None),
        dict(name="K2 megakernel, flat binary SAH instantiation with 8-slot "
             "leaf rows (launches: the bvh='sah2' Engine's 8 frames, phase "
             "15)", route="cuda",
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=k2_launches, max_abs_err=float(k2_err), ms=k2_ms,
             bvh4_ms_same_view=k2_bvh4, plain_ms=k2_plain,
             bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=None),
        dict(name="K2 megakernel, Fourier-texture instantiation on the BVH4 "
             "(the TPU kernel's ftex branch; launches: the "
             "fourier_textures Engine's 8 frames, phase 15)", route="cuda",
             source="rtrt_tpu_torch/csrc/megakernel.cu",
             replaces="rtrt_tpu/render/megakernel.py:707",
             launches=f_launches, max_abs_err=float(f_err), ms=f_ms,
             procedural_ms_same_view=f_soil, plain_ms=f_plain,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
             frame_ms=f_frame_ms),
    ]


def _ocean_stars(card, settings, scene):
    """Phase 13: the ocean and the star field on the 1080p terrain at night
    (sky.time_of_day 0.0: the sun below the horizon): finite uint8 images,
    the traced colour of the frame against the same frame without the
    ocean, and the frame's time, device busy and launches."""
    import torch
    from rtrt_tpu_torch.engine import frame as F
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.render.environment import night_visibility
    from rtrt_tpu_torch.utils.config import (FeatureFlags, default_params,
                                             set_param)

    params = set_param(default_params(), "sky.time_of_day", 0.0)
    flags = FeatureFlags(ocean=True, stars=True)
    eng = Engine(settings, flags=flags, scene=scene, params=params,
                 device="cuda")
    vis = float(night_visibility(eng.scene_data.sky))
    print(f"ocean + stars: sun direction "
          f"{[round(v, 4) for v in eng.scene_data.sky.sun_dir.tolist()]}, "
          f"star visibility {vis:.3f}")
    assert vis > 0.5, f"the sun is not below the horizon ({vis})"
    n_warm, n_timed = 3, 5
    for _ in range(n_warm):
        img = eng.render_frame_device(dt=1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n_timed):
            img = eng.render_frame_device(dt=1 / 60)
            assert tuple(img.shape) == (settings.render_height,
                                        settings.render_width, 3)
            assert img.dtype == torch.uint8
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    gb = eng.last_gbuffer
    for f in ("color", "albedo", "normal", "motion"):
        assert torch.isfinite(getattr(gb, f)).all(), f"ocean: {f} not finite"
    # the same frame (state, camera) without the ocean: its pixels differ
    state = eng.state
    out = {}
    for fl in (flags, FeatureFlags(stars=True)):
        static = dataclasses.replace(eng.static, flags=fl)
        _, _, out[fl.ocean] = F.render_frame(
            static, eng.scene_data, state, eng.camera, eng.prev_camera,
            eng.params, 1 / 60, eng.consts)
    diff = (out[True].color - out[False].color).abs().amax(-1) > 1e-3
    sky_px = torch.isinf(out[True].depth)
    share, sky_share = diff.float().mean().item(), sky_px.float().mean()
    print(f"ocean + stars: {ms:.2f} ms/frame over {n_timed} frames (host "
          f"clock around synchronize, no host sync inside a frame), "
          f"{eng.render_w}x{eng.render_h} terrain; traced colour differs "
          f"from the same frame without the ocean on {share:.4f} of pixels "
          f"(primary misses {sky_share.item():.4f}) {card}")
    assert share > 0.01, f"the ocean changes only {share} of pixels"
    busy, launches, _, kern = _busy(
        lambda k: eng.render_frame_device(dt=1 / 60), 3)
    print(f"ocean + stars: device busy {busy:.3f} ms/frame, {launches:.1f} "
          f"kernel launches/frame (torch.profiler over 3 frames); top "
          f"{_top(kern, 3)} {card}")


def _headless(card):
    """Phase 11: the headless CLI at its defaults on the terrain."""
    import subprocess
    import tempfile
    from rtrt_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.png")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "rtrt_tpu_torch.app.headless", "--scene",
                            "terrain", "--frames", "3", "--out", out],
                           cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                           capture_output=True, text=True, timeout=600)
        print(f"headless: exit {r.returncode} in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{r.stdout.strip().splitlines()}")
        assert r.returncode == 0, r.stderr[-3000:]
        img = read_png(out)
    assert img.shape == (H, W, 3), img.shape


def _deep_tree(dev, card):
    """Phase 3f: K1 and K2 on the chain scene, whose 12 BVH4 levels need
    the 256-entry stack, against their plain versions (K1: hit slots and t;
    K2: the primary hits' material and depth), 0 dropped pushes."""
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.engine.engine import Engine
    from rtrt_tpu_torch.engine.scene import build_chain_scene, \
        chain_scene_rays
    from rtrt_tpu_torch.render import megakernel as M
    from rtrt_tpu_torch.render.kshade import pack_materials_rows
    from rtrt_tpu_torch.utils.config import DynamicResolution, \
        FeatureFlags, GlobalSettings

    eng = Engine(GlobalSettings(render_width=64, render_height=32,
                                dynamic_resolution=DynamicResolution(
                                    enabled=False)),
                 flags=FeatureFlags(denoise=False, bloom=False,
                                    lens_flare=False),
                 scene=build_chain_scene(), device=dev)
    sc = eng.scene_data
    tables = sc.tables
    assert tables.stack == 256, f"chain stack {tables.stack}"
    org, d = (torch.from_numpy(x).to(dev)
              for x in chain_scene_rays(1 << 16, seed=3))
    n = org.shape[0]
    ovf = P.overflow_counter(dev)
    a = P.packet_intersect(tables, org, d, overflow=ovf)
    b = P.packet_intersect_plain(tables, org, d)
    args = (tables, pack_materials_rows(sc.materials).to(dev),
            M.pack_light_rows(sc.lights, dev), M.pack_sun_params(sc.sky), 0,
            org, d, torch.zeros(n, device=dev),
            torch.arange(n, dtype=torch.int32, device=dev))
    depth, pdepth = P.overflow_counter(dev), P.overflow_counter(dev)
    ga = M.megakernel_trace(*args, n_lights=0, overflow=ovf,
                            stack_depth=depth)
    gb = M.megakernel_trace_plain(*args, n_lights=0, stack_depth=pdepth)
    torch.cuda.synchronize()
    h = b.tri >= 0
    t_err = ((a.t - b.t).abs() / b.t)[h].max().item()
    dz = ((ga.depth - gb.depth).abs() / gb.depth)[gb.mat_id >= 0]
    print(f"deep tree (chain scene, {tables.levels} BVH4 levels, stack "
          f"{tables.stack}): {n} rays, K1 hits {int(h.sum())} with slots "
          f"equal {torch.equal(a.tri, b.tri)}, t max rel err {t_err:.2e}; "
          f"K2 material equal {torch.equal(ga.mat_id, gb.mat_id)}, depth max "
          f"rel err {dz.max().item():.2e}; deepest stack K2 {int(depth)}, "
          f"plain {int(pdepth)}; dropped pushes {int(ovf)} {card}")
    assert int(ovf) == 0, f"deep tree: dropped pushes {int(ovf)}"
    assert torch.equal(a.tri, b.tri) and t_err <= 1e-5, "deep tree K1"
    assert torch.equal(ga.mat_id, gb.mat_id) and dz.max().item() <= 1e-5, \
        "deep tree K2"
    assert 32 < int(depth) <= 3 * tables.levels, f"K2 deepest {int(depth)}"


def _probes(card, tables, org, dirs):
    """Phase 7: the traversal-step probes K6-K9 and K1's step cap.  Returns
    (the kernels-line entries of K6-K9, the launch counts of the tools'
    run, K1's max abs t error under caps)."""
    import torch
    from rtrt_tpu_torch.bvh import packet as P
    from rtrt_tpu_torch.tools import probe_cores as PC
    from rtrt_tpu_torch.tools import probe_leaf as PL
    from rtrt_tpu_torch.tools import probe_traverse as PT
    from rtrt_tpu_torch.tools import ubench_step as U
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.timing import SMS, time_ms

    dev = "cuda"
    t0 = time.perf_counter()
    err = dict.fromkeys(("K6", "K7", "K8", "K9"), 0.0)

    def same(key, label, got, ref, rtol=0.0):
        # the tests' tolerances (tests/test_torch_probes.py): K6 rtol 2^-20
        # beyond loop and fetch, K7-K9 bit-equal, visit counts equal
        torch.cuda.synchronize()
        e = (got - ref).abs()
        bad = int((e > rtol * ref.abs()).sum())
        err[key] = max(err[key], e.max().item())
        assert bad == 0, f"{key} {label}: {bad} values beyond rtol {rtol}"

    # 7a. every mode of each probe kernel against its plain version: K6 on
    # clusters of 1, 2 and 4 blocks, K7 on 8 to 32 rows, each across the
    # wrap of its record index or stack at the tools' default rows (the
    # plain versions' long runs set phase 7's time); K8-K9 at the tools'
    # default rows
    for rows in K6_ROWS:
        tab, ox = U.tool_inputs(rows, dev)
        for steps in (1, PROBE_CUT) + ((1025,) if rows == 64 else ()):
            for m in U.MODES:
                same("K6", f"{m} rows {rows} steps {steps}",
                     U.step_probe(m, tab, ox, steps),
                     U.step_probe_plain(m, tab, ox, steps),
                     0.0 if m in ("loop", "fetch") else 2.0 ** -20)
    for recipe in ("tool", "hit"):
        make = PL.tool_inputs if recipe == "tool" else PL.hit_inputs
        for rows in K7_ROWS:
            tab, planes = make(rows, dev)
            for steps in (1, PROBE_CUT) + ((129,) if rows == 32 else ()):
                for m in PL.MODES:
                    same("K7", f"{recipe} {m} rows {rows} steps {steps}",
                         PL.leaf_probe(m, tab, planes, steps),
                         PL.leaf_probe_plain(m, tab, planes, steps))
        make = PC.tool_inputs if recipe == "tool" else PC.hit_inputs
        for rows in (8, 32):
            ntab, ttab, planes = make(rows, device=dev)
            p1 = planes[:, 0].contiguous()
            for m in PC.MODES:
                (g, gv), (r, rv) = (f(m, ntab, ttab, p1, PROBE_CUT)
                                    for f in (PC.cores_probe,
                                              PC.cores_probe_plain))
                same("K8", f"{recipe} {m} rows {rows}", g, r)
                assert torch.equal(gv, rv), \
                    f"K8 {recipe} {m} rows {rows}: visits {gv} {rv}"
        ntab, ttab, planes = make(32, 8, True, device=dev)
        (g, gv), (r, rv) = (f("both", ntab, ttab, planes, PROBE_CUT // 2)
                            for f in (PC.cores_probe_grid,
                                      PC.cores_probe_grid_plain))
        same("K9", recipe, g, r)
        assert torch.equal(gv, rv), f"K9 {recipe}: visits differ"
    print(f"K6-K9 vs plain on the card, every mode: K6 rows {K6_ROWS} "
          f"(clusters {[U.launch_geometry(r)[0] for r in K6_ROWS]}) x steps "
          f"1, {PROBE_CUT}, and 1025 at 64 rows; K7 rows {K7_ROWS} x steps "
          f"1, {PROBE_CUT}, and 129 at 32 rows; K8 8 and 32 rows, "
          f"{PROBE_CUT} steps (K9 8 tiles, "
          f"{PROBE_CUT // 2}); the tools' inputs and (K7-K9) rays that hit "
          f"every record: max abs err {err}")

    # 7b. K1 under step caps against the plain traversal under the same cap
    o, d = org[::16].contiguous(), dirs[::16].contiguous()
    cap_err = 0.0
    ovf = P.overflow_counter(dev)
    for cap in CAPS:
        a = P.packet_intersect(tables, o, d, max_steps=cap, count_steps=True,
                               overflow=ovf)
        b = P.packet_intersect_plain(tables, o, d, max_steps=cap,
                                     count_steps=True)
        torch.cuda.synchronize()
        cap_err = max(cap_err, _check_k1(f"cap {cap}", tables, o, d, a, b))
        eq = (a.steps == b.steps).float().mean().item()
        print(f"K1 cap {cap}: steps equal on {eq:.6f} of rays, "
              f"{int(a.steps.sum())} visits in all")
        assert int(a.steps.max()) <= cap and eq >= 0.999, f"K1 cap {cap}"
    assert int(ovf) == 0, f"K1 under caps: stack overflow {int(ovf)}"

    # 7c. the tools' entry points at their default steps and reps, launch
    # counters reset just before and read just after
    cuda.reset_launch_counts()
    res6 = {r["mode"]: r for r in U.main([])}
    res7 = {r["mode"]: r for r in PL.main([])}
    for m in PL.MODES:
        if m not in res7:
            ns, floor = PL.run(m, 32)
            res7[m] = dict(mode=m, ns=ns, floor_ns=floor)
            print(f"{m:>7}: {ns:8.1f} ns/visit  floor {floor:8.1f} ns/visit "
                  f"{card}")
    res8 = PC.main([])
    for m in PC.MODES[1:]:
        ns, floor = PC.run(m, 32)
        print(f"  1-tile, small tables, {m}: {ns:8.1f} ns/step  floor "
              f"{floor:8.1f} ns/step {card}")
    PT.main([])
    counts = dict(cuda.launch_counts)
    print(f"launch counts of the probe tools' run: {counts}")
    for k in ("probe_step", "probe_leaf", "probe_cores", "probe_cores_grid",
              "packet_intersect"):
        assert counts[k] > 0, f"{k} launched no time in the tools' run"

    # 7d. the plain versions at the defaults, and each kernel's bound
    tab, ox = U.tool_inputs(64, dev)
    k6_plain = time_ms(lambda: U.step_probe_plain("cond12", tab, ox, 4000),
                       1, 0)
    tab, planes = PL.tool_inputs(32, dev)
    k7_plain = time_ms(lambda: PL.leaf_probe_plain("full", tab, planes, 400),
                       1, 0)
    ntab, ttab, planes = PC.tool_inputs(32, device=dev)
    p1 = planes[:, 0].contiguous()
    k8_plain = time_ms(lambda: PC.cores_probe_plain("both", ntab, ttab, p1,
                                                    400), 1, 0)
    k8_bound = PC.bound(ntab, ttab, p1,
                        PC.cores_probe("both", ntab, ttab, p1, 400)[1])
    big = PC.tool_inputs(32, 8, True, device=dev)
    k9_plain = time_ms(lambda: PC.cores_probe_grid_plain("both", *big, 200),
                       1, 0)
    k9_bound = PC.bound(*big, PC.cores_probe_grid("both", *big, 200)[1])
    k6_bound, k7_bound = U.bound("cond12", 64, 4000), PL.bound("full", 32,
                                                                400)
    c6 = U.launch_geometry(64)[0]
    c8 = PC.launch_geometry(32)[0]
    print(f"plain versions at the defaults: K6 cond12 {k6_plain:.1f} ms, K7 "
          f"full {k7_plain:.1f} ms, K8 both {k8_plain:.1f} ms, K9 both "
          f"{k9_plain:.1f} ms; phase 7 took {time.perf_counter() - t0:.1f} s "
          f"{card}")
    print(f"bounds at the defaults: K6 cond12 {k6_bound[0]:.4f} ms "
          f"({k6_bound[1]}, {c6} of {SMS} SMs: its cluster), "
          f"{res6['cond12']['ns'] * 4000 / 1e6 / k6_bound[0]:.2f}x; K7 full "
          f"{k7_bound[0]:.4f} ms ({k7_bound[1]}, 1 of {SMS} SMs), "
          f"{res7['full']['ns'] * 400 / 1e6 / k7_bound[0]:.2f}x; K8 both "
          f"{k8_bound[0]:.4f} ms ({c8} SMs: its cluster); K9 both "
          f"{k9_bound[0]:.4f} ms ({8 * c8} SMs) "
          f"{card}")

    def entry(name, source, replaces, key, count, ms, plain, bound):
        return dict(name=name, route="cuda",
                    source="rtrt_tpu_torch/csrc/" + source,
                    replaces=replaces, launches=counts[count],
                    max_abs_err=err[key], ms=ms, plain_ms=plain,
                    bound_ms=bound[0], bound_by=bound[1], library_ms=None)

    entries = [
        entry(f"K6 ubench_step (traversal-step microbenchmark, one cluster "
              f"of {c6} blocks per 64x128 tile; ms per launch in mode "
              f"cond12, 4000 steps)", "probe_step.cu",
              "tools/ubench_step.py:152", "K6", "probe_step",
              res6["cond12"]["ns"] * 4000 / 1e6, k6_plain, k6_bound),
        entry("K7 probe_leaf (leaf-visit replica, one block per 32x128 tile; "
              "ms per launch in mode full, 400 steps)", "probe_leaf.cu",
              "tools/probe_leaf.py:179", "K7", "probe_leaf",
              res7["full"]["ns"] * 400 / 1e6, k7_plain, k7_bound),
        entry(f"K8 probe_cores (full traversal step, one 32x128 tile on a "
              f"cluster of {c8} blocks; ms per launch in mode both, 400 "
              f"steps)", "probe_cores.cu",
              "tools/probe_cores.py:218", "K8", "probe_cores",
              res8[0]["ns"] * 400 / 1e6, k8_plain, k8_bound),
        entry(f"K9 probe_cores grid (8 tiles on {8 * c8} SMs, a cluster a "
              f"tile, (4608,128) tables in "
              "global memory; ms per launch, mode both, 200 steps)",
              "probe_cores.cu", "tools/probe_cores.py:248", "K9",
              "probe_cores_grid", res8[1]["ns"] * 200 * 8 / 1e6, k9_plain,
              k9_bound),
    ]
    return entries, counts, cap_err


def _hw_probes(card):
    """Phase 8: the hardware probes K10-K16.  Returns their kernels-line
    entries."""
    import torch
    from rtrt_tpu_torch.tools import probe_bf16 as PB
    from rtrt_tpu_torch.tools import probe_broadcast as PR
    from rtrt_tpu_torch.tools import probe_cond as PC
    from rtrt_tpu_torch.tools import probe_pressure as PP
    from rtrt_tpu_torch.tools import probe_smem as PS
    from rtrt_tpu_torch.tools import probe_xpose as PX
    from rtrt_tpu_torch.utils import cuda
    from rtrt_tpu_torch.utils.timing import time_ms

    dev = "cuda"
    t0 = time.perf_counter()
    err = {f"K{i}": 0.0 for i in range(10, 17)}

    def same(key, label, got, ref):
        # bit-equal, the tolerance of tests/test_torch_kernels_gpu.py
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        e = torch.where(got == ref, 0.0, (got - ref).abs())
        err[key] = max(err[key], e.max().item())
        assert bad == 0, f"{key} {label}: {bad} values differ"

    # 8a. every mode against its plain version, the tools' rows, a cut step
    # count, every input recipe of the tests
    for recipe, make in PC.RECIPES.items():
        for rows in range(8, 65, 8):  # c = 1, 2, 3, 4 SMs
            tab, x = make(rows, dev)
            ref = PC.cond_probe_plain("flat", tab, x, PROBE_CUT)
            flat = PC.cond_probe("flat", tab, x, PROBE_CUT)
            for m in PC.MODES:  # all three against flat's plain version
                same("K10", f"{recipe} {m} rows {rows}",
                     PC.cond_probe(m, tab, x, PROBE_CUT), ref)
            for m in PS.MODES:
                got = PS.smem_consume(m, tab, x, PROBE_CUT)
                same("K12", f"{recipe} {m} rows {rows}", got,
                     PS.smem_consume_plain(m, tab, x, PROBE_CUT))
                if m == "extract":  # K10 flat's instantiation
                    same("K12", f"{recipe} extract = K10 flat rows {rows}",
                         got, flat)
        for rows in PP.ROWS:
            tab, x = make(rows, dev)
            for n in PP.N_INV:
                same("K13", f"{recipe} rows {rows} n_inv {n}",
                     PP.pressure_probe(n, tab, x, PROBE_CUT),
                     PP.pressure_probe_plain(n, tab, x, PROBE_CUT))
    for recipe, make in PR.RECIPES.items():
        for rows in range(8, 65, 8):  # a cluster of c = 1, 2, 4 SMs
            args = make(dev, rows=rows)
            for m in PR.MODES:
                same("K14", f"{recipe} {m} rows {rows}",
                     PR.broadcast_probe(m, *args, PROBE_CUT),
                     PR.broadcast_probe_plain(m, *args, PROBE_CUT))
    for make in (PX.tool_inputs, PX.hit_inputs):
        for rows in range(8, 33, 8):  # c = 1, 2, 3, 4 SMs
            tab, planes = make(rows, dev)
            ref = PX.xpose_probe_plain("extract", tab, planes, PROBE_CUT)
            for m in PX.MODES:  # both against one plain version
                same("K15", f"{make.__name__} {m} rows {rows}",
                     PX.xpose_probe(m, tab, planes, PROBE_CUT), ref)
    for make in (PB.tool_inputs, PB.uniform_inputs):
        for rows in range(8, 65, 8):  # c = 1, 2, 3, 4 SMs
            x = make(rows, dev)
            for d in PB.DTYPES:
                for steps in (8, PROBE_CUT) if rows == 64 else (8,):
                    same("K16", f"{make.__name__} {d} rows {rows} "
                         f"steps {steps}", PB.bf16_probe(d, x, steps),
                         PB.bf16_probe_plain(d, x, steps))
    print(f"K10 and K12-K16 vs plain on the card, every mode, the tools' "
          f"rows, {PROBE_CUT} steps (K10 and K12 every row count 8-64 on "
          f"{[PC.launch_geometry(r)[0] for r in range(8, 65, 8)]} SMs; "
          f"K13 at 64 and 8 rows on "
          f"{[PP.launch_geometry(r)[0] for r in PP.ROWS]} SMs; K14 every "
          f"row count 8-64 on clusters of "
          f"{[PR.launch_geometry(r)[0] for r in range(8, 65, 8)]} SMs; "
          f"K15 every row count 8-32 on "
          f"{[PX.launch_geometry(r)[0] for r in range(8, 33, 8)]} SMs; K16 "
          f"every row count 8-64 on "
          f"{[PB.launch_geometry(r)[0] for r in range(8, 65, 8)]} SMs, 8 "
          f"steps, and {PROBE_CUT} at 64 rows), every input recipe of the "
          f"tests: max abs err {err}")

    # K14's state stays in registers: no spill in any instantiation (a
    # mode, a lone block or a cluster)
    k14_ptxas = {f"{m} {'cluster' if c else 'block'}": _ptxas(
        f"broadcast_kernelILi{i}ELb{c}E") for i, m in enumerate(PR.MODES)
        for c in (0, 1)}
    print(f"K14 registers / spill stores (ptxas): {k14_ptxas}")
    assert all(s == 0 for _, s in k14_ptxas.values()), k14_ptxas

    # 8b. K11 at the card's shared-memory edge and the JAX tool's sizes, on
    # its grid of rows / 8 blocks, each asking for the buffer
    want = [False] * len(PS.SIZES_MIB) + [True, True, False]
    for rows in (8, 64):
        x = PC.uniform_inputs(rows, dev)[1]
        accepted = {}
        for label, n in PS.edge_sizes(dev):
            out = PS.smem_alloc(x, n)
            accepted[label] = out is not None
            if out is not None:
                same("K11", f"{label} rows {rows}", out,
                     PS.smem_alloc_plain(x, n))
        print(f"K11 dynamic shared memory accepted on "
              f"{PS.alloc_blocks(rows)} blocks: {accepted} {card}")
        assert list(accepted.values()) == want, f"K11 edge {accepted}"

    # 8c. the six tools' entry points at their default steps and reps,
    # launch counters reset just before and read just after
    cuda.reset_launch_counts()
    r10 = {r["mode"]: r for r in PC.main([])}
    r12 = {r["mode"]: r for r in PS.main([])[1]}
    r13 = {(r["rows"], r["n_inv"]): r for r in PP.main([])}
    r14 = {r["mode"]: r for r in PR.main([])}
    r15 = {r["mode"]: r for r in PX.main([])}
    r16 = {r["dtype"]: r for r in PB.main([])}
    k11_events, k11_graph = PS.run_alloc(PS.SMEM_DEFAULT // 4)
    counts = dict(cuda.launch_counts)
    print(f"launch counts of the hardware probe tools' run: {counts}")
    for k in ("probe_cond", "probe_smem_alloc", "probe_smem_consume",
              "probe_pressure", "probe_broadcast", "probe_xpose",
              "probe_bf16"):
        assert counts[k] > 0, f"{k} launched no time in the tools' run"

    # 8d. the plain versions once at the defaults, and each kernel's bound
    tab, x = PC.tool_inputs(64, dev)
    plain = {
        "K10": time_ms(lambda: PC.cond_probe_plain("flat", tab, x, 400),
                       1, 0),
        "K11": time_ms(lambda: PS.smem_alloc_plain(x, PS.SMEM_DEFAULT // 4),
                       20),
        "K12": time_ms(lambda: PS.smem_consume_plain("smem", tab, x, 400),
                       1, 0),
        "K13": time_ms(lambda: PP.pressure_probe_plain(20, tab, x, 400),
                       1, 0)}
    args = PR.tool_inputs(dev)
    plain["K14"] = time_ms(
        lambda: PR.broadcast_probe_plain("extract", *args, 400), 1, 0)
    tab, planes = PX.tool_inputs(32, dev)
    plain["K15"] = time_ms(
        lambda: PX.xpose_probe_plain("extract", tab, planes, 300), 1, 0)
    x = PB.tool_inputs(64, dev)
    plain["K16"] = time_ms(lambda: PB.bf16_probe_plain("bf16", x, 4000),
                           1, 0)
    plain["K16 f32"] = time_ms(lambda: PB.bf16_probe_plain("f32", x, 4000),
                               1, 0)
    print(f"K11 at 48 KB on {PS.alloc_blocks(64)} blocks, ms a launch: "
          f"graph replay {k11_graph}, CUDA events {k11_events} (the wrapper "
          f"on the host included) {card}")
    print(f"plain versions at the defaults (ms): {plain}; phase 8 took "
          f"{time.perf_counter() - t0:.1f} s {card}")

    def entry(key, name, source, replaces, count, ms, bound):
        return dict(name=f"{key} {name}", route="cuda",
                    source="rtrt_tpu_torch/csrc/" + source,
                    replaces=replaces, launches=counts[count],
                    max_abs_err=err[key], ms=ms, plain_ms=plain[key],
                    bound_ms=bound[0], bound_by=bound[1], library_ms=None)

    return [
        entry("K10", f"probe_cond (72-value consume, the 64x128 tile over "
              f"{PC.launch_geometry(64)[0]} SMs, element (0, 0) stepped in "
              f"every warp, no step barrier; ms per launch in mode flat, "
              f"400 steps)", "probe_consume.cu", "tools/probe_cond.py:76",
              "probe_cond", r10["flat"]["ns"] * 400 / 1e6,
              PC.bound(64, 400)),
        entry("K11", f"probe_smem try_alloc (dynamic shared memory a block, "
              f"a grid of {PS.alloc_blocks(64)} blocks on as many SMs at 64 "
              f"rows; ms per launch at 48 KB by graph replay)",
              "probe_consume.cu", "tools/probe_smem.py:34",
              "probe_smem_alloc", k11_graph, PS.alloc_bound()),
        entry("K12", f"probe_smem time_consume (the consume from a table "
              f"staged in shared memory by bulk copies, the 64x128 tile "
              f"over {PC.launch_geometry(64)[0]} SMs as K10; ms per launch "
              f"in mode smem, 400 steps)", "probe_consume.cu",
              "tools/probe_smem.py:85", "probe_smem_consume",
              r12["smem"]["ns"] * 400 / 1e6, PC.bound(64, 400)),
        entry("K13", f"probe_pressure (the consume with live planes, the "
              f"64x128 tile over {PP.launch_geometry(64)[0]} SMs, a shadow "
              f"of element (0, 0) in each block; ms per launch at 64 rows, "
              f"20 planes, 400 steps)", "probe_consume.cu",
              "tools/probe_pressure.py:60", "probe_pressure",
              r13[(64, 20)]["ns"] * 400 / 1e6,
              PP.bound(64, 400, PP.lane_ops(20))),
        entry("K14", f"probe_broadcast (record layout, tile-wide int32 min a "
              f"step overlapped by the adds, the 64x128 tile on a cluster of "
              f"{PR.launch_geometry(64)[0]} SMs; ms per launch in mode "
              f"extract, 400 steps)",
              "probe_record.cu", "tools/probe_broadcast.py:88",
              "probe_broadcast", r14["extract"]["ns"] * 400 / 1e6,
              PR.bound(64, 400)),
        entry("K15", f"probe_xpose (a record row by per-thread loads or "
              f"warp shuffles, the 32x128 tile over "
              f"{PX.launch_geometry(32)[0]} SMs; ms per launch in mode "
              f"extract, 32 rows, 300 steps)", "probe_record.cu",
              "tools/probe_xpose.py:107", "probe_xpose",
              r15["extract"]["ns"] * 300 / 1e6, PX.bound(32, 300)),
        entry("K16", f"probe_bf16 (8 chains a lane in bf16x2, the 64x128 "
              f"tile over {PB.launch_geometry(64)[0]} SMs, 2 lanes a "
              f"thread; ms per launch in mode "
              f"bf16, 4000 steps)", "probe_bf16.cu",
              "tools/probe_bf16.py:65", "probe_bf16",
              r16["bf16"]["ns"] * 4000 / 1e6, PB.bound("bf16", 64, 4000)),
        dict(entry("K16", "", "probe_bf16.cu", "tools/probe_bf16.py:65",
                   "probe_bf16", r16["f32"]["ns"] * 4000 / 1e6,
                   PB.bound("f32", 64, 4000)),
             name=f"K16 probe_bf16 in float32 (the same chains, "
             f"2 lanes a thread, the same "
             f"{PB.launch_geometry(64)[0]} SMs; ms per launch in mode f32, "
             f"4000 steps; launches: both modes)",
             plain_ms=plain["K16 f32"]),
    ]


def _profile(card, runs, frames=5):
    """torch.profiler over `frames` frames of each (label, step) in runs
    (step(k) renders frame k): device busy time, kernel launches and
    synchronising calls per frame, the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync_calls = lambda avg: {e.key: e.count for e in avg
                              if "ynchroniz" in e.key}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()  # a window without frames
    print(f"profile of an empty window (one synchronize): synchronising "
          f"calls {sync_calls(prof.key_averages())}")
    for label, step in runs:
        busy, launches, avg, kern = _busy(step, frames)
        # the runtime's synchronising calls by name, to hold against the
        # empty window's
        syncs = sync_calls(avg)
        items = sum(e.count for e in avg
                    if e.key == "aten::_local_scalar_dense") / frames
        print(f"profile over {frames} {label} frames: device busy "
              f"{busy:.3f} ms/frame, {launches:.1f} kernel launches/frame, "
              f"synchronising calls in the window {syncs}, {items:.1f} "
              f"device-to-host scalar reads/frame {card}")
        top = sorted(kern, key=_dev_t, reverse=True)[:15]
        for e in top:
            calls = e.count // frames
            print(f"  {_dev_t(e) / frames / 1e3:8.3f} ms/frame  {calls:5d} "
                  f"calls/frame  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
