"""One frame of the product path (port of rtrt_tpu/engine/frame.py::
render_frame: its static branch over prebuilt SAH or LBVH tables, its two
animated branches, below, and its two trace routes):

  raygen (blue-noise jitter + thin lens) -> path_trace_mega (K2, with K1's
  traversal inside) -> finish_gbuffer, or the wavefront path_trace ->
  [interlace: full-height reconstruction] -> SVGF denoise (K5 history
  reprojection, K4 a-trous passes; or color * albedo with the denoiser
  off) -> sun screen position and visibility -> postprocess (exposure
  pyramid, bloom, lens flare, the fused tail K3; below the screen size the
  Catmull-Rom upscale and K3's pre-mapped instantiation) -> uint8.

The trace route (FrameStatic.use_megakernel, .use_packets): the megakernel
(the default) traces the image-shaped rays in one K2 launch; the wavefront
route (use_megakernel=False, render/integrator.py::path_trace) traces the
flat rays of every pixel (ids 0 .. h*w - 1, their blue-noise offsets in
the same order) segment by segment, through K1 (use_packets=True) or the
loop traverser (use_packets=False, on scene.bvh), and its flat G-buffer is
reshaped to the image, as the JAX frame's wavefront branch does.  Its
textured materials take the procedural soil or, with
procedural_textures off, the soil texture set's gather (scene.textures);
a Fourier fit (ftex) serves only K2.

Interlace (FrameStatic.interlace, even render heights, megakernel route
only, as in the JAX frame): a frame traces the h/2 rows y = 2i +
(frame & 1) — K2 takes pixel ids as data, so the field's ids and
blue-noise rows are all it needs — and fills the other rows from their
traced neighbours before the denoiser.

Animation (render_frame's `rest`): before raygen the frame moves the scene
by a travelling wave and writes the tables in place, in one of the JAX
frame's two branches for animation="wave", chosen by the type of `rest`:
  * a RestPose (the refit branch): displace the rest-pose sorted triangle
    rows, transform their normals, refit the frozen BVH4 (bvh/refit.py)
    (`animate_tables`);
  * a MeshPose (the rebuild branch): displace the rest mesh's vertices,
    recompute its smooth normals, rebuild the two-level LBVH on the device
    (bvh/build.py) and repack the binary tables (`rebuild_tables`).  A
    MeshPose that holds its normals does not move: its frames rebuild the
    static scene's LBVH in the frame (the JAX frame's branch without
    prebuilt tables, animation="none"; profile_frame's --rebuild).
With FeatureFlags ocean / stars, escaped rays take their radiance from
render/environment.py instead of the sky fit alone.  Both read the
animation clock, FrameState.time, which accumulates in float32 as the JAX
frame's does (`advance_clock`).  With a Fourier fit in FrameStatic.ftex,
K2 shades textured materials from it (render/ftex.py).

Each frame is a sequence of torch ops and kernel launches (K2, K5, four
K4, K3 with the default flags), with every tensor on the scene's device
and no host sync.  Given FrameUniforms (render_frame's `uniforms`), it
reads the values that change from frame to frame from the device, and
copies nothing from the host, so the Engine can capture it as a CUDA
graph and replay it (engine/engine.py).

A band (render_frame's `band`, a RowMesh of parallel/frame_spmd.py: the
port's counterpart of the JAX frame's row_sharding / trace_mesh) renders
one rank's rows [r0, r1) of the row-sharded frame: its rays, pixel ids
and blue-noise rows are the band's rows of the frame's constants (global
ids, so K2's random numbers are the whole frame's), K2 or the wavefront
traces them, the interlace fill takes the traced rows of the whole field,
the denoiser and the post chain read the rows they need beyond the band
from the other ranks (denoise/pipeline.py, post/pipeline.py), and the
sun's visibility is the depth at its pixel on the rank that holds it,
shared by an all-reduce.  The result is the band's rows of the whole
frame's image, state and G-buffer.  band=None is the whole frame.

Cut points (FrameStatic.stop_after, the JAX frame's profiling cuts that
tools/profile_frame.py times): the frame ends after the named stage and
returns (outputs, state) with the state it was given:
  "bvh"     after the animation or rebuild stage: (scene.tables,);
  "trace"   (color, albedo, normal, depth, mat_id, motion) after the
            interlace fill and the NaN guards;
  "steps"   (steps,): K2's (segments + 1, traced rows, w) int32
            traversal-step planes (megakernel route only; half height
            under interlace, as JAX's);
  "denoise" (final, new_history);
  "full"    the whole frame (render_frame's usual result).
The port refuses what the JAX frame renders in full without a word: a
"steps" cut on the wavefront route and any cut of a band (ValueError).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bvh.build import build_scene_bvh
from ..bvh.packet import refresh_tables, write_tables_binary
from ..bvh.refit import DeviceRefit
from ..bvh.types import BATCH_SIZE
from ..core.camera import Camera, camera_basis, world_to_screen
from ..denoise.pipeline import DenoiseHistory, denoise
from ..ops.gather import onehot_permute
from ..ops.reduce import segment_sum
from ..ops.resize import upscale_catmull_rom
from ..post.pipeline import (band_halo, dither_mask, postprocess,
                             upscale_band)
from ..render.environment import env_radiance_scene
from ..render.ftex import FtexTable
from ..render import integrator
from ..render.integrator import GBuffer, SceneData, path_trace
from ..render.megakernel import (check_segments, path_trace_mega,
                                 trace_scene_mega)
from ..render.raygen import generate_rays_padded
from ..render.sampling import blue_offsets_flat, bn_point, rand2, rand2_bn
from ..utils.config import FeatureFlags, RenderParams
from ..utils.debug import nan_guard


@dataclasses.dataclass
class FrameState:
    """State carried from frame to frame."""

    exposure: torch.Tensor  # (4,) auto-exposure state (on the device)
    history: DenoiseHistory = None  # denoiser history (flags.denoise)
    frame_idx: int = 0      # uint32 frame counter
    time: float = 0.0       # accumulated time (s): a float32 value
    #   (advance_clock), held on the host so that reading it never syncs


STOP_AFTER = ("full", "bvh", "trace", "steps", "denoise")


@dataclasses.dataclass(frozen=True)
class FrameStatic:
    """Static frame configuration."""

    render_w: int
    render_h: int
    screen_w: int
    screen_h: int
    flags: FeatureFlags
    interlace: bool = False  # trace half the rows a frame (even heights)
    ftex: FtexTable | None = None  # the fitted texture set, with K2's
    #   table of it on the device, that shades textured materials in place
    #   of the procedural soil (render/ftex.py::upload_ftex; the Engine
    #   fits and uploads it at init with fourier_textures)
    use_megakernel: bool = True  # K2; False: the wavefront path_trace
    use_packets: bool = True  # the wavefront's traversal: K1 on
    #   scene.tables; False: the loop traverser on scene.bvh
    stop_after: str = "full"  # the cut point (module docstring):
    #   full | bvh | trace | steps | denoise

    def __post_init__(self):
        if self.stop_after not in STOP_AFTER:
            raise ValueError(f"stop_after={self.stop_after!r}: expected one "
                             f"of {STOP_AFTER}")
        if self.stop_after == "steps" and not self.use_megakernel:
            raise ValueError("stop_after='steps' reads K2's step planes: "
                             "it needs use_megakernel")
        if self.use_megakernel:  # RTRT_SEGMENTS beyond K2's 1..5 raises
            check_segments(integrator.SEGMENTS)


@dataclasses.dataclass
class FrameConsts:
    """Per-resolution constant tensors, built once (make_frame_consts)."""

    pixel_ids: torch.Tensor   # (h, w) int32
    bn: torch.Tensor          # (h, w, 2) blue-noise offsets, or None
    mask: torch.Tensor        # (64, 64) dither mask (a band's: rolled so
    #   that K3's first row is the screen row above the band)
    # interlaced frames: per field parity p, the traced rows' (pixel ids,
    # blue-noise offsets): rows p, p + 2, ... of the two above; else None
    fields: tuple = None


# the words of FrameUniforms (int32; a float as its float32 bits)
U_FRAME = 0        # the frame index (uint32)
U_CAMERA = 1       # 8: pos x, y, z, yaw, pitch, fov_y, aperture, focal_dist
U_PREV_CAMERA = 9  # 8: the previous frame's camera
U_WAVE = 17        # 2: wave_phases(time)
U_DT = 19          # the frame time (s)
U_BN = 20          # 4: bn_point(frame, 0), bn_point(frame, 256)
U_WORDS = 24
BN_DIMS = (0, 256)  # the dimension pairs of the primary rays' jitter, lens


class FrameUniforms:
    """The values that change from frame to frame, in one (U_WORDS,) int32
    device buffer, `words`, for a frame captured as a CUDA graph, which
    reads them at each replay (engine/engine.py writes them before it).
    render_frame given one reads them there in place of the frame index,
    clock, dt and cameras it is given; the attributes are views of
    `words`: frame (1,) int32, camera / prev_camera, wave (2,), dt 0-d, bn
    (2, 2) (the rows of BN_DIMS)."""

    def __init__(self, words: torch.Tensor):
        self.words = words
        f = words.view(torch.float32)
        cam = lambda k: Camera(f[k:k + 3], *f[k + 3:k + 8])
        self.frame = words[U_FRAME:U_FRAME + 1]
        self.camera = cam(U_CAMERA)
        self.prev_camera = cam(U_PREV_CAMERA)
        self.wave = f[U_WAVE:U_WAVE + 2]
        self.dt = f[U_DT]
        self.bn = f[U_BN:U_BN + 4].view(2, 2)


def uniform_words(frame: int, camera, prev_camera, time: float,
                  dt: float) -> np.ndarray:
    """FrameUniforms' words on the host for frame index `frame`, the clock
    `time` and the frame time dt.  camera / prev_camera: 8 float32 values
    each (U_CAMERA's order), or None to leave them 0 (a camera known only
    on the device, copied there)."""
    w = np.zeros(U_WORDS, np.int32)
    f = w.view(np.float32)
    w[U_FRAME] = np.array(frame & 0xFFFFFFFF, np.uint32).view(np.int32)
    for k, cam in ((U_CAMERA, camera), (U_PREV_CAMERA, prev_camera)):
        if cam is not None:
            f[k:k + 8] = cam
    f[U_WAVE:U_WAVE + 2] = wave_phases(time)
    f[U_DT] = dt
    f[U_BN:U_BN + 4] = [x for d in BN_DIMS for x in bn_point(frame, d)]
    return w


@dataclasses.dataclass
class RestPose:
    """The animated scene's rest pose and refit schedule (on the device):
    the sorted (9, P) vertex rows and vertex normals of the init-time SAH
    tables, and the frozen BVH4's DeviceRefit.  A frame given one refits."""

    tris_t: torch.Tensor
    nrm_t: torch.Tensor
    refit: DeviceRefit

    def animate(self, tables, time):
        animate_tables(tables, self, time)


@dataclasses.dataclass
class MeshPose:
    """The animated scene's rest mesh (on the device), whose frames rebuild
    the two-level LBVH: the vertices (V, 3), the padded triangle indices
    (B * 1024, 3), materials (B * 1024,) and valid mask (B, 1024) of
    engine/scene.py::padded_arrays.  Without normals the pose moves: the
    normals are recomputed from the displaced vertices every frame.  With
    the vertex normals (V, 3) the pose is the static scene, unmoved, and
    keeps them.  A frame given one rebuilds."""

    vertices: torch.Tensor
    indices: torch.Tensor
    tri_mat: torch.Tensor
    valid: torch.Tensor
    normals: torch.Tensor | None = None

    def animate(self, tables, time):
        rebuild_tables(tables, self, time)


# the travelling wave of animation="wave": y += WAVE_AMP * sin(WAVE_FREQ x +
# WAVE_SPEED t) * cos(0.8 WAVE_FREQ z + 1.1 t)
WAVE_AMP = 0.35
WAVE_FREQ = 0.5
WAVE_SPEED = 1.5


def advance_clock(time: float, dt: float) -> float:
    """The animation clock after a frame of dt seconds, accumulated in
    float32 as the JAX frame's jnp.float32 clock is."""
    return float(np.float32(time) + np.float32(dt))


def _f32(x):
    """A Python float rounded to float32: scalars that the JAX frame forms
    in float32 (the clock times a constant) enter torch ops exactly."""
    return float(np.float32(x))


def wave_phases(time):
    """The wave's clock products (WAVE_SPEED t, 1.1 t), each formed and
    rounded in float32 as the JAX frame forms them: Python floats for the
    clock `time` (a float), or the two 0-d elements of a (2,) float32
    tensor that holds them already (a replayed frame's uniforms, filled
    from the host's floats).  The wave's functions take either as
    `time`."""
    if torch.is_tensor(time):
        return time[0], time[1]
    t = np.float32(time)
    return _f32(t * np.float32(WAVE_SPEED)), _f32(t * np.float32(1.1))


def _wave_dy(x, z, time):
    """The wave's displacement along y at (x, z), in the JAX function's
    order of operations."""
    pa, pb = wave_phases(time)
    return WAVE_AMP * torch.sin(x * WAVE_FREQ + pa) \
        * torch.cos(z * (WAVE_FREQ * 0.8) + pb)


def displace_wave(vertices, time):
    """Travelling wave along y applied to (V, 3) vertices (the rebuild
    branch's form); time as wave_phases takes it."""
    out = vertices.clone()
    out[:, 1] += _wave_dy(vertices[:, 0], vertices[:, 2], time)
    return out


def displace_wave_rows(tris_t, time):
    """Travelling wave along y applied to the sorted (9, P) triangle rows
    (rows 0-2/3-5/6-8 = v0/v1/v2): a function of (x, z) only, so no gather.
    The three vertices go through each op as one (3, P) stack."""
    v = tris_t.reshape(3, 3, -1)
    out = v.clone()
    out[:, 1] += _wave_dy(v[:, 0], v[:, 2], time)
    return out.reshape(tris_t.shape)


def wave_normal_rows(nrm_t, tris_t, time):
    """Exact shading-normal transform under p' = p + d(x, z) y: n'_x = n_x -
    dd/dx n_y, n'_z = n_z - dd/dz n_y, normalised.  nrm_t / tris_t: (9, P)
    sorted rows at the rest pose."""
    v = tris_t.reshape(3, 3, -1)
    n = nrm_t.reshape(3, 3, -1)
    wa, wb = wave_phases(time)
    pa = v[:, 0] * WAVE_FREQ + wa
    pb = v[:, 2] * (WAVE_FREQ * 0.8) + wb
    ddx = WAVE_AMP * WAVE_FREQ * torch.cos(pa) * torch.cos(pb)
    ddz = -WAVE_AMP * WAVE_FREQ * 0.8 * torch.sin(pa) * torch.sin(pb)
    ny = n[:, 1]
    nx = n[:, 0] - ddx * ny
    nz = n[:, 2] - ddz * ny
    il = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    return torch.stack([nx * il, ny * il, nz * il], dim=1).reshape(
        nrm_t.shape)


def animate_tables(tables, rest: RestPose, time):
    """The refit stage of an animated frame: displace the rest pose at
    `time`, transform its normals, refit the BVH4 records and write the
    frame's nodes, triangles, normals and geometric normals into `tables`
    in place."""
    tt = displace_wave_rows(rest.tris_t, time)
    rest.refit.refit(tables.nodes, tt)
    refresh_tables(tables, tt, wave_normal_rows(rest.nrm_t, rest.tris_t,
                                                time))


def compute_smooth_normals(vertices, indices):
    """Area-weighted vertex normals: each triangle's cross product summed
    into its three vertices (segment sums, the JAX function's order), then
    normalised.  indices (T, 3) with padding triangles (0, 0, 0), whose
    cross product is 0."""
    v0, v1, v2 = (vertices[indices[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    nv = vertices.shape[0]
    acc = (segment_sum(fn, indices[:, 0], nv)
           + segment_sum(fn, indices[:, 1], nv)
           + segment_sum(fn, indices[:, 2], nv))
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp(norm, min=1e-12)


def build_scene_tables(num_batches: int, indices, tri_mat, valid, verts,
                       nrm):
    """Two-level LBVH of the padded scene + its sorted per-triangle
    attributes: returns (bvh, tri_nrm_t (9, P) f32, sorted_mat (P,) i32),
    on the device of `verts`.  indices (B * 1024, 3), tri_mat (B * 1024,),
    valid (B, 1024), verts / nrm (V, 3)."""
    b = num_batches
    indices = indices.to(torch.int64)
    tv = [verts[indices[:, k]].reshape(b, BATCH_SIZE, 3) for k in range(3)]
    bvh = build_scene_bvh(*tv, valid)
    # the batch-local permutation of the indices and materials
    reorder = bvh.sorted_tri_index.reshape(b, BATCH_SIZE).to(torch.int64) \
        - (torch.arange(b, device=verts.device) * BATCH_SIZE)[:, None]
    perm = onehot_permute(torch.cat(
        [indices.reshape(b, BATCH_SIZE, 3),
         tri_mat.to(torch.int64).reshape(b, BATCH_SIZE, 1)], -1), reorder)
    flat_idx = perm[..., 0:3].reshape(-1, 3)
    tri_nrm_t = torch.cat([nrm[flat_idx[:, k]].T for k in range(3)], 0)
    return bvh, tri_nrm_t, perm[..., 3].reshape(-1).to(torch.int32)


def rebuild_tables(tables, mesh: MeshPose, time):
    """The rebuild stage of a frame: displace the rest mesh at `time` and
    recompute its smooth normals (a static pose, which holds its normals:
    neither), rebuild the two-level LBVH and write the frame's binary
    tables into `tables` in place."""
    if mesh.normals is not None:
        verts, nrm = mesh.vertices, mesh.normals
    else:
        verts = displace_wave(mesh.vertices, time)
        nrm = compute_smooth_normals(verts, mesh.indices)
    write_tables_binary(tables, *build_scene_tables(
        mesh.valid.shape[0], mesh.indices, mesh.tri_mat, mesh.valid, verts,
        nrm))


def interlaced(static: FrameStatic) -> bool:
    """Whether frames of `static` trace half their rows (the megakernel
    route only)."""
    return (static.interlace and static.use_megakernel
            and static.render_h % 2 == 0)


def make_frame_consts(static: FrameStatic, device,
                      band=None) -> FrameConsts:
    """The frame's constants, or a band's (a RowMesh): its rows of them."""
    w, h = static.render_w, static.render_h
    r0, r1 = (0, h) if band is None else (band.r0, band.r1)
    ys = torch.arange(r0, r1, dtype=torch.int32, device=device)
    xs = torch.arange(w, dtype=torch.int32, device=device)
    pixel_ids = ys[:, None] * w + xs[None, :]
    bn = None
    if static.flags.blue_noise:
        bn = torch.from_numpy(blue_offsets_flat(w, h, w * h).reshape(
            h, w, 2)[r0:r1]).to(device)
    fields = None
    if interlaced(static):
        # a band starts on an even row (frame_spmd's rule), so its rows
        # of parity p are its rows p, p + 2, ...
        fields = tuple(
            (pixel_ids[p::2].contiguous(),
             None if bn is None else bn[p::2].contiguous()) for p in (0, 1))
    mask = dither_mask(device)
    if band is not None:
        mask = torch.roll(mask, -(band.s0 - 1), 0)
    return FrameConsts(pixel_ids, bn, mask, fields)


def interleave_rows(a, b):
    """Row-interleave two (h2, w, ...) tensors into (2*h2, w, ...):
    out[0::2] = a, out[1::2] = b (any dtype)."""
    out = torch.empty((2 * a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def fill_linear(c, parity: int):
    """Full-height plane from the traced field c (rows y = 2i + parity):
    each missing row is the mean of its traced neighbours (the edge row
    repeats its one neighbour).  For radiance and albedo."""
    if parity:
        prv = torch.cat([c[:1], c[:-1]], dim=0)
        return interleave_rows((prv + c) * 0.5, c)
    nxt = torch.cat([c[1:], c[-1:]], dim=0)
    return interleave_rows(c, (c + nxt) * 0.5)


def fill_nearest(c):
    """Full-height plane from a traced field: rows 2i and 2i + 1 both take
    traced row i (either parity).  For geometry planes, where a mean
    across a silhouette would invent a surface."""
    return interleave_rows(c, c)


def _fill_band(gbuf: GBuffer, parity: int, band) -> GBuffer:
    """A band's rows of the full-height planes of the interlaced frame: the
    fill of the whole field (gathered from the ranks' traced rows), cut to
    the band."""
    names = [f.name for f in dataclasses.fields(gbuf)]
    field = dict(zip(names, band.gather([getattr(gbuf, n) for n in names])))
    cut = lambda x: x[band.r0:band.r1]
    return GBuffer(color=cut(fill_linear(field["color"], parity)),
                   albedo=cut(fill_linear(field["albedo"], parity)),
                   **{n: cut(fill_nearest(field[n]))
                      for n in ("normal", "depth", "motion", "mat_id")})


def render_frame(static: FrameStatic, scene: SceneData, state: FrameState,
                 camera: Camera, prev_camera: Camera, params: RenderParams,
                 dt: float, consts: FrameConsts = None, overflow=None,
                 stack_depth=None, rest: RestPose = None, band=None,
                 uniforms: FrameUniforms = None, history_out=None):
    """One full frame.  Returns (u8 image (screen_h, screen_w, 3),
    new FrameState, GBuffer).  The G-buffer is the traced one: with
    interlace, the field's (h/2, w) planes.  overflow: optional (1,) int32
    counter of dropped traversal-stack pushes; stack_depth: optional (1,)
    int32 counter raised to the deepest traversal stack (K2's; the
    wavefront route leaves it as it is); rest: a scene
    animated by the travelling wave, whose frame writes scene.tables in
    place — a RestPose refits the BVH4, a MeshPose rebuilds the two-level
    LBVH (None: a static scene).  band: a rank's RowMesh of the
    row-sharded frame (module docstring; parallel/frame_spmd.py::
    make_spmd_frame_fn checks the configuration): the image, the state's
    history and the G-buffer are then its band's rows, and consts, if
    given, the band's (make_frame_consts(..., band)).  static.stop_after
    other than "full" ends the frame at that cut and returns (outputs,
    state) (module docstring).

    uniforms: the frame's FrameUniforms, whose device values the frame
    reads in place of state.frame_idx, state.time, dt, camera and
    prev_camera (a frame captured as a CUDA graph); the returned state is
    still worked out from the host's.  history_out: a DenoiseHistory whose
    planes receive the new history (they may be state.history's own)."""
    w, h = static.render_w, static.render_h
    dev = scene.tables.nodes.device
    stop = static.stop_after
    flags = static.flags
    if stop != "full" and band is not None:
        raise ValueError(f"stop_after={stop!r} with a band: the cut points "
                         "time the whole frame")
    if uniforms is not None and (flags.ocean or flags.stars):
        raise ValueError("FrameUniforms do not hold the ocean's and the "
                         "stars' clock: such a frame takes the host's")
    clock, frame_dt = state.time, dt
    if uniforms is not None:
        camera, prev_camera = uniforms.camera, uniforms.prev_camera
        clock, frame_dt = uniforms.wave, uniforms.dt
    if rest is not None:
        rest.animate(scene.tables, clock)
    if stop == "bvh":
        return (scene.tables,), state
    if consts is None:
        consts = make_frame_consts(static, dev, band)
    frame = state.frame_idx
    parity = frame & 1
    # the frame index that K2, the samples and the dither read
    dframe = frame if uniforms is None else uniforms.frame
    if interlaced(static):
        pixel_ids, bn = consts.fields[parity]
    else:
        pixel_ids, bn = consts.pixel_ids, consts.bn

    cam = dataclasses.replace(
        camera, aperture=torch.full((), params.sample.aperture, device=dev),
        focal_dist=torch.full((), params.sample.focal_dist, device=dev))
    basis = camera_basis(cam)
    prev_basis = camera_basis(prev_camera)
    if bn is not None:
        point = (None, None) if uniforms is None else uniforms.bn
        jitter, lens = (rand2_bn(bn, frame, d, point=pt)
                        for d, pt in zip(BN_DIMS, point))
    else:
        jitter, lens = (rand2(pixel_ids, dframe, d) for d in BN_DIMS)
    rays = generate_rays_padded(basis, w, h, pixel_ids, jitter, lens)

    # sky + ocean + stars for escaped rays, from the primary rays' origins
    # (render/environment.py)
    env_fn = None
    if flags.ocean or flags.stars:
        env_fn = lambda o, d: env_radiance_scene(
            scene.sky, o, d, state.time, ocean=flags.ocean,
            stars=flags.stars)

    if stop == "steps":  # traced without ftex, as the JAX cut is
        lead = tuple(rays.cone_width.shape)
        segs = integrator.SEGMENTS
        steps = torch.empty((segs + 1, rays.cone_width.numel()),
                            dtype=torch.int32, device=rays.org.device)
        trace_scene_mega(scene, rays, pixel_ids, dframe,
                         static.flags.procedural_textures, bn, overflow,
                         stack_depth, steps=steps)
        return (steps.reshape((segs + 1,) + lead),), state
    if static.use_megakernel:
        gbuf: GBuffer = path_trace_mega(
            scene, rays, pixel_ids, dframe, prev_basis, w / h,
            use_proctex=static.flags.procedural_textures, bn=bn,
            overflow=overflow, stack_depth=stack_depth, env_fn=env_fn,
            ftex=static.ftex)
    else:
        lead = tuple(pixel_ids.shape)  # (h, w), or the band's (rows, w)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        g = path_trace(
            scene, dataclasses.replace(rays, **{
                f.name: flat(getattr(rays, f.name)).contiguous()
                for f in dataclasses.fields(rays)}),
            flat(pixel_ids), dframe, prev_basis, w / h,
            use_packets=static.use_packets,
            use_proctex=static.flags.procedural_textures,
            bn=None if bn is None else flat(bn), env_fn=env_fn,
            leaf_width=scene.tables.leaf_width, overflow=overflow)
        gbuf = GBuffer(**{f.name: getattr(g, f.name).reshape(
            lead + tuple(getattr(g, f.name).shape[1:]))
            for f in dataclasses.fields(g)})
    full = gbuf
    if interlaced(static) and band is not None:
        full = _fill_band(gbuf, parity, band)
    elif interlaced(static):
        full = GBuffer(color=fill_linear(gbuf.color, parity),
                       albedo=fill_linear(gbuf.albedo, parity),
                       normal=fill_nearest(gbuf.normal),
                       depth=fill_nearest(gbuf.depth),
                       motion=fill_nearest(gbuf.motion),
                       mat_id=fill_nearest(gbuf.mat_id))
    # NaN guards under RTRT_DEBUG=1 (utils/debug.py; the identity, with no
    # launch, when off), where the JAX frame places them
    full = dataclasses.replace(
        full, color=nan_guard(full.color, "trace.radiance"),
        albedo=nan_guard(full.albedo, "trace.albedo"),
        normal=nan_guard(full.normal, "trace.normal"),
        motion=nan_guard(full.motion, "trace.motion"))
    if stop == "trace":
        return (full.color, full.albedo, full.normal, full.depth,
                full.mat_id, full.motion), state

    if static.flags.denoise:
        if state.history is None:
            raise ValueError("FeatureFlags.denoise needs FrameState.history "
                             "(denoise.pipeline.init_history)")
        final, new_history = denoise(
            full.color, full.albedo, full.normal, full.depth, full.mat_id,
            full.motion, state.history, params.denoise, static.flags,
            frame_parity=parity, band=band, out=history_out)
    else:
        final = full.color * full.albedo
        new_history = state.history
    if stop == "denoise":
        return (final, new_history), state

    # sun screen position; visible where the depth at its pixel is sky
    # (read on the device: no host sync)
    sun_uv, sun_z = world_to_screen(basis, basis.pos + scene.sky.sun_dir
                                    * 1e4, w / h)
    sx = torch.clamp(torch.clamp(sun_uv[0] * w, -1.0, float(w)).to(
        torch.int64), 0, w - 1)
    sy = torch.clamp(torch.clamp(sun_uv[1] * h, -1.0, float(h)).to(
        torch.int64), 0, h - 1)
    if band is None:
        d_sun = full.depth.reshape(-1).index_select(0, (sy * w + sx)
                                                    .reshape(1))
    else:
        # the rank whose band holds the pixel gives its depth, the others 0
        own = (sy >= band.r0) & (sy < band.r1)
        ly = torch.clamp(sy - band.r0, 0, band.r1 - band.r0 - 1)
        d_sun = band.all_reduce_sum(torch.where(
            own, full.depth.reshape(-1).index_select(0, (ly * w + sx)
                                                     .reshape(1)), 0.0))
    sun_visible = ((sun_z > 0) & ~torch.isfinite(d_sun[0])).to(torch.float32)

    sw, sh = static.screen_w, static.screen_h
    if static.flags.postprocess:
        image, new_exposure = postprocess(
            final, state.exposure, frame_dt, sun_uv, sun_visible,
            params.post, static.flags, sh, sw, dframe, mask=consts.mask,
            band=band)
    else:
        ldr = torch.clamp(final, 0.0, 1.0) ** (1.0 / 2.2)
        if (sh, sw) != (h, w) and band is None:
            ldr = torch.clamp(upscale_catmull_rom(ldr, sh, sw), 0.0, 1.0)
        elif (sh, sw) != (h, w):
            ldr = upscale_band(band.extend(band.gather([ldr])[0],
                                           band_halo(h, sh)), band, sh, sw)
        image = (ldr * 255.0 + 0.5).to(torch.uint8)
        new_exposure = state.exposure

    new_state = FrameState(exposure=new_exposure, history=new_history,
                           frame_idx=(frame + 1) & 0xFFFFFFFF,
                           time=advance_clock(state.time, dt))
    return image, new_state, gbuf
