"""Traversal (bvh/packet.py, kernel K1): the plain version vs the JAX
wavefront traverser `intersect_scene` on the same SAH leaf-8 tree, and vs
a brute-force all-triangles oracle.

Tolerances: against the brute-force oracle (the port's own Moller-Trumbore
over every slot) the hit slot must agree on every ray up to ties between
distinct triangles at the same t (>= 99.9%), with t bitwise equal where the
slot agrees.  Against JAX's traverser — a watertight test, not
Moller-Trumbore — slots agree on >= 99.5% of rays (shared-edge rays may
resolve to either neighbour) and t to rtol 1e-5 (atol 5e-6: the float32
rounding of 30-unit vertex coordinates) where they agree.  Any-hit
occlusion flags must equal the brute-force answer.  K1 is held to the
plain version on the card in test_torch_kernels_gpu.py.

The traversal stack (TraceTables.levels / .stack): the levels are counted
from the records by an independent recursive walk, and the stack is the
smallest of STACK_DEPTHS that holds 3 entries a level.  On the chain scene
(engine/scene.py::build_chain_scene, 12 BVH4 levels) the plain traversal
must drop no push at the tables' depth, does drop pushes at 32 entries,
and its hits equal a float64 brute-force test of every triangle (the
squares' x where they hit, t to rtol 1e-6, the same rays missing)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh.sah import build_scene_tables_sah as jbuild
from rtrt_tpu.bvh.traverse import intersect_scene
from rtrt_tpu.engine import scene as JSC
from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.engine.engine import Engine
from rtrt_tpu_torch.engine.scene import (build_chain_scene, build_demo_scene,
                                         build_terrain_scene,
                                         chain_scene_rays, padded_arrays)
from rtrt_tpu_torch.utils.config import DynamicResolution, GlobalSettings

torch.set_num_threads(1)
N = 4096


@pytest.fixture(scope="module")
def setup():
    host = build_demo_scene()
    pad = padded_arrays(host)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    tables = P.pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))
    rng = np.random.default_rng(21)
    org = np.concatenate([
        rng.uniform(-6, 6, (N // 2, 3)) + [0, 3, -9],     # camera-like
        rng.uniform(-4, 4, (N // 2, 3)) + [0, 1.5, 0]],    # inside the trio
        axis=0).astype(np.float32)
    tgt = rng.uniform(-4, 4, (N, 3)).astype(np.float32) + [0, 1, 0]
    d = (tgt - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=N) < 0.2,
                     rng.uniform(0.5, 8, N), np.inf).astype(np.float32)
    jhost = JSC.build_demo_scene()
    jpad = JSC.padded_arrays(jhost)
    jbvh = jbuild(jhost.num_batches, jpad["indices"], jpad["tri_mat"],
                  jpad["valid"], jhost.vertices, jhost.normals,
                  leaf_max=8)[0]
    ref = jax.jit(lambda o, dd, tm: intersect_scene(
        jbvh, o, dd, tm, leaf_width=8, max_steps=4096))(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max))
    return dict(tables=tables, bvh=bvh, nrm=nrm, org=org, dir=d,
                t_max=t_max, ref=ref)


def _brute(tables, org, d, t_max):
    """Closest accepted Moller-Trumbore hit over ALL slots (first slot on
    ties), in float32 like the traversal."""
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    p = tables.tris.shape[0]
    best = torch.from_numpy(t_max).clone()
    tri = torch.full((o.shape[0],), -1, dtype=torch.int64)
    for s in range(0, p, 256):
        rec = tables.tris[s:s + 256]
        k = rec.shape[0]
        ok, t, _, _ = P._tri_test(rec.repeat(o.shape[0], 1),
                                  o.repeat_interleave(k, 0),
                                  dd.repeat_interleave(k, 0),
                                  torch.full((o.shape[0] * k,), np.inf))
        t = torch.where(ok, t, torch.full_like(t, np.inf)).reshape(-1, k)
        tmin, arg = t.min(dim=1)
        better = (tmin < best) & (tmin > 0)
        best = torch.where(better, tmin, best)
        tri = torch.where(better, s + arg, tri)
    return torch.where(tri >= 0, best, torch.full_like(best, np.inf)), tri


def test_plain_matches_brute_force(setup):
    tb = setup["tables"]
    ovf = P.overflow_counter("cpu")
    hit = P.packet_intersect(tb, torch.from_numpy(setup["org"]),
                             torch.from_numpy(setup["dir"]),
                             torch.from_numpy(setup["t_max"]), overflow=ovf)
    bt, btri = _brute(tb, setup["org"], setup["dir"], setup["t_max"])
    assert int(ovf) == 0
    assert (hit.tri >= 0).float().mean() > 0.3  # the rays do hit things
    same = hit.tri.long() == btri
    assert same.float().mean() >= 0.999
    assert torch.equal(hit.t[same], bt[same])
    # attributes at the hit slot
    h = hit.tri >= 0
    slot = hit.tri[h].long()
    w = 1 - hit.u[h] - hit.v[h]
    n = tb.nrm[slot]
    ns = w[:, None] * n[:, :3] + hit.u[h, None] * n[:, 3:6] \
        + hit.v[h, None] * n[:, 6:9]
    assert torch.equal(hit.ns[h], ns)
    assert torch.equal(hit.ng[h], tb.ng[slot])
    assert torch.equal(hit.mat[h], tb.mat[slot])
    assert torch.all(hit.mat[~h] == 0) and torch.all(hit.ns[~h] == 0)


def test_plain_matches_jax_traverser(setup):
    ref = setup["ref"]
    hit = P.packet_intersect_plain(setup["tables"],
                                   torch.from_numpy(setup["org"]),
                                   torch.from_numpy(setup["dir"]),
                                   torch.from_numpy(setup["t_max"]))
    rtri = np.asarray(ref.tri)
    same = rtri == hit.tri.numpy()
    assert same.mean() >= 0.995
    # atol: both tests derive t from vertex coordinates up to 30 units
    # (the ground quad), whose float32 rounding is ~30 * 2^-24 = 2e-6
    # absolute, which dominates for short hits
    np.testing.assert_allclose(np.asarray(ref.t)[same], hit.t.numpy()[same],
                               rtol=1e-5, atol=5e-6)


def test_any_hit_occlusion(setup):
    tb = setup["tables"]
    hit = P.packet_intersect(tb, torch.from_numpy(setup["org"]),
                             torch.from_numpy(setup["dir"]),
                             torch.from_numpy(setup["t_max"]), any_hit=True)
    _, btri = _brute(tb, setup["org"], setup["dir"], setup["t_max"])
    assert torch.equal(hit.tri >= 0, btri >= 0)
    h = hit.tri >= 0
    assert torch.all(hit.t[h] < torch.from_numpy(setup["t_max"])[h])


def test_overflow_is_counted_not_silent(setup):
    """With a 1-deep stack the far children cannot all be pushed: every
    dropped push must land in the counter."""
    tables = copy.copy(setup["tables"])
    tables.stack = 1
    ovf = P.overflow_counter("cpu")
    P.packet_intersect(tables, torch.from_numpy(setup["org"]),
                       torch.from_numpy(setup["dir"]), overflow=ovf)
    assert int(ovf) > 0


def _tables(host):
    pad = padded_arrays(host)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    return P.pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))


def _levels_walk(nodes, q=0):
    """Internal BVH4 levels below and including record q, recursively."""
    kids = [int(e) for e in nodes[q, 24:28] if e >= 0]
    inner = [e & 0x3FFFFF for e in kids if not e & (1 << 23)]
    return 1 + max((_levels_walk(nodes, c) for c in inner), default=0)


@pytest.mark.parametrize("scene,levels", [("terrain", 8), ("demo", 5),
                                          ("chain", 12)])
def test_tree_levels_and_stack_depth(scene, levels):
    host = {"terrain": lambda: build_terrain_scene(GlobalSettings()),
            "demo": build_demo_scene, "chain": build_chain_scene}[scene]()
    tb = _tables(host)
    assert tb.levels == _levels_walk(tb.nodes.numpy()) == levels
    assert tb.stack == min(d for d in P.STACK_DEPTHS if d >= 3 * levels)
    assert tb.stack == (32 if scene != "chain" else 256)
    assert tb.to("cpu").stack == tb.stack


@pytest.mark.parametrize("levels,depth", [(1, 32), (10, 32), (11, 256),
                                          (85, 256), (86, None)])
def test_stack_depth_choice(levels, depth):
    if depth is None:
        with pytest.raises(ValueError, match="86 internal levels"):
            P.stack_depth(levels)
    else:
        assert P.stack_depth(levels) == depth


def _brute64(tables, org, d):
    """Closest hit of every ray over every slot, in float64 (t > RAY_TMIN):
    (t, the hit triangle's v0 x) with inf where the ray misses."""
    rec = tables.tris.double().numpy()
    v0, e1, e2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    o, d = org.astype(np.float64), d.astype(np.float64)
    h = np.cross(d[:, None], e2[None])
    det = (e1[None] * h).sum(-1)
    real = np.abs(det) > 0  # padding slots are degenerate
    inv = np.where(real, 1.0 / np.where(real, det, 1.0), 0.0)
    p = o[:, None] - v0[None]
    q = np.cross(p, e1[None])
    u = (p * h).sum(-1) * inv
    v = (d[:, None] * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    ok = real & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > P.RAY_TMIN)
    t = np.where(ok, t, np.inf)
    k = t.argmin(1)
    best = t[np.arange(len(k)), k]
    return best, np.where(np.isfinite(best), v0[k, 0], np.inf)


def test_deep_tree_plain_traversal_drops_nothing():
    tb = _tables(build_chain_scene())
    org, d = chain_scene_rays(400, seed=3)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    n = org.shape[0]
    args = (o, dd, torch.full((n,), np.inf), torch.zeros(n, dtype=torch.bool))
    ovf, depth = P.overflow_counter("cpu"), P.overflow_counter("cpu")
    t, tri, _, _ = P.traverse_plain(tb, *args, ovf, depth=depth)
    assert int(ovf) == 0
    assert 32 < int(depth) <= 3 * tb.levels
    # the same rays with the small stack drop pushes (counted)
    small = copy.copy(tb)
    small.stack = 32
    ovf32 = P.overflow_counter("cpu")
    P.traverse_plain(small, *args, ovf32)
    assert int(ovf32) > 0
    bt, bx = _brute64(tb, org, d)
    hit = (tri >= 0).numpy()
    assert hit.mean() > 0.9 and np.array_equal(hit, np.isfinite(bt))
    assert np.array_equal(tb.tris[tri[hit].long(), 0].double().numpy(),
                          bx[hit])
    np.testing.assert_allclose(t.numpy()[hit], bt[hit], rtol=1e-6)
    # hits at many depths of the chain
    assert np.unique(bx[hit]).size > 40


def test_engine_refuses_a_tree_beyond_the_deepest_stack(monkeypatch):
    """No tree the SAH builder makes needs more than 256 entries (L <= 82,
    STACK_DEPTHS), so the deepest instantiation is lowered to 32 here: the
    chain scene (12 levels, 36 entries) is then beyond it, and the Engine
    raises before anything renders."""
    settings = GlobalSettings(render_width=32, render_height=16,
                              dynamic_resolution=DynamicResolution(
                                  enabled=False))
    monkeypatch.setattr(P, "STACK_DEPTHS", (32,))
    with pytest.raises(ValueError, match="12 internal levels.*36-entry"):
        Engine(settings, scene=build_chain_scene(), device="cpu")
    Engine(settings, scene=build_demo_scene(), device="cpu")
