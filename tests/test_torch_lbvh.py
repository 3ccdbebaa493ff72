"""The two-level LBVH build and its binary traversal in the port against the
JAX package, on the same numpy-seeded inputs.

  * ops: morton codes (30- and 63-bit; the 63-bit JAX codes need x64),
    normalize_to_aabb, sort_key_index with duplicate and padding keys,
    sort_key_val, the min / max sparse table and its range queries (every
    span up to 1024), segment_sum, onehot_permute, the box helpers, the
    entry packing: bit-equal, but segment_sum, whose additions may run in
    another order (rtol 1e-6);
  * bvh/build.py: lbvh_topology at n = 2, 3, 64 and 1024 with duplicate
    codes, batched and alone, and build_scene_bvh on the demo scene and on
    random padded soups (one with an empty batch): every array bit-equal.
    They are integer logic and min / max of the same float32 boxes;
  * the binary tables' traversal (bvh/packet.py, K1's plain version on
    arity 2): against a brute-force Moller-Trumbore over every slot (the
    slot on >= 99.9% of rays, t bit-equal where it agrees, as
    tests/test_torch_packet.py), against JAX's wavefront `intersect_scene`
    on the same tree (slots on >= 99.5%, t to rtol 1e-5 + atol 5e-6: JAX
    tests watertight, not Moller-Trumbore) and against the JAX packet
    kernel at arity 2 in Pallas interpret mode (one tile; the finite /
    infinite t on >= 99.9%, t to rtol 1e-4 + atol 1e-4 as
    tests/test_packet_tpu.py holds it against the wavefront); any-hit
    flags equal the brute force's;
  * the static stack bound (bvh/packet.py::binary_stack_bound): its value,
    the stack it picks, the refusal when no instantiation holds it, and an
    adversarial soup (every triangle at one point, so every code is equal):
    the tree's internal depth and the plain traversal's deepest stack stay
    within it, with 0 dropped pushes.
  * the plain K2 on binary tables against JAX's simulate_megakernel on the
    JAX-built LBVH (the same tree bit for bit) at 64x32, with and without
    blue noise, at the bounds of tests/test_torch_megakernel.py (the
    simulator's wavefront traverser tests triangles watertight, the port
    Moller-Trumbore).
K1 / K2's binary instantiations are held to the plain version on the card
in tests/test_torch_kernels_gpu.py; whole LBVH frames are held to JAX's in
tests/test_torch_frame_lbvh.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh import build as JB
from rtrt_tpu.bvh import types as JT
from rtrt_tpu.bvh.packet import pack_for_packets, packet_intersect
from rtrt_tpu.bvh.traverse import intersect_scene
from rtrt_tpu.core import geometry as JG
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine import frame as JF
from rtrt_tpu.engine.scene import build_demo_scene as jdemo
from rtrt_tpu.engine.scene import padded_arrays as jpadded
from rtrt_tpu.ops import gather as JGA
from rtrt_tpu.ops import morton as JM
from rtrt_tpu.ops import reduce as JR
from rtrt_tpu.ops import sort as JS
from rtrt_tpu.render import megakernel as JMK
from rtrt_tpu.render.integrator import SceneData as JSceneData
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.sampling import blue_offsets_flat, rand2, rand2_bn
from rtrt_tpu.render.sky import bake_sky_maps, finalize_sky_maps, \
    make_sky_params
from rtrt_tpu_torch.bvh import build as TB
from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh import types as TT
from rtrt_tpu_torch.core import geometry as TG
from rtrt_tpu_torch.core.camera import camera_basis as tbasis
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu_torch.ops import gather as TGA
from rtrt_tpu_torch.ops import morton as TM
from rtrt_tpu_torch.ops import reduce as TR
from rtrt_tpu_torch.ops import sort as TS
from rtrt_tpu_torch.render import megakernel as TMK
from rtrt_tpu_torch.render.integrator import SceneData
from rtrt_tpu_torch.render.kshade import pack_materials_rows
from rtrt_tpu_torch.render.raygen import Rays
from rtrt_tpu_torch.utils import interop

from test_torch_megakernel import _gbuffers_close

torch.set_num_threads(1)
BVH_FIELDS = ("boxes_t", "children_t", "tris_t", "sorted_tri_index",
              "root_lo", "root_hi")


def _t(a):
    """A CPU tensor of its own copy of numpy / JAX array a."""
    return torch.from_numpy(np.array(a))


def _bits_equal(a, b):
    """Same shape and the same bits (floats compared as their bit patterns,
    so infinities and signed zeros count)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.astype(np.float32).view(np.int32),
                              b.astype(np.float32).view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _points(rng, n=4096):
    p = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    p[:16] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1023 / 1024] * 3] * 4
    return p


def test_morton30_matches_jax(rng):
    p = _points(rng)
    assert _bits_equal(JM.morton3d_30(jnp.asarray(p)),
                       TM.morton3d_30(_t(p)).numpy())
    x = rng.integers(0, 1 << 12, 4096).astype(np.uint32)
    assert _bits_equal(JM.expand_bits_30(jnp.asarray(x)),
                       TM.expand_bits_30(_t(x.astype(np.int64))).numpy())


def test_morton63_matches_jax(rng):
    p = _points(rng)
    with jax.enable_x64(True):
        ref = np.asarray(JM.morton3d_63(jnp.asarray(p)))
        x = rng.integers(0, 1 << 23, 4096).astype(np.uint64)
        ref_x = np.asarray(JM.expand_bits_63(jnp.asarray(x)))
    assert ref.dtype == np.uint64 and ref.max() >= 1 << 62
    got = TM.morton3d_63(_t(p)).numpy()
    assert np.array_equal(ref, got.astype(np.uint64))
    assert np.array_equal(ref_x, TM.expand_bits_63(
        _t(x.astype(np.int64))).numpy().astype(np.uint64))


def test_normalize_to_aabb_matches_jax(rng):
    p = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    lo = np.array([-1.0, 0.5, -2.0], np.float32)
    hi = np.array([1.0, 0.5, 2.0], np.float32)  # a degenerate axis
    assert _bits_equal(JM.normalize_to_aabb(*map(jnp.asarray, (p, lo, hi))),
                       TM.normalize_to_aabb(_t(p), _t(lo), _t(hi)).numpy())


@pytest.mark.parametrize("shape", [(1024,), (3, 1024), (5, 7)])
def test_sort_key_index_matches_jax(rng, shape):
    """Few distinct keys (many ties) and padding keys, which sort last."""
    keys = rng.integers(0, 20, shape).astype(np.uint32)
    keys[rng.uniform(size=shape) < 0.2] = 0xFFFFFFFF
    jk, jr = jax.jit(JS.sort_key_index)(jnp.asarray(keys))
    tk, tr = TS.sort_key_index(_t(keys.astype(np.int64)))
    assert _bits_equal(jk, tk.numpy()) and _bits_equal(jr, tr.numpy())
    # sorted rows; padding keys form each row's tail
    assert (tk[..., 1:] >= tk[..., :-1]).all()
    pads = (keys == 0xFFFFFFFF).sum(-1)
    n = shape[-1]
    assert np.array_equal((tk.numpy() == TS.PAD_KEY).sum(-1), pads)
    assert (tk.numpy()[..., n - pads.max():] == TS.PAD_KEY).sum() \
        >= pads.max()


def test_sort_key_val_matches_jax(rng):
    keys = rng.integers(0, 9, (4, 300)).astype(np.int32)
    vals = rng.uniform(size=(4, 300)).astype(np.float32)
    jk, jv = JS.sort_key_val(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = TS.sort_key_val(_t(keys), _t(vals))
    assert _bits_equal(jk, tk.numpy()) and _bits_equal(jv, tv.numpy())


def test_bit_length_is_exact():
    """floor(log2) by integer compares: every value up to 1024, and the
    edges of every power of two up to 2^32."""
    x = np.arange(1, 1025)
    edges = np.array([v for k in range(1, 33)
                      for v in ((1 << k) - 1, 1 << k) if v < 1 << 32])
    for v in (x, edges):
        got = TR.bit_length(_t(v)).numpy()
        assert np.array_equal(got, [int(u).bit_length() for u in v])
    assert int(TR.bit_length(torch.tensor([0]))[0]) == 0


@pytest.mark.parametrize("n", [1, 5, 64, 1000, 1024])
def test_range_minmax_matches_jax(rng, n):
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (n, 3)).astype(np.float32)
    lo[::7] = np.inf
    hi[::7] = -np.inf
    jt = JR.build_minmax_table(jnp.asarray(lo), jnp.asarray(hi))
    tt = TR.build_minmax_table(_t(lo), _t(hi))
    assert all(_bits_equal(a, b.numpy()) for a, b in zip(jt, tt))
    # every span from 1 to n, at random starts
    span = np.arange(1, n + 1)
    first = (rng.uniform(size=n) * (n - span + 1)).astype(np.int32)
    last = (first + span - 1).astype(np.int32)
    jq = JR.range_minmax(*jt, jnp.asarray(first), jnp.asarray(last))
    tq = TR.range_minmax(*tt, _t(first).long(), _t(last).long())
    assert all(_bits_equal(a, b.numpy()) for a, b in zip(jq, tq))
    # against a direct min / max
    want = np.stack([lo[f:l + 1].min(0) for f, l in zip(first, last)])
    assert _bits_equal(want, tq[0].numpy())


def test_range_minmax_batched_equals_per_batch(rng):
    lo = rng.normal(size=(3, 100, 3)).astype(np.float32)
    hi = lo + 1
    first = rng.integers(0, 50, (3, 40))
    last = first + rng.integers(0, 50, (3, 40))
    tt = TR.build_minmax_table(_t(lo), _t(hi))
    got = TR.range_minmax(*tt, _t(first), _t(last))
    for b in range(3):
        one = TR.build_minmax_table(_t(lo[b]), _t(hi[b]))
        ref = TR.range_minmax(*one, _t(first[b]), _t(last[b]))
        assert torch.equal(got[0][b], ref[0]) and torch.equal(got[1][b],
                                                              ref[1])


def test_segment_sum_matches_jax(rng):
    data = rng.normal(size=(3000, 3)).astype(np.float32)
    ids = rng.integers(0, 100, 3000).astype(np.int32)
    ref = np.asarray(JR.segment_sum(jnp.asarray(data), jnp.asarray(ids), 120))
    got = TR.segment_sum(_t(data), _t(ids), 120).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.all(got[100:] == 0)


def test_onehot_permute_matches_jax(rng):
    vals = rng.normal(size=(3, 64, 5)).astype(np.float32)
    idx = np.stack([rng.permutation(64) for _ in range(3)]).astype(np.int32)
    ref = JGA.onehot_permute(jnp.asarray(vals), jnp.asarray(idx))
    assert _bits_equal(ref, TGA.onehot_permute(_t(vals), _t(idx)).numpy())
    ints = rng.integers(-1000, 1 << 20, (2, 64, 4)).astype(np.int32)
    ref = JGA.onehot_permute(jnp.asarray(ints), jnp.asarray(idx[:2]))
    assert _bits_equal(ref, TGA.onehot_permute(_t(ints), _t(idx[:2])).numpy())


def test_box_helpers_match_jax(rng):
    v = [rng.normal(size=(50, 3)).astype(np.float32) * 30 for _ in range(3)]
    for a, b in zip(JG.triangle_aabb(*map(jnp.asarray, v)),
                    TG.triangle_aabb(*map(_t, v))):
        assert _bits_equal(a, b.numpy())
    lo, hi = v[0], v[0] + 1
    for a, b in zip(JG.aabb_union(*map(jnp.asarray, (lo, hi, v[1], v[2]))),
                    TG.aabb_union(*map(_t, (lo, hi, v[1], v[2])))):
        assert _bits_equal(a, b.numpy())
    assert _bits_equal(JG.aabb_center(lo, hi), TG.aabb_center(
        _t(lo), _t(hi)).numpy())
    for a, b in zip(JG.aabb_empty((4,)), TG.aabb_empty((4,))):
        assert _bits_equal(a, b.numpy())


def test_entry_packing_matches_jax(rng):
    idx = rng.integers(0, 1024, 500)
    batch = rng.integers(0, 1024, 500)
    blas = rng.uniform(size=500) < 0.5
    leaf = rng.uniform(size=500) < 0.5
    ref = np.asarray(JT.pack_entry(jnp.asarray(idx), jnp.asarray(batch),
                                   jnp.asarray(blas), jnp.asarray(leaf)))
    got = TT.pack_entry(_t(idx), _t(batch), _t(blas), _t(leaf))
    assert _bits_equal(ref, got.numpy())
    for jf, tf in ((JT.entry_idx, TT.entry_idx),
                   (JT.entry_batch, TT.entry_batch),
                   (JT.entry_is_blas, TT.entry_is_blas),
                   (JT.entry_is_leaf, TT.entry_is_leaf)):
        assert _bits_equal(jf(jnp.asarray(ref)), tf(got).numpy())
    assert (TT.GROUP, TT.GROUPS_PER_BATCH, TT.BLAS_NODES) == (
        JT.GROUP, JT.GROUPS_PER_BATCH, JT.BLAS_NODES)


# ---------------------------------------------------------------------------
# bvh/build.py
# ---------------------------------------------------------------------------


def _codes(rng, n, distinct):
    c = np.sort(rng.integers(0, distinct, n)).astype(np.uint32)
    c[rng.uniform(size=n) < 0.1] = 0xFFFFFFFF  # padding, sorted last
    return np.sort(c)


@pytest.mark.parametrize("n", [2, 3, 64, 1024])
def test_lbvh_topology_matches_jax(rng, n):
    """Duplicate codes (few distinct values), padding codes, and all codes
    equal."""
    for codes in (_codes(rng, n, 8), _codes(rng, n, 1 << 30),
                  np.zeros(n, np.uint32)):
        ref = jax.jit(JB.lbvh_topology)(jnp.asarray(codes))
        got = TB.lbvh_topology(_t(codes.astype(np.int64)))
        for a, b in zip(ref, got):
            assert _bits_equal(a, b.numpy())


def test_lbvh_topology_batched_equals_alone(rng):
    codes = np.stack([_codes(rng, 64, d) for d in (4, 100, 1 << 30)])
    got = TB.lbvh_topology(_t(codes.astype(np.int64)))
    for b in range(3):
        one = TB.lbvh_topology(_t(codes[b].astype(np.int64)))
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))


def _soup(seed, num, batches, empty_batch=False, point=False):
    """A padded triangle soup: `num` valid triangles over `batches` batches
    of 1024 (valid slots first; with empty_batch the last batch holds
    none; with point every vertex is one point)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (num, 3)).astype(np.float32)
    c[:, 1] = 0.5 * np.sin(c[:, 0]) * np.cos(c[:, 2])
    e1 = rng.uniform(-0.5, 0.5, (num, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (num, 3)).astype(np.float32)
    if point:
        c[:] = [0.25, 0.5, -0.75]
        e1[:] = 0.0
        e2[:] = 0.0
    total = batches * 1024
    cap = total - (1024 if empty_batch else 0)
    assert num <= cap
    valid = np.zeros(total, bool)
    valid[:num] = True
    pad = lambda a: np.concatenate([a, rng.normal(size=(total - num, 3))
                                    .astype(np.float32)]).reshape(
        batches, 1024, 3)
    return pad(c), pad(c + e1), pad(c + e2), valid.reshape(batches, 1024)


def _both_builds(v0, v1, v2, valid):
    jb = jax.jit(JB.build_scene_bvh)(*map(jnp.asarray, (v0, v1, v2, valid)))
    tb = TB.build_scene_bvh(*map(_t, (v0, v1, v2, valid)))
    return jb, tb


@pytest.mark.parametrize("case", ["demo", "soup", "soup_empty_batch"])
def test_build_scene_bvh_matches_jax(case):
    if case == "demo":
        host = jdemo()
        pad = jpadded(host)
        v = host.vertices[pad["indices"]]
        b = host.num_batches
        args = [v[:, k].reshape(b, 1024, 3) for k in range(3)] \
            + [pad["valid"]]
    else:
        args = _soup(7, 1500, 2) if case == "soup" else \
            _soup(8, 2000, 3, empty_batch=True)
    jb, tb = _both_builds(*args)
    for f in BVH_FIELDS:
        assert _bits_equal(getattr(jb, f), getattr(tb, f).numpy()), f
    assert tb.tlas_internal == jb.tlas_internal == args[0].shape[0] - 1
    assert tb.num_batches == jb.num_batches


def test_build_scene_tables_matches_jax():
    """The frame's build: the tree, the sorted vertex normals and the sorted
    materials of the demo scene."""
    host = jdemo()
    pad = jpadded(host)
    ref = jax.jit(JF.build_scene_tables, static_argnums=0)(
        host.num_batches, jnp.asarray(pad["indices"]),
        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
        jnp.asarray(host.vertices), jnp.asarray(host.normals))
    th = build_demo_scene()
    tpad = padded_arrays(th)
    got = TF.build_scene_tables(
        th.num_batches, _t(tpad["indices"]), _t(tpad["tri_mat"]),
        _t(tpad["valid"]), _t(th.vertices), _t(th.normals))
    for f in BVH_FIELDS:
        assert _bits_equal(getattr(ref[0], f), getattr(got[0], f).numpy()), f
    assert _bits_equal(ref[1], got[1].numpy())
    assert _bits_equal(ref[2], got[2].numpy())
    assert got[2].dtype == torch.int32


# ---------------------------------------------------------------------------
# binary tables and their plain traversal
# ---------------------------------------------------------------------------


def _rays(rng, n):
    """Three quarters steep down-looking rays from above the soup, a quarter
    random rays."""
    org = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    k = 3 * n // 4
    org[:k, 1] = 4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:k, 1] = -np.abs(d[:k, 1]) - 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


@pytest.fixture(scope="module")
def soup():
    v0, v1, v2, valid = _soup(11, 1800, 2)
    jb, tb = _both_builds(v0, v1, v2, valid)
    tables = P.pack_tables_binary(tb, torch.zeros(9, 2048),
                                  torch.zeros(2048, dtype=torch.int32))
    return jb, tb, tables


def _brute(tables, org, d, t_max):
    """Closest accepted Moller-Trumbore hit over every slot (the first slot
    on ties), in float32 like the traversal."""
    o, dd = _t(org), _t(d)
    n, p = o.shape[0], tables.tris.shape[0]
    ok, t, _, _ = P._tri_test(tables.tris.repeat(n, 1),
                              o.repeat_interleave(p, 0),
                              dd.repeat_interleave(p, 0),
                              _t(t_max).repeat_interleave(p, 0))
    t = torch.where(ok, t, torch.full_like(t, np.inf)).reshape(n, p)
    best, tri = t.min(dim=1)
    return best, torch.where(torch.isfinite(best), tri, -1)


def test_binary_tables_layout(soup):
    jb, tb, tables = soup
    assert tables.arity == 2 and tables.leaf_width == 1
    assert tables.tlas_internal == 1
    assert tables.nodes.shape == (1 + 2 * 1023, 16)
    assert torch.equal(tables.nodes[:, :12], tb.boxes_t.T)
    assert torch.equal(tables.nodes[:, 12:14].long(), tb.children_t.T.long())
    assert torch.all(tables.nodes[:, 14:] == 0)
    assert (tables.levels, tables.stack) == (32 + 10 + 32 + 1, 256)
    moved = tables.to("cpu")
    assert moved.tlas_internal == 1 and moved.stack == 256
    # the layout check the kernels' wrappers run: a wrong TLAS row count
    # is refused before anything launches
    bad = copy.copy(tables)
    bad.tlas_internal = 2
    with pytest.raises(ValueError, match="two-level LBVH"):
        P._check_tables(bad, "cpu")
    P._check_tables(tables, "cpu")


def test_binary_plain_matches_brute_force(soup):
    tables = soup[2]
    rng = np.random.default_rng(5)
    org, d = _rays(rng, 1024)
    t_max = np.where(rng.uniform(size=1024) < 0.2, 1.5,
                     np.inf).astype(np.float32)
    ovf = P.overflow_counter("cpu")
    hit = P.packet_intersect(tables, _t(org), _t(d), _t(t_max), overflow=ovf)
    bt, btri = _brute(tables, org, d, t_max)
    assert int(ovf) == 0
    assert (hit.tri >= 0).float().mean() > 0.2
    same = hit.tri.long() == btri
    assert same.float().mean() >= 0.999
    assert torch.equal(hit.t[same], bt[same])
    # any-hit: the occlusion flag of every ray
    anyh = P.packet_intersect(tables, _t(org), _t(d), _t(t_max),
                              any_hit=True)
    assert torch.equal(anyh.tri >= 0, btri >= 0)


def test_binary_plain_matches_jax_traversers(soup):
    """JAX's wavefront traverser and its packet kernel at arity 2 (Pallas
    interpret mode, one 4096-ray tile) on the JAX-built tree, which equals
    the port's (test_build_scene_bvh_matches_jax)."""
    jb, tb, tables = soup
    org, d = _rays(np.random.default_rng(6), 4096)
    hit = P.packet_intersect_plain(tables, _t(org), _t(d))
    wf = jax.jit(lambda o, dd: intersect_scene(jb, o, dd, max_steps=8192))(
        jnp.asarray(org), jnp.asarray(d))
    same = np.asarray(wf.tri) == hit.tri.numpy()
    assert same.mean() >= 0.995 and (hit.tri >= 0).float().mean() > 0.3
    np.testing.assert_allclose(np.asarray(wf.t)[same], hit.t.numpy()[same],
                               rtol=1e-5, atol=5e-6)
    ph = packet_intersect(jax.jit(pack_for_packets)(jb), jnp.asarray(org),
                          jnp.asarray(d), tlas_internal=jb.tlas_internal,
                          interpret=True)
    pt, gt = np.asarray(ph.t), hit.t.numpy()
    assert (np.isfinite(pt) == np.isfinite(gt)).mean() >= 0.999
    m = np.isfinite(pt) & np.isfinite(gt)
    np.testing.assert_allclose(pt[m], gt[m], rtol=1e-4, atol=1e-4)


def test_binary_overflow_is_counted_not_silent(soup):
    tables = copy.copy(soup[2])
    tables.stack = 1
    org, d = _rays(np.random.default_rng(9), 512)
    ovf = P.overflow_counter("cpu")
    P.packet_intersect(tables, _t(org), _t(d), overflow=ovf)
    assert int(ovf) > 0


@pytest.mark.parametrize("batches,bound", [(2, 75), (36, 80), (1024, 84)])
def test_binary_stack_bound(batches, bound, monkeypatch):
    """32 clz values + bit_length(n - 1) tiebreak values per level of the
    two-level tree; every bound takes the 256-entry stack, and tables whose
    bound no instantiation holds are refused."""
    assert P.binary_stack_bound(batches) == bound
    assert P.binary_stack_depth(bound) == 256
    monkeypatch.setattr(P, "STACK_DEPTHS", (32, 64))
    with pytest.raises(ValueError, match=f"{bound}-entry"):
        P.binary_stack_depth(bound)


def _internal_depth(children, tlas_internal):
    """The most internal nodes on a path from the TLAS root, by a walk of
    the packed child entries."""
    kids = children.T.long().numpy()
    depth, front = 0, [0]
    while front:
        depth += 1
        nxt = []
        for e in kids[front].reshape(-1):
            if e < 0 or e & TT._LEAF_BIT:
                continue
            if e & TT._BLAS_BIT:
                nxt.append(tlas_internal + ((e >> 11) & 0x7FF) * 1023
                           + (e & 0x7FF))
            else:
                nxt.append(e & (TT._BLAS_BIT - 1))
        front = nxt
    return depth


def test_adversarial_soup_stays_within_the_stack_bound():
    """Every triangle at one point: all morton codes are equal, so the
    BLAS splits by the index tiebreak alone.  The tree's depth and the
    deepest stack of rays through that point stay within the bound, with
    no push dropped; the build still equals JAX's."""
    v0, v1, v2, valid = _soup(12, 2048, 2, point=True)
    # a tiny triangle at the point, so that rays can hit it
    v1[valid] += np.float32([1e-3, 0, 0])
    v2[valid] += np.float32([0, 0, 1e-3])
    jb, tb = _both_builds(v0, v1, v2, valid)
    for f in BVH_FIELDS:
        assert _bits_equal(getattr(jb, f), getattr(tb, f).numpy()), f
    tables = P.pack_tables_binary(tb, torch.zeros(9, 2048),
                                  torch.zeros(2048, dtype=torch.int32))
    assert _internal_depth(tb.children_t, 1) <= tables.levels
    n = 256
    rng = np.random.default_rng(13)
    tgt = np.float32([0.25, 0.5, -0.75]) + rng.uniform(
        0, 5e-4, (n, 3)).astype(np.float32) * [1, 0, 1]
    org = (tgt + np.float32([0.1, 2.0, -0.2])).astype(np.float32)
    d = (tgt - org) / np.linalg.norm(tgt - org, axis=1, keepdims=True)
    ovf, depth = P.overflow_counter("cpu"), P.overflow_counter("cpu")
    t, tri, _, _ = P.traverse_plain(
        tables, _t(org), _t(d.astype(np.float32)), torch.full((n,), np.inf),
        torch.zeros(n, dtype=torch.bool), ovf, depth=depth)
    assert (tri >= 0).float().mean() > 0.9
    assert int(ovf) == 0 and 0 < int(depth) <= tables.levels


# ---------------------------------------------------------------------------
# K2's plain version on binary tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bn", [False, True])
def test_plain_megakernel_on_lbvh_matches_simulator(use_bn):
    mw, mh, frame = 64, 32, 3
    host = jdemo()
    pad = jpadded(host)
    jbvh, jnrm, jmat = jax.jit(JF.build_scene_tables, static_argnums=0)(
        host.num_batches, jnp.asarray(pad["indices"]),
        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
        jnp.asarray(host.vertices), jnp.asarray(host.normals))
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    jscene = JSceneData(bvh=jbvh, tri_nrm_t=jnrm, tri_mat=jmat,
                        materials=host.materials, sky=sky, textures=None,
                        lights=host.lights)
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    basis = camera_basis(cam)
    pix = jnp.arange(mw * mh, dtype=jnp.int32)
    bn = jnp.asarray(blue_offsets_flat(mw, mh, mw * mh)) if use_bn else None
    if use_bn:
        jit_, lens = (rand2_bn(bn, jnp.uint32(frame), jnp.uint32(d))
                      for d in (0, 256))
    else:
        jit_, lens = (rand2(pix, jnp.uint32(frame), jnp.uint32(d))
                      for d in (0, 256))
    rays = generate_rays_padded(basis, mw, mh, pix, jit_, lens)
    out = jax.jit(lambda: JMK.simulate_megakernel(
        jscene, rays, pix, jnp.uint32(frame), max_steps=4096, bn=bn))()
    ref = JMK.finish_gbuffer(jscene, rays, out, basis, mw / mh)

    th = build_demo_scene()
    tpad = padded_arrays(th)
    tables = P.pack_tables_binary(*TF.build_scene_tables(
        th.num_batches, _t(tpad["indices"]), _t(tpad["tri_mat"]),
        _t(tpad["valid"]), _t(th.vertices), _t(th.normals)))
    scene = SceneData(tables=tables,
                      materials=interop.materials_from_jax(host.materials,
                                                           "cpu"),
                      lights=interop.lights_from_jax(host.lights, "cpu"),
                      sky=interop.sky_from_jax(sky, "cpu"))
    trays = Rays(*(_t(x) for x in rays))
    ovf = P.overflow_counter("cpu")
    got = TMK.path_trace_mega(
        scene, trays, torch.arange(mw * mh), frame,
        tbasis(interop.camera_from_jax(cam, "cpu")), mw / mh,
        bn=None if bn is None else _t(bn), overflow=ovf)
    assert int(ovf) == 0
    _gbuffers_close(ref, got)
    # the wrapper's CPU route is the plain version, bit for bit
    plain = TMK.megakernel_trace_plain(
        tables, pack_materials_rows(scene.materials),
        TMK.pack_light_rows(scene.lights, "cpu"),
        TMK.pack_sun_params(scene.sky), frame, trays.org, trays.dir,
        trays.cone_width, torch.arange(mw * mh, dtype=torch.int32),
        n_lights=1, bn=None if bn is None else _t(bn))
    assert torch.equal(TMK.finish_gbuffer(scene.sky, trays, plain, tbasis(
        interop.camera_from_jax(cam, "cpu")), mw / mh).color, got.color)
