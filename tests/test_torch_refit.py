"""Per-frame BVH4 refit (bvh/refit.py) and the in-place table refresh
(bvh/packet.py::refresh_tables): the port against the JAX package's
rtrt_tpu/bvh/refit.py on the same inputs, and the refitted tables against
brute force.

Tolerances: `plan_refit4` must equal JAX's array for array; `leaf_bounds`,
`refit_nodes4` and the frame's `DeviceRefit` are min / max and index
arithmetic, so fed the same displaced table they must equal JAX's
refit_nodes4 bit for bit on all 32 lanes.  Refit at the rest pose must
reproduce the SAH build's records exactly on occupied lanes (empty slots:
the collapse writes +-1e30, refit +-inf).  After displacement the plain
traversal over the refitted tables must return brute force's slot on
>= 99.9% of rays (ties between distinct triangles at one t) with t bitwise
equal where the slots agree.  Rays that meet only inverted (+-inf) empty
slots hit nothing, with no NaN and no dropped push."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtrt_tpu.bvh import refit as JR
from rtrt_tpu.engine import frame as JF
from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh import refit as TR
from rtrt_tpu_torch.bvh.sah import (build_scene_bvh_sah,
                                    build_scene_tables_sah, bvh4_nodes)
from rtrt_tpu_torch.bvh.types import BATCH_SIZE
from rtrt_tpu_torch.engine import frame as TF
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from torch_refit_cases import brute_hits, inverted_slot_case, rays

torch.set_num_threads(1)
TIMES = (0.0, 1.7, 16.666584)  # the last: the float32 clock at frame 1000


def _soup(n=500, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    pad = BATCH_SIZE - n
    z = np.zeros((pad, 3), np.float32)
    st = lambda a: np.concatenate([a, z]).reshape(1, BATCH_SIZE, 3)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    bvh = build_scene_bvh_sah(st(c), st(c + e1), st(c + e2),
                              valid.reshape(1, BATCH_SIZE), leaf_max=8)
    nrm = torch.zeros((9, bvh.tris_t.shape[1]))
    nrm[1::3] = 1.0  # +y vertex normals
    mat = torch.zeros(bvh.tris_t.shape[1], dtype=torch.int32)
    return bvh, nrm, mat


def _demo():
    host = build_demo_scene()
    pad = padded_arrays(host)
    return build_scene_tables_sah(host.num_batches, pad["indices"],
                                  pad["tri_mat"], pad["valid"], host.vertices,
                                  host.normals, leaf_max=8)


@pytest.fixture(scope="module", params=["soup", "demo"])
def scene(request):
    bvh, nrm, mat = _soup() if request.param == "soup" else _demo()
    raw = bvh4_nodes(bvh)
    return dict(bvh=bvh, nrm=nrm, mat=mat, raw=raw,
                plan=TR.plan_refit4(raw), jplan=JR.plan_refit4(raw, 8))


def test_plan_matches_jax(scene):
    p, j = scene["plan"], scene["jplan"]
    assert (p.q, p.n_leaves, TR.LEAF_WIDTH) == (j.q, j.n_leaves, j.leaf_width)
    assert len(p.levels) == len(j.levels) > 1
    for a, b in zip(p.levels, j.levels):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(p.entries_f32, j.entries_f32)


@pytest.mark.parametrize("t", TIMES)
def test_leaf_bounds_and_refit_bit_equal_jax(scene, t):
    """The same displaced table (JAX's) into both packages' refits."""
    p, j = scene["plan"], scene["jplan"]
    tt = np.asarray(JF.displace_wave_rows(
        jnp.asarray(scene["bvh"].tris_t.numpy()), jnp.float32(t)))
    jlo, jhi = JR.leaf_bounds(jnp.asarray(tt), j.n_leaves, j.leaf_width)
    ref = np.asarray(JR.refit_nodes4(j, jlo, jhi))
    lo, hi = TR.leaf_bounds(torch.from_numpy(tt.copy()), p.n_leaves)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(TR.refit_nodes4(p, lo, hi).numpy(), ref)
    nodes = torch.from_numpy(scene["raw"].copy())
    TR.DeviceRefit(p, "cpu").refit(nodes, torch.from_numpy(tt.copy()))
    np.testing.assert_array_equal(nodes.numpy(), ref)


def test_refit_rest_pose_reproduces_sah_records(scene):
    raw = scene["raw"]
    nodes = torch.from_numpy(raw.copy())
    TR.DeviceRefit(scene["plan"], "cpu").refit(nodes, scene["bvh"].tris_t)
    out = nodes.numpy()
    occupied = np.repeat(raw[:, 24:28] >= 0, 6, axis=1)
    np.testing.assert_array_equal(out[:, :24][occupied], raw[:, :24][occupied])
    empty = ~occupied
    lo_lane = np.tile(np.arange(6) < 3, 4)[None, :].repeat(raw.shape[0], 0)
    assert (out[:, :24][empty & lo_lane] == np.inf).all()
    assert (out[:, :24][empty & ~lo_lane] == -np.inf).all()
    np.testing.assert_array_equal(out[:, 24:], raw[:, 24:])


def test_displaced_refit_traversal_matches_brute_force(scene):
    bvh, plan = scene["bvh"], scene["plan"]
    tables = P.pack_tables(bvh, scene["nrm"], scene["mat"], scene["raw"])
    levels, stack = tables.levels, tables.stack
    tt = TF.displace_wave_rows(bvh.tris_t, 1.7)
    TR.DeviceRefit(plan, "cpu").refit(tables.nodes, tt)
    P.refresh_tables(tables, tt, scene["nrm"])
    assert (tables.levels, tables.stack) == (levels, stack)
    org, d = rays(2048, 3, [0.0, 1.0, -2.0], 9.0)
    ovf = P.overflow_counter("cpu")
    hit = P.packet_intersect_plain(tables, org, d, overflow=ovf)
    bt, btri = brute_hits(tables, org, d)
    assert int(ovf) == 0
    assert (btri >= 0).float().mean() > 0.1  # the rays do hit things
    same = hit.tri.long() == btri
    assert same.float().mean() >= 0.999, same.float().mean()
    assert torch.equal(hit.t[same], bt[same])


def test_refresh_matches_pack_tables(scene):
    """refresh_tables writes what pack_tables builds from the same rows, into
    the same storage."""
    bvh, nrm = scene["bvh"], scene["nrm"]
    tables = P.pack_tables(bvh, nrm, scene["mat"], scene["raw"])
    ptrs = [getattr(tables, f).data_ptr() for f in ("tris", "nrm", "ng")]
    tt = TF.displace_wave_rows(bvh.tris_t, 16.666584)
    nt = TF.wave_normal_rows(nrm, bvh.tris_t, 16.666584)
    P.refresh_tables(tables, tt, nt)
    ref = P.pack_tables(dataclasses.replace(bvh, tris_t=tt), nt,
                        scene["mat"], scene["raw"])
    for f, ptr in zip(("tris", "nrm", "ng"), ptrs):
        assert torch.equal(getattr(tables, f), getattr(ref, f)), f
        assert getattr(tables, f).data_ptr() == ptr


def test_inverted_empty_slots_hit_nothing():
    tables, org, d = inverted_slot_case()
    ovf = P.overflow_counter("cpu")
    hit = P.packet_intersect_plain(tables, org, d, overflow=ovf)
    bt, btri = brute_hits(tables, org, d)
    assert int(ovf) == 0
    assert not torch.isnan(hit.t).any()
    assert torch.equal(hit.tri.long().clamp(max=0), btri.clamp(max=0))
    assert (hit.tri[-128:] >= 0).all()          # the leaf is still hit
    h = hit.tri >= 0
    assert torch.equal(hit.t[h], bt[h])
    # the slab test alone: an inverted box is missed by every ray, with a
    # +inf (never NaN) entry distance
    inv = torch.stack([P._safe_inv(d[:, k]) for k in range(3)], dim=1)
    lo = torch.full_like(org, np.inf)
    ok, tn = P._slab(lo, -lo, org, inv, torch.full((org.shape[0],), np.inf))
    assert not ok.any() and (tn == np.inf).all()
