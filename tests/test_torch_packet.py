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
plain version on the card in test_torch_kernels_gpu.py."""

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
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays

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


def test_overflow_is_counted_not_silent(setup, monkeypatch):
    """With a 1-deep stack the far children cannot all be pushed: every
    dropped push must land in the counter."""
    monkeypatch.setattr(P, "STACK", 1)
    ovf = P.overflow_counter("cpu")
    P.packet_intersect(setup["tables"], torch.from_numpy(setup["org"]),
                       torch.from_numpy(setup["dir"]), overflow=ovf)
    assert int(ovf) > 0
