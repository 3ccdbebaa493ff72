"""The flat binary SAH tree with 8-slot leaf rows (bvh="sah2", the JAX
Engine's RTRT_SAH=2): its tables and the plain traversal that K1 / K2's
binary leaf-row instantiation is held to.

  * the port's tables equal JAX's tree carried across by
    interop.sah2_tables_from_jax (the same host build: every table bit
    for bit), with no TLAS rows, leaf width 8, and the levels of an
    independent recursive walk; the stack is the smallest of STACK_DEPTHS
    that holds one entry a level; a wrong layout is refused;
  * the plain traversal against JAX's wavefront traverser
    (intersect_scene, leaf_width=8) on the same tree and rays, at the
    bounds of tests/test_torch_packet.py: slots equal on >= 99.5% of rays
    (JAX's watertight test may resolve a shared-edge ray to the
    neighbour), t within rtol 1e-5 + atol 5e-6 where they agree; the
    same hits as the BVH4 over the same leaf rows (>= 99.9%: only exact
    ties between distinct triangles may differ) and any-hit flags equal;
  * the chain scene (engine/scene.py::build_chain_scene), 27 binary
    levels: no dropped push, the deepest stack within the levels, and the
    hits of the BVH4 traversal.
The frame over these tables is held to JAX's in tests/test_torch_frame.py
and the Engine in tests/test_torch_engine_optin.py."""

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
from rtrt_tpu_torch.engine.scene import (build_chain_scene, build_demo_scene,
                                         chain_scene_rays, padded_arrays)
from rtrt_tpu_torch.utils import interop

torch.set_num_threads(1)
N = 2048


def _tables(host):
    pad = padded_arrays(host)
    built = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    return (P.pack_tables_sah2(*built),
            P.pack_tables(*built, bvh4_nodes(built[0])))


@pytest.fixture(scope="module")
def demo():
    jhost = JSC.build_demo_scene()
    jpad = JSC.padded_arrays(jhost)
    jb = jbuild(jhost.num_batches, jpad["indices"], jpad["tri_mat"],
                jpad["valid"], jhost.vertices, jhost.normals, leaf_max=8)
    sah2, bvh4 = _tables(build_demo_scene())
    rng = np.random.default_rng(31)
    org = np.concatenate([
        rng.uniform(-6, 6, (N // 2, 3)) + [0, 3, -9],
        rng.uniform(-4, 4, (N // 2, 3)) + [0, 1.5, 0]],
        axis=0).astype(np.float32)
    d = (rng.uniform(-4, 4, (N, 3)) + [0, 1, 0] - org).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=N) < 0.2,
                     rng.uniform(0.5, 8, N), np.inf).astype(np.float32)
    return dict(jb=jb, sah2=sah2, bvh4=bvh4, org=org, dir=d, t_max=t_max)


def _levels(children, e=0):
    """Internal levels below entry e of a flat binary tree, recursively."""
    kids = [int(c) for c in children[:, e] if not int(c) & (1 << 23)]
    return 1 + max((_levels(children, c) for c in kids), default=0)


def test_sah2_tables_match_jax(demo):
    tables = demo["sah2"]
    carried = interop.sah2_tables_from_jax(*demo["jb"], device="cpu")
    for f in ("nodes", "tris", "nrm", "ng", "mat"):
        assert torch.equal(getattr(tables, f), getattr(carried, f)), f
    children = np.array(demo["jb"][0].children_t)
    assert torch.equal(tables.nodes[:, 12:14].long(),
                       torch.from_numpy(children.T).long())
    assert (tables.kind, tables.arity, tables.leaf_width,
            tables.tlas_internal) == ("sah2", 2, 8, 0)
    assert tables.levels == carried.levels == _levels(children)
    assert tables.stack == P.binary_stack_depth(tables.levels) == 32
    moved = tables.to("cpu")
    assert (moved.kind, moved.levels, moved.stack) == ("sah2",
                                                      tables.levels, 32)
    assert [a.value for a in P.layout_args(tables)] == [2, 8, 0, 32]
    assert P.kernel_name("megakernel_trace", tables) == \
        "megakernel_trace_sah2"
    P._check_tables(tables, "cpu")
    bad = copy.copy(tables)
    bad.tlas_internal = 1
    with pytest.raises(ValueError, match="flat SAH tree"):
        P._check_tables(bad, "cpu")
    with pytest.raises(ValueError, match="binary tree may need"):
        P.binary_stack_depth(257)


def test_sah2_plain_matches_jax_traverser(demo):
    o, d, tm = (torch.from_numpy(demo[k]) for k in ("org", "dir", "t_max"))
    ovf = P.overflow_counter("cpu")
    hit = P.packet_intersect(demo["sah2"], o, d, tm, overflow=ovf)
    assert int(ovf) == 0 and (hit.tri >= 0).float().mean() > 0.3
    ref = jax.jit(lambda o, dd, tm: intersect_scene(
        demo["jb"][0], o, dd, tm, leaf_width=8, max_steps=4096))(
        jnp.asarray(demo["org"]), jnp.asarray(demo["dir"]),
        jnp.asarray(demo["t_max"]))
    rt = torch.from_numpy(np.array(ref.t))
    same = hit.tri.long() == torch.from_numpy(np.array(ref.tri)).long()
    assert same.float().mean() >= 0.995
    fin = same & torch.isfinite(rt)
    torch.testing.assert_close(hit.t[fin], rt[fin], rtol=1e-5, atol=5e-6)
    four = P.packet_intersect(demo["bvh4"], o, d, tm)
    assert (hit.tri == four.tri).float().mean() >= 0.999
    anyh = P.packet_intersect(demo["sah2"], o, d, tm, any_hit=True)
    assert torch.equal(anyh.tri >= 0, hit.tri >= 0)


def test_sah2_chain_scene_stack():
    sah2, bvh4 = _tables(build_chain_scene())
    assert sah2.levels == 27 and sah2.stack == 32
    org, d = (torch.from_numpy(x) for x in chain_scene_rays(1024))
    n = org.shape[0]
    inf = torch.full((n,), np.inf)
    ovf, depth = P.overflow_counter("cpu"), P.overflow_counter("cpu")
    t, tri, _, _ = P.traverse_plain(sah2, org, d, inf,
                                    torch.zeros(n, dtype=torch.bool), ovf,
                                    depth=depth)
    assert int(ovf) == 0 and 20 < int(depth) <= sah2.levels
    four = P.packet_intersect(bvh4, org, d)
    assert torch.equal(tri.to(torch.int32), four.tri)
    assert torch.equal(t, four.t)
