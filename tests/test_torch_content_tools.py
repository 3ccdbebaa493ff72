"""The port's content modules and offline tools against the JAX package's
(numpy inputs from a seed; everything here is host code but the tools'
device paths, run on the CPU):

  * content/mesher.py::voxels_to_mesh: the same vertex and index arrays,
    in the same order (the order feeds the BVH build), as JAX's;
  * content/halfedge.py::HalfedgeMesh: the cases of the JAX package's own
    tests (tests/test_engine_utils.py: construction, linear / Loop /
    Catmull-Clark subdivision, split, flip, collapse, the open quad), one
    parametrised test: the same edits on both classes, their invariants
    and to_triangles() equal;
  * tools/bluenoise_gen.py: its torch void_and_cluster on CPU tensors at
    size 16 equal to the root tool's at the same seed; main writes the
    masks of SEEDS, and only to --out;
  * tools/mesh_baker.py: its torch morton sort equal to the root tool's
    numpy sort; an OBJ of the block mesher's output baked with one Loop
    subdivision through a temporary directory, the cache read back, and
    equal to the root tool's bake of the same file;
  * tools/sky_compare.py against the root tool's numbers (the physical
    sky's luminance holds rtol 3e-4, tests/test_torch_sky.py, so the
    ratios hold 1e-3) and tools/sky_preview.py writing its PNGs;
  * every new tool, asked for the card (the default) on a host without
    one, raises before it writes anything (a non-zero exit)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from rtrt_tpu.content.halfedge import HalfedgeMesh as JMesh
from rtrt_tpu.content.mesher import voxels_to_mesh as jvoxels
from rtrt_tpu_torch.content.halfedge import HalfedgeMesh as TMesh
from rtrt_tpu_torch.content.mesher import voxels_to_mesh as tvoxels
from rtrt_tpu_torch.content.meshio import load_mesh, save_obj
from rtrt_tpu_torch.tools import (bluenoise_gen, fps_demo, mesh_baker,
                                  profile_frame, sky_compare, sky_preview)
from rtrt_tpu_torch.utils.image import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    """A module of the root tools/ directory (not a package), by path."""
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,p,seed", [((1, 1, 1), 1.0, 0),
                                          ((2, 1, 1), 1.0, 0),
                                          ((6, 5, 4), 0.5, 3),
                                          ((9, 7, 8), 0.3, 4)])
def test_voxels_to_mesh_matches_jax(shape, p, seed):
    solid = np.random.default_rng(seed).uniform(size=shape) < p
    jv, jf = jvoxels(solid, origin=(1.0, -2.0, 0.5), scale=0.25)
    tv, tf = tvoxels(solid, origin=(1.0, -2.0, 0.5), scale=0.25)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def _tet():
    verts = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    return verts, faces


def _quad():
    qv = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    qf = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return qv, qf


def _diag(m):
    return next(e for e in range(m.num_edges())
                if set(m.edge_vertices(e)) == {0, 2})


# case -> (mesh, edits on a mesh returning what they return, a check of the
# edited mesh and the edits' results) after tests/test_engine_utils.py
HALFEDGE = {
    "construct": (_tet, lambda m: None, lambda m, r: (
        m.num_vertices(), m.num_faces(), m.num_edges()) == (4, 4, 6)),
    "subdivide_linear": (_tet, lambda m: m.subdivide("linear"),
                         lambda m, r: m.num_faces() == 16),
    "subdivide_loop": (_tet, lambda m: m.subdivide("loop"), lambda m, r: (
        m.num_faces() == 16 and np.linalg.norm(
            m.to_triangles()[0], axis=-1).max() < np.sqrt(3))),
    "split_edge": (_tet, lambda m: m.split_edge(0),
                   lambda m, r: m.num_faces() == 6),
    "flip_tet_refused": (_tet, lambda m: m.flip_edge(0),
                         lambda m, r: r is False),
    "flip_quad": (_quad, lambda m: m.flip_edge(_diag(m)), lambda m, r: (
        r and {tuple(sorted(t)) for t in m.to_triangles()[1].tolist()}
        == {(0, 1, 3), (1, 2, 3)})),
    "collapse_edge": (_tet, lambda m: m.collapse_edge(0),
                      lambda m, r: m.num_faces() <= 2),
    "catmull_clark": (_tet, lambda m: m.subdivide("catmull_clark"),
                      lambda m, r: (m.num_faces(), m.num_vertices())
                      == (24, 14) and np.abs(
                          m.to_triangles()[0].mean(0)).max() < 1e-5),
    "catmull_clark_open_quad": (
        _quad, lambda m: m.subdivide("catmull_clark"), lambda m, r: (
            np.abs(m.to_triangles()[0][:, 2]).max() == 0.0)),
    "split_then_loop": (_tet, lambda m: (m.split_edge(2),
                                         m.subdivide("loop")),
                        lambda m, r: m.num_faces() == 24),
}


@pytest.mark.parametrize("case", sorted(HALFEDGE))
def test_halfedge_matches_jax(case):
    make, edit, check = HALFEDGE[case]
    jm, tm = JMesh.from_triangles(*make()), TMesh.from_triangles(*make())
    jr, tr = edit(jm), edit(tm)
    assert jr == tr
    assert tm.validate() and jm.validate()
    assert check(tm, tr) and check(jm, jr)
    jv, jf = jm.to_triangles()
    tv, tf = tm.to_triangles()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("seed", [11, 23])
def test_bluenoise_matches_root_tool(seed):
    ref = _root_tool("bluenoise_gen").void_and_cluster(16, seed=seed)
    got = bluenoise_gen.void_and_cluster(16, seed=seed, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert sorted(np.round(got.reshape(-1) * 256 - 0.5).astype(int)) \
        == list(range(256))  # a rank mask: every rank once


def test_bluenoise_main_writes_out(tmp_path):
    out = tmp_path / "bn.npy"
    assert bluenoise_gen.main(["--out", str(out), "--size", "16",
                               "--device", "cpu"]) == 0
    m = np.load(out)
    assert m.shape == (16, 16, 2) and m.dtype == np.float32
    for c, seed in enumerate(bluenoise_gen.SEEDS):
        np.testing.assert_array_equal(
            m[..., c], bluenoise_gen.void_and_cluster(16, seed=seed,
                                                      device="cpu"))
    assert os.listdir(tmp_path) == ["bn.npy"]


def test_morton_sort_matches_root_tool():
    rng = np.random.default_rng(8)
    v = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(3)]
    ref = _root_tool("mesh_baker").morton_sort_numpy(*v)
    got = mesh_baker.morton_sort(*v, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_mesh_baker_round_trip(tmp_path, monkeypatch):
    solid = np.random.default_rng(5).uniform(size=(4, 3, 4)) < 0.6
    v, f = tvoxels(solid)
    obj = tmp_path / "blocks.obj"
    save_obj(str(obj), v, f)
    out = tmp_path / "blocks.npz"
    assert mesh_baker.main([str(obj), str(out), "--subdivide", "1",
                            "--device", "cpu"]) == 0
    bv, bf = load_mesh(str(out))
    assert len(bf) == 4 * len(f)  # one Loop level: 4 triangles each
    assert bf.min() >= 0 and bf.max() < len(bv)
    assert np.isfinite(bv).all()
    # the root tool's bake of the same file
    ref = tmp_path / "ref.npz"
    monkeypatch.setattr(sys, "argv", ["mesh_baker.py", str(obj), str(ref),
                                      "--subdivide", "1"])
    _root_tool("mesh_baker").main()
    rv, rf = load_mesh(str(ref))
    np.testing.assert_array_equal(bv, rv)
    np.testing.assert_array_equal(bf, rf)


def test_sky_compare_matches_root_tool():
    root = _root_tool("sky_compare")
    for elev in (0.35, 0.7):
        ref = root.compare(elev, 2.5, 400, verbose=False)
        got = sky_compare.compare(elev, 2.5, 400, verbose=False,
                                  device="cpu")
        np.testing.assert_allclose(np.array(got[:2]), np.array(ref[:2]),
                                   rtol=1e-3)
        np.testing.assert_allclose(np.array(got[2:]), np.array(ref[2:]),
                                   rtol=1e-3)


def test_sky_preview_writes_pngs(tmp_path):
    assert sky_preview.main([str(tmp_path), "--sweep", "2",
                             "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["sky_map.png", "sky_pdf.png", "sun_map.png",
                     "sweep.png"]
    sky = read_png(str(tmp_path / "sky_map.png"))
    sweep = read_png(str(tmp_path / "sweep.png"))
    assert sweep.shape[0] == 2 * sky.shape[0] and sky.mean() > 20


@pytest.mark.parametrize("tool,argv", [
    (profile_frame, []), (fps_demo, []), (sky_compare, []),
    (sky_preview, ["{tmp}/sky"]), (mesh_baker, ["{tmp}/a.obj", "{tmp}/b.npz"]),
    (bluenoise_gen, ["--out", "{tmp}/bn.npy"])],
    ids=lambda x: getattr(x, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tool_needs_the_card(tool, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([a.format(tmp=tmp_path) for a in argv])
    assert os.listdir(tmp_path) == []
