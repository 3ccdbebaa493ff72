"""Scene + static SAH/BVH4 tables: the port's host build == the JAX
package's, BITWISE (same content generator, same native/numpy builders,
same leaf collapse and 4-wide collapse), on the demo scene and a
terrain_chunks=1 terrain.  The numpy fallbacks are pinned separately, since
the native library would otherwise hide them, and every table test runs
twice: with each package's native library (the port builds its own from
its copy of rtrt_native.cpp) and with both libraries disabled, so that
both sides take their numpy twins.  The GPU tables (TraceTables) built by
the port and converted from the JAX build are equal too."""

import dataclasses

import numpy as np
import pytest
import torch

from rtrt_tpu.bvh import sah as JS
from rtrt_tpu.bvh.packet import pack_for_packets
from rtrt_tpu.content import native as jnative
from rtrt_tpu.engine import scene as JSC
from rtrt_tpu.utils.config import GlobalSettings as JGlobalSettings
from rtrt_tpu_torch.bvh import sah as TS
from rtrt_tpu_torch.bvh.packet import pack_tables
from rtrt_tpu_torch.content import native as tnative
from rtrt_tpu_torch.engine import scene as TSC
from rtrt_tpu_torch.utils import interop
from rtrt_tpu_torch.utils.config import GlobalSettings as TGlobalSettings

torch.set_num_threads(1)


def _build(which):
    if which == "demo":
        return JSC.build_demo_scene(), TSC.build_demo_scene()
    return (JSC.build_terrain_scene(JGlobalSettings(terrain_chunks=1)),
            TSC.build_terrain_scene(TGlobalSettings(terrain_chunks=1)))


def test_port_builds_its_own_native_library():
    assert tnative.available()
    assert str(tnative.BUILD_DIR) in tnative._LIB._name


@pytest.fixture(scope="module", params=[
    ("demo", "native"), ("terrain1", "native"), ("demo", "numpy"),
    ("terrain1", "numpy")], ids="-".join)
def scenes(request):
    which, path = request.param
    saved = [(m, m._LIB, m._TRIED) for m in (jnative, tnative)]
    if path == "numpy":
        for m in (jnative, tnative):
            m._LIB, m._TRIED = None, True
    else:
        assert jnative.available() and tnative.available()
    try:
        jh, th = _build(which)
        jp, tp = JSC.padded_arrays(jh), TSC.padded_arrays(th)
        jt = JS.build_scene_tables_sah(jh.num_batches, jp["indices"],
                                       jp["tri_mat"], jp["valid"],
                                       jh.vertices, jh.normals, leaf_max=8)
        tt = TS.build_scene_tables_sah(th.num_batches, tp["indices"],
                                       tp["tri_mat"], tp["valid"],
                                       th.vertices, th.normals, leaf_max=8)
        j4, t4 = JS.bvh4_nodes(jt[0]), TS.bvh4_nodes(tt[0])
    finally:
        for m, lib, tried in saved:
            m._LIB, m._TRIED = lib, tried
    return dict(jh=jh, th=th, jp=jp, tp=tp, jt=jt, tt=tt, j4=j4, t4=t4)


def test_host_scene_and_padding_equal(scenes):
    jh, th = scenes["jh"], scenes["th"]
    for f in ("vertices", "indices", "normals", "tri_mat"):
        np.testing.assert_array_equal(getattr(jh, f), getattr(th, f))
    assert jh.num_batches == th.num_batches
    for k in ("indices", "tri_mat", "valid"):
        np.testing.assert_array_equal(scenes["jp"][k], scenes["tp"][k])


def test_materials_and_lights_equal(scenes):
    jm, tm = scenes["jh"].materials, scenes["th"].materials
    for f in dataclasses.fields(tm):
        np.testing.assert_array_equal(np.asarray(getattr(jm, f.name)),
                                      getattr(tm, f.name).numpy())
    jl, tl = scenes["jh"].lights, scenes["th"].lights
    assert (jl is None) == (tl is None)
    if tl is not None:
        for f in ("center", "radius", "emission"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, f)),
                                          getattr(tl, f).numpy())


def test_sah_tables_bitwise(scenes):
    (jb, jn, jm), (tb, tn, tm) = scenes["jt"], scenes["tt"]
    for f in ("boxes_t", "children_t", "tris_t", "sorted_tri_index",
              "root_lo", "root_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def test_bvh4_nodes_bitwise(scenes):
    np.testing.assert_array_equal(scenes["j4"], scenes["t4"])


def test_trace_tables_port_build_equals_jax_build(scenes):
    """interop (the JAX build carried over) == the port's own build, and
    the triangle rows / geometric normals agree with the JAX packet
    kernel's packed [v0|e1|e2] rows and attribute records."""
    jb, jn, jm = scenes["jt"]
    tb, tn, tm = scenes["tt"]
    mine = pack_tables(tb, tn, tm, scenes["t4"])
    carried = interop.trace_tables_from_jax(jb, jn, jm, scenes["j4"],
                                             "cpu")
    for f in dataclasses.fields(mine):
        assert torch.equal(getattr(mine, f.name), getattr(carried, f.name)), \
            f.name
    pk = pack_for_packets(jb, jn, jm)
    p = mine.tris.shape[0]
    rows = np.asarray(pk.tris_f32).reshape(-1, 16)[:p]
    np.testing.assert_array_equal(rows[:, :9], mine.tris.numpy())
    attr = np.asarray(pk.attr_f32).reshape(-1, 16)[:p]
    np.testing.assert_array_equal(attr[:, :9], mine.nrm.numpy())
    np.testing.assert_array_equal(attr[:, 12].astype(np.int32),
                                  mine.mat.numpy())
    # rsqrt may round differently between XLA and torch: 2 ulp
    np.testing.assert_allclose(attr[:, 9:12], mine.ng.numpy(), rtol=2.5e-7,
                               atol=1e-30)


def test_numpy_fallbacks_bitwise():
    """_sah_fallback, _collapse_leaves and _collapse4_np == the JAX twins."""
    rng = np.random.default_rng(7)
    n = 300
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    soup = np.concatenate(
        [c, c + rng.normal(size=(n, 3)).astype(np.float32),
         c + rng.normal(size=(n, 3)).astype(np.float32)], axis=1)
    jb, jc, jo = JS._sah_fallback(soup)
    tb, tc, to = TS._sah_fallback(soup)
    for a, b in ((jb, tb), (jc, tc), (jo, to)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JS._collapse_leaves(jb, jc, 8),
                    TS._collapse_leaves(tb, tc, 8)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JS._collapse4_np(jb, jc),
                                  TS._collapse4_np(tb, tc))
